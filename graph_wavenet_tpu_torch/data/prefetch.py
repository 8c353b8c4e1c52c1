"""Batches copied to the device ahead of the step.

Counterpart of ``graph_wavenet_tpu/data/prefetch.py``. A daemon thread
walks the loader's iterator, copies each numpy array of a batch into
pinned host memory and issues a ``non_blocking`` copy to the device on a
side stream, keeping up to ``size`` batches in a bounded queue. The
consumer's stream waits on each batch's event before it uses it, and the
tensors are marked as used by that stream (``record_stream``), so the
caching allocator does not hand their memory out early. On the CPU the
arrays become tensors on the thread. Elements that are not numpy arrays
pass through; an exception in the producer is raised again in the
consumer.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: torch.device | str = "cuda") -> Iterator:
    """Wrap a batch iterator (of arrays or tuples of them) so that its
    batches reach ``device`` up to ``size`` steps ahead of the consumer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        # the thread's current device: the caller's
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def put(a):
        if not isinstance(a, np.ndarray):
            return a
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not cuda:
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def qput(item) -> bool:
        # a bounded put that gives up once the consumer has gone (an early
        # break or an exception in the training loop), so the thread never
        # parks forever with device batches in the queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for batch in iterator:
                with (torch.cuda.stream(stream) if cuda
                      else contextlib.nullcontext()):
                    out = (tuple(put(b) for b in batch)
                           if isinstance(batch, tuple) else put(batch))
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(stream)
                if not qput((out, event)):
                    return
            qput(_SENTINEL)
        except BaseException as e:           # raised again in the consumer
            qput(e)

    t = threading.Thread(target=producer, daemon=True,
                         name="gwnet-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            out, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for a in (out if isinstance(out, tuple) else (out,)):
                    if torch.is_tensor(a) and a.is_cuda:
                        a.record_stream(current)
            yield out
    finally:
        stop.set()       # on exhaustion, on an exception, and on close()
