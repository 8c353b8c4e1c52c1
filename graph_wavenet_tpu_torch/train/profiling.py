"""Tracing: a ``torch.profiler`` trace of a run, and the serving front's
spans on the profiler's clock.

Counterpart of ``graph_wavenet_tpu/train/profiling.py`` (its ``trace``):

- :func:`trace`: a ``torch.profiler`` context over host and CUDA activity
  that writes a Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) into a directory; ``gwt-torch-train --profile
  DIR`` wraps a whole run in it;
- the span store: a ring of the process's last ``SPANS`` spans, each a
  dict ``{"name", "id", "parent", "thread", "start_ns", "end_ns",
  "attrs"}``. :func:`span` times a block on one thread; :func:`record`
  keeps an interval whose ends were read elsewhere (a request's wait in a
  queue: put on a client's thread, taken on the worker's);
  :func:`spans` copies the ring, oldest first; :func:`clear` empties it.
  ``ids`` numbers spans and the requests they belong to, so an id names
  one span, or the spans of one request. ``now_ns`` is the clock of
  ``torch.profiler``'s host events (Unix time in ns), to which the
  profiler aligns its CUDA device timestamps: a span compares directly
  with a traced device interval.

Spans are always recorded (a few per served call, about 1-2 us each) and
do not enter the profiler: its events are not recorded on threads other
than the one that started it, where the serving front's worker runs.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

TRACE_FILE = "trace.json"
SPANS = 2 ** 16

now_ns = time.time_ns
ids = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=SPANS)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside (host and, where a card exists, CUDA
    activity) and write ``logdir/trace.json`` on exit; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def record(name: str, start_ns: int, end_ns: int, parent: int | None = None,
           span_id: int | None = None, **attrs) -> int:
    """Keep the span ``name`` over ``[start_ns, end_ns]`` (``now_ns``
    readings), under the span ``parent``; ``span_id`` is drawn from
    ``ids`` unless given. Returns the span's id."""
    if span_id is None:
        span_id = next(ids)
    _ring.append({"name": name, "id": span_id, "parent": parent,
                  "thread": threading.current_thread().name,
                  "start_ns": start_ns, "end_ns": end_ns, "attrs": attrs})
    return span_id


@contextlib.contextmanager
def span(name: str, parent: int | None = None, **attrs):
    """Keep the span ``name`` over the block; yields its id. A block that
    raises closes its span with ``error=True``."""
    span_id, start = next(ids), now_ns()
    try:
        yield span_id
    except BaseException:
        attrs["error"] = True
        raise
    finally:
        record(name, start, now_ns(), parent, span_id, **attrs)


def spans() -> list[dict]:
    """The ring's spans in the order they were kept, oldest first (a
    copy)."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
