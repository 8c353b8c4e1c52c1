"""One step as a CUDA graph: the counterpart of a ``lax.scan`` body, for
the engine's fused train and eval steps (``graph_wavenet_tpu/train/
engine.py``, ``train_steps_resident`` and its siblings) and the rolling and
autoregressive forecasts (``graph_wavenet_tpu/train/serving.py``).

A :class:`StepGraph` holds one captured step, a static int32 index buffer
``sel`` that selects its input from device-resident data (a batch of
sample rows, a window's origin, a round), and the step's static output,
of any shape. :func:`run_steps` runs S steps with it: the first call of a
graph runs step 1 eagerly on the capture stream (PyTorch's warm-up before
a capture; it also loads the hand kernels and sets their attributes
outside the capture), captures one step (a capture executes nothing), and
replays the graph for the other steps; a later call replays it for all S.
Before each replay one device-to-device copy puts step k's row of the
index matrix into ``sel`` and the caller's ``before`` hook sets what else
changes per step (the learning rate); after it, one copy puts the output
into row k of the (S, ...) result.

Every tensor the graph reads must keep its address from the capture on:
the resident data, the supports, the module's parameters and buffers,
the optimizer's state and learning-rate tensor, a carried state, and
``sel``. The graph keeps references to the caller's inputs (``keep``) so
that none is freed under it. A failure of the capture or of a replay
raises; nothing falls back to eager steps.

The hand kernels' launch counter (``ops.cuda.build.LAUNCHES``) counts
Python calls, so the capture counts a step's launches once and a replay
not at all: ``launches`` is what one replay launches of the five block
kernels (``block_diffusion.OPS``, by op name) and ``replays`` how often it
ran.

A graph that captured NCCL collectives holds a reference on the group's
communicator, and NCCL's destroy waits until every such graph is gone:
:func:`release_all` frees every live graph of the process, which a
process calls before ``destroy_process_group`` (the training CLI does).
A released graph is captured anew if its owner runs it again.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
from graph_wavenet_tpu_torch.ops.cuda import build


# every StepGraph not yet collected, for release_all
_LIVE: weakref.WeakSet = weakref.WeakSet()


def release_all() -> None:
    """Wait for the card, then free every live graph's CUDA graph
    (:meth:`StepGraph.release`)."""
    if _LIVE:
        torch.cuda.synchronize()
    for g in list(_LIVE):
        g.release()


class StepGraph:
    """One captured step over the input that ``sel`` selects."""

    def __init__(self, sel_shape: tuple, device: torch.device, keep: tuple):
        self.sel = torch.empty(sel_shape, dtype=torch.int32, device=device)
        self.keep = keep
        self.graph = torch.cuda.CUDAGraph()
        self.out: torch.Tensor | None = None
        self.launches: dict = {}
        self.replays = 0
        self.released = False
        _LIVE.add(self)

    def release(self) -> None:
        """Free the captured graph (and with it its hold on any NCCL
        communicator); :func:`run_steps` captures a released step anew."""
        self.graph.reset()
        self.out = None
        self.released = True

    def capture(self, body: Callable[[torch.Tensor], torch.Tensor],
                stream: torch.cuda.Stream,
                generator: torch.Generator | None,
                error_mode: str = "global") -> None:
        """Capture ``body(sel)`` on ``stream``. ``generator``: a dropout
        stream the step draws from; a replay then draws what the next
        eager step would and advances the generator as that step does.
        ``body`` returns one tensor, the step's output. ``error_mode``:
        ``torch.cuda.graph``'s ``capture_error_mode``; a step with NCCL
        collectives takes ``"thread_local"``, so that the process group's
        watchdog thread may query its events during the capture."""
        if generator is not None:
            register = getattr(self.graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this PyTorch cannot register a torch.Generator with a "
                    "CUDA graph (CUDAGraph.register_generator_state); the "
                    "fused train steps draw dropout from the engine's own "
                    "generator and need it")
            register(generator)
        before = {k: build.LAUNCHES[k] for k in bd.OPS}
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode=error_mode):
            self.out = body(self.sel)
        self.launches = {k: build.LAUNCHES[k] - before[k] for k in bd.OPS}

    def replay(self, row: torch.Tensor) -> torch.Tensor:
        """Run the step on the input that ``row`` selects; returns the
        static output, overwritten by the next replay."""
        self.sel.copy_(row)
        self.graph.replay()
        self.replays += 1
        return self.out


def run_steps(graphs: dict, key: tuple, body, idx: torch.Tensor,
              stream: torch.cuda.Stream, *, keep: tuple,
              generator: torch.Generator | None = None,
              before: Callable[[], None] | None = None,
              after: Callable[[], None] | None = None,
              error_mode: str = "global") -> torch.Tensor:
    """S steps of ``body`` over the rows of ``idx`` (S, ...) int32 on the
    card: the outputs stacked, (S, *output shape). ``graphs`` caches a
    :class:`StepGraph` per ``key``; ``before``/``after`` run around every
    step (the engine's learning rate and step count). The warm-up step
    runs every collective of the step eagerly on the capture stream before
    the capture, so an NCCL communicator exists by then; ``error_mode``
    goes to :meth:`StepGraph.capture`."""
    s = idx.shape[0]
    g = graphs.get(key)
    if g is None or g.released:
        g = StepGraph(tuple(idx.shape[1:]), idx.device, keep)
        if before is not None:
            before()
        # the warm-up: step 1, eager, on the stream the capture uses
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            first = body(idx[0])
        torch.cuda.current_stream().wait_stream(stream)
        if after is not None:
            after()
        out = torch.empty((s,) + tuple(first.shape), dtype=first.dtype,
                          device=first.device)
        out[0].copy_(first)
        del first
        # nothing of the warm-up may still run when the capture starts
        # (an NCCL work's event would be queried inside it)
        stream.synchronize()
        g.capture(body, stream, generator, error_mode)
        graphs[key] = g
        k0 = 1
    else:
        out = torch.empty((s,) + tuple(g.out.shape), dtype=g.out.dtype,
                          device=g.out.device)
        k0 = 0
    for k in range(k0, s):
        if before is not None:
            before()
        out[k].copy_(g.replay(idx[k]))
        if after is not None:
            after()
    return out
