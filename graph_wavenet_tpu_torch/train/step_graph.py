"""One train or eval step as a CUDA graph: the fused steps' counterpart of
the JAX engine's ``lax.scan`` body (``graph_wavenet_tpu/train/engine.py``,
``train_steps_resident`` and its siblings).

A :class:`StepGraph` holds one captured step, a static ``(B,)`` int32
index buffer ``sel`` that selects its batch from device-resident inputs,
and the step's static metric output. :func:`run_steps` runs S steps with
it: the first call of a graph runs step 1 eagerly on the capture stream
(PyTorch's warm-up before a capture; it also loads the hand kernels and
sets their attributes outside the capture), captures one step (a capture
executes nothing), and replays the graph for the other steps; a later
call replays it for all S. Before each replay one device-to-device copy
puts step k's row of the index matrix into ``sel`` and the caller's
``before`` hook sets what else changes per step (the learning rate);
after it, one copy puts the metrics into row k of the (S, 3) result.

Every tensor the graph reads must keep its address from the capture on:
the resident arrays, the supports, the module's parameters and buffers,
the optimizer's state and learning-rate tensor, and ``sel``. The graph
keeps references to the caller's inputs (``keep``) so that none is freed
under it. A failure of the capture or of a replay raises; nothing falls
back to eager steps.

The hand kernels' launch counters (``ops.cuda.block_diffusion.LAUNCHES``)
count Python calls, so the capture counts a step's launches once and a
replay not at all: ``launches`` is what one replay launches and
``replays`` how often it ran.
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd


class StepGraph:
    """One captured step over the batch that ``sel`` selects."""

    def __init__(self, batch: int, device: torch.device, keep: tuple):
        self.sel = torch.empty((batch,), dtype=torch.int32, device=device)
        self.keep = keep
        self.graph = torch.cuda.CUDAGraph()
        self.out: torch.Tensor | None = None
        self.launches: dict = {}
        self.replays = 0

    def capture(self, body: Callable[[torch.Tensor], torch.Tensor],
                stream: torch.cuda.Stream,
                generator: torch.Generator | None) -> None:
        """Capture ``body(sel)`` on ``stream``. ``generator``: a dropout
        stream the step draws from; a replay then draws what the next
        eager step would and advances the generator as that step does."""
        if generator is not None:
            register = getattr(self.graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this PyTorch cannot register a torch.Generator with a "
                    "CUDA graph (CUDAGraph.register_generator_state); the "
                    "fused train steps draw dropout from the engine's own "
                    "generator and need it")
            register(generator)
        before = dict(bd.LAUNCHES)
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = body(self.sel)
        self.launches = {k: bd.LAUNCHES[k] - before[k] for k in before}

    def replay(self, row: torch.Tensor) -> torch.Tensor:
        """Run the step on the batch that ``row`` (B,) selects; returns the
        static metric output, overwritten by the next replay."""
        self.sel.copy_(row)
        self.graph.replay()
        self.replays += 1
        return self.out


def run_steps(graphs: dict, key: tuple, body, idx: torch.Tensor,
              stream: torch.cuda.Stream, *, keep: tuple,
              generator: torch.Generator | None = None,
              before: Callable[[], None] | None = None,
              after: Callable[[], None] | None = None) -> torch.Tensor:
    """S steps of ``body`` over the rows of ``idx`` (S, B) int32 on the
    card: metrics (S, 3). ``graphs`` caches a :class:`StepGraph` per
    ``key``; ``before``/``after`` run around every step (the engine's
    learning rate and step count)."""
    s, b = idx.shape
    out = torch.empty((s, 3), dtype=torch.float32, device=idx.device)
    g = graphs.get(key)
    k0 = 0
    if g is None:
        g = StepGraph(b, idx.device, keep)
        if before is not None:
            before()
        # the warm-up: step 1, eager, on the stream the capture uses
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out[0].copy_(body(idx[0]))
        torch.cuda.current_stream().wait_stream(stream)
        if after is not None:
            after()
        g.capture(body, stream, generator)
        graphs[key] = g
        k0 = 1
    for k in range(k0, s):
        if before is not None:
            before()
        out[k].copy_(g.replay(idx[k]))
        if after is not None:
            after()
    return out
