"""DCRNN as an ``nn.Module``: the diffusion-convolutional GRU
encoder-decoder of Li, Yu, Shahabi and Liu (ICLR 2018, arXiv:1707.01926),
as its released code computes it (github.com/liyaguang/DCRNN,
``model/dcrnn_cell.py`` and ``model/dcrnn_model.py``).

A cell, per sample, on z (N, C) and the supports S_1..S_S:

    D(z)   = ops.diffusion's DCRNN features (x0 carried across supports)
    [r, u] = sigmoid(D([x_t, h]) W_g + b_g)          b_g initialized to 1
    c      = tanh(D([x_t, r * h]) W_c + b_c)
    h'     = u * h + (1 - u) * c

The encoder runs ``num_rnn_layers`` stacked cells over the ``seq_len``
inputs from zero states; the decoder starts from the encoder's last
states, feeds zeros (GO) first, and projects its top state to each step's
output ``y_t = h W_p + b_p``. In training with the curriculum the next
decoder input is the label with the probability the caller's ``teacher``
coins say (one coin per step for the whole batch, ``torch.where`` on the
device so that a step stays one CUDA graph), else the output just made.

Layout: activations are node-leading, ``(N, B, C)``, so that a hop is one
block-sparse launch over ``R = B * C`` columns (``ops.diffusion``'s DCRNN
functions: kernel 3 pairs on fused flat supports, dense supports as
products), and every projection is one :func:`ops.linear.project` over
the raw hops with the recurrence folded into the weight columns
(:func:`ops.diffusion.dcrnn_fold`). A cell's input is zero-padded to a
multiple of 8 channels, with zero weight columns (exact), so the
projection kernel reads every operand with 16-byte loads.

Precision: activations in ``cfg.dtype`` over ``cfg.param_dtype``
parameters; the recurrent states are carried from cell to cell in fp32
and cast once for their hops and projections (:func:`gru_update`), so the
24 updates of a step are not each rounded to the activations' dtype; the
gates and the update run in fp32.

``COUNTS``: the block-kernel launches of the last captured train step, by
op name (``train.step_graph.StepGraph.launches``, set by the engine), and
the decoder's inputs teacher-forced and fed back, counted on the device
(:meth:`DCRNN.feeds`) and copied here by :func:`read_counts`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import DCRNNConfig
from graph_wavenet_tpu_torch.ops.diffusion import (
    dcrnn_features,
    dcrnn_fold,
    dcrnn_pairs,
)
from graph_wavenet_tpu_torch.ops.linear import project

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

COUNTS: dict = {"step_launches": {}, "teacher_forced": 0, "fed_back": 0}


def padded(c: int) -> int:
    """Channels of a cell input as the model lays it out: a multiple of
    8."""
    return -(-c // 8) * 8


def gru_update(u: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """``u * h + (1 - u) * c`` in fp32: the state the next cell gets."""
    return u * h + (1.0 - u) * c


def curriculum_threshold(step: torch.Tensor, tau: float) -> torch.Tensor:
    """DCRNN's teacher-forcing probability ``tau / (tau + exp(step /
    tau))`` at global step ``step`` (a device tensor), in fp32."""
    return tau / (tau + torch.exp(step.float() / tau))


class _Projection(nn.Module):
    """``weight (F, K)``, ``bias (F,)``: Xavier-uniform weight (DCRNN's
    initializer) and a constant bias."""

    def __init__(self, k: int, f: int, bias: float, *,
                 generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        bound = math.sqrt(6.0 / (k + f))
        self.weight = nn.Parameter(
            (torch.rand((f, k), generator=generator) * 2.0 - 1.0).mul(bound)
            .to(dtype))
        self.bias = nn.Parameter(torch.full((f,), bias, dtype=dtype))


class DCGRUCell(nn.Module):
    """One diffusion-convolutional GRU cell over ``c_in`` input channels
    and ``units`` state channels; ``gate`` projects to ``[r, u]``,
    ``cand`` to the candidate."""

    def __init__(self, c_in: int, units: int, n_supports: int, order: int,
                 *, generator: torch.Generator, dtype: torch.dtype):
        super().__init__()
        self.c_in, self.units = c_in, units
        self.n_supports, self.order = n_supports, order
        k = (1 + n_supports * order) * (c_in + units)
        self.gate = _Projection(k, 2 * units, 1.0, generator=generator,
                                dtype=dtype)
        self.cand = _Projection(k, units, 0.0, generator=generator,
                                dtype=dtype)

    def _weight(self, w: torch.Tensor, fold: bool) -> torch.Tensor:
        """The projection's (F, K') weight over the operands the model
        projects: hop-major, the recurrence folded in (``fold``), the
        input's channels zero-padded to a multiple of 8."""
        f = w.shape[0]
        w = w.reshape(f, 1 + self.n_supports * self.order,
                      self.c_in + self.units)
        if fold:
            w = dcrnn_fold(w, self.n_supports)
        pad = padded(self.c_in) - self.c_in
        if pad:
            w = torch.cat([w[..., :self.c_in], w.new_zeros(
                w.shape[:2] + (pad,)), w[..., self.c_in:]], dim=-1)
        return w.reshape(f, -1)

    def gconv(self, z: torch.Tensor, lin: _Projection, supports: list,
              form: str = "folded") -> torch.Tensor:
        """DCRNN's ``_gconv`` of node-leading z (N, B, C) -> (N, B, F) in
        z's dtype. ``form``: ``"folded"`` (order 2: kernel-3 pairs, the
        recurrence in the weight) or ``"features"`` (the features as
        DCRNN concatenates them, any order)."""
        n, b, c = z.shape
        z2 = z.reshape(n, b * c)
        fold = form == "folded"
        if fold and self.order != 2:
            raise ValueError("the folded form is DCRNN's order 2")
        hops = (dcrnn_pairs(z2, supports) if fold
                else dcrnn_features(z2, supports, self.order))
        return project([h.reshape(n, b, c) for h in hops],
                       self._weight(lin.weight, fold), lin.bias)

    def forward(self, inp: torch.Tensor, h: torch.Tensor, supports: list,
                form: str = "folded") -> torch.Tensor:
        """inp (N, B, padded(c_in)) in the activations' dtype, h (N, B,
        units) fp32 -> the next state, fp32."""
        dt = inp.dtype
        ru = torch.sigmoid(self.gconv(torch.cat([inp, h.to(dt)], -1),
                                      self.gate, supports, form).float())
        r, u = ru.split(self.units, dim=-1)
        c = torch.tanh(self.gconv(torch.cat([inp, (r * h).to(dt)], -1),
                                  self.cand, supports, form).float())
        return gru_update(u, h, c)


class DCRNN(nn.Module):
    """The encoder-decoder. Parameters: ``encoder.i`` and ``decoder.i``
    (:class:`DCGRUCell`, i < ``num_rnn_layers``) and ``proj`` (units ->
    ``output_dim``). ``form``: the cells' :meth:`DCGRUCell.gconv` form,
    folded at DCRNN's order 2 (12% faster a city step than kernel-3 pairs
    and an elementwise pass, ``PERF.md``), else the features."""

    def __init__(self, cfg: DCRNNConfig, *, device: torch.device | str =
                 "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.form = ("folded" if cfg.max_diffusion_step == 2
                     else "features")
        gen = torch.Generator(device="cpu").manual_seed(seed)
        pdt = _DTYPES[cfg.param_dtype]
        u, s, k = cfg.rnn_units, cfg.n_supports, cfg.max_diffusion_step

        def cells(c_first):
            return nn.ModuleList([
                DCGRUCell(c_first if i == 0 else u, u, s, k, generator=gen,
                          dtype=pdt) for i in range(cfg.num_rnn_layers)])

        self.encoder = cells(cfg.input_dim)
        self.decoder = cells(cfg.output_dim)
        self.proj = _Projection(u, cfg.output_dim, 0.0, generator=gen,
                                dtype=pdt)
        # [teacher-forced, fed back] decoder inputs, counted on the device
        self.register_buffer("feeds", torch.zeros(2, dtype=torch.int64),
                             persistent=False)
        # parameters are drawn on the CPU from one seeded generator, so a
        # seed gives the same weights on every device
        self.to(device)
        self.eval()

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def _pad(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """``c`` channels -> padded(c), zeros, in the activations'
        dtype."""
        a = a.to(self.dtype)
        pad = padded(c) - c
        return torch.nn.functional.pad(a, (0, pad)) if pad else a

    def forward(self, x: torch.Tensor, supports: list, *,
                labels: torch.Tensor | None = None,
                teacher: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, seq_len, N, input_dim) standardized -> (B, horizon, N,
        output_dim) standardized, fp32. ``labels`` (B, horizon, N,
        output_dim) standardized and ``teacher`` (horizon - 1,) bool:
        decoder step t + 1 is fed ``labels[:, t]`` where ``teacher[t]``,
        else the output of step t (the curriculum; train mode only)."""
        cfg = self.cfg
        b, _, n, _ = x.shape
        xs = self._pad(x.permute(1, 2, 0, 3), cfg.input_dim)
        h = [x.new_zeros((n, b, cfg.rnn_units), dtype=torch.float32)
             for _ in self.encoder]
        for t in range(xs.shape[0]):
            inp = xs[t]
            for i, cell in enumerate(self.encoder):
                h[i] = cell(inp, h[i], supports, self.form)
                inp = h[i].to(self.dtype)
        forced = self.training and labels is not None and teacher is not None
        if forced:
            ls = self._pad(labels.permute(1, 2, 0, 3), cfg.output_dim)
            self.feeds.add_(torch.stack([teacher.sum(),
                                         (~teacher).sum()]).to(torch.int64))
        lin = self.proj
        inp = x.new_zeros((n, b, padded(cfg.output_dim)), dtype=self.dtype)
        outs = []
        for t in range(cfg.horizon):
            for i, cell in enumerate(self.decoder):
                h[i] = cell(inp, h[i], supports, self.form)
                inp = h[i].to(self.dtype)
            y = project([inp], lin.weight, lin.bias)        # (N, B, out)
            outs.append(y)
            if t + 1 < cfg.horizon:
                inp = self._pad(y, cfg.output_dim)
                if forced:
                    inp = torch.where(teacher[t], ls[t], inp)
        return torch.stack(outs).float().permute(2, 0, 1, 3)


def read_counts(model: DCRNN) -> dict:
    """:data:`COUNTS` with the model's device counts of decoder feeds
    copied in (one sync)."""
    forced, fed = model.feeds.tolist()
    COUNTS.update(teacher_forced=forced, fed_back=fed)
    return COUNTS
