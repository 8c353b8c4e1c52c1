"""Serving: a frozen model + supports + scaler bundle, streaming forecasts,
a deployment artifact, and request batching.

Counterpart of ``graph_wavenet_tpu/train/serving.py``:

- :class:`Forecaster` (``predict``, ``from_checkpoint`` with dense, no or
  block-sparse supports, ``from_city_checkpoint`` and the node layout
  gathers): the model and the supports live on the forecaster's device,
  and a prediction is one forward under ``torch.inference_mode``;
- :func:`rolling_forecast` and :func:`autoregressive_forecast`, the
  reference's ``lax.scan`` loops: on the card one forward is captured as a
  CUDA graph (``train.step_graph``) and replayed per window or round, its
  input selected on the device and its output written into a row of the
  result; on the CPU the eager loop of the same forward;
- :func:`reconstruct_sequence`: overlapping rolling forecasts averaged back
  to one sequence;
- :func:`export_forecaster` / :func:`load_exported_forecaster`: a
  ``torch.export`` artifact (``.pt2``) of the predict forward with the
  weights and supports baked in; it names the hand kernels' ops, so a
  loader needs ``ops.cuda.block_diffusion`` and no model code;
- :class:`DiffGForecaster`: the per-sample-graph model, predicting from
  per-sample supports or from a bound graph bank
  (:func:`save_graph_bank`/:func:`load_graph_bank`, the reference
  package's ``.npz`` format) by graph index, the fine signal or the pooled
  F/E modalities; :func:`export_diffg_forecaster` writes its artifact,
  called as ``(x, adj_idx)`` with the bank baked in;
- :class:`MicroBatcher`: dynamic request batching, to power-of-two buckets
  or to an artifact's fixed batch; a request may be a tuple of arrays
  (diff-G's ``(x, adj_idx)``), batched component by component. Each call
  and request leaves spans in ``train.profiling``'s store.
"""

from __future__ import annotations

import concurrent.futures
import json
import queue
import threading
import time
import zipfile
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import ModelConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.train import profiling, step_graph


@dataclass(eq=False)
class Forecaster:
    """Inference bundle around a trained shared-graph model.

    ``supports``: dense (N, N) tensors or block-sparse supports on the
    model's device (a :class:`ops.adaptive_block.BlockAdaptiveMask` among
    them under a city ``addaptadj``), ``[]`` for the adaptive-only model,
    or None for the temporal-only one. ``node_layout`` (city checkpoints):
    when set, :meth:`predict` speaks original node ids; inputs are permuted
    and padded into model node order on the device and predictions mapped
    back.

    The rolling and autoregressive forecasts keep their CUDA graphs on the
    forecaster, one per kind: a call with other inputs (by identity), window
    or round count replaces the graph of its kind.
    """

    cfg: ModelConfig
    model: torch.nn.Module
    supports: list | None
    scaler: StandardScaler = field(
        default_factory=lambda: StandardScaler(0.0, 1.0))
    node_layout: dict | None = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: str, supports,
                        device: torch.device | str = "cuda") -> "Forecaster":
        """Model, config and scaler from a port checkpoint
        (:mod:`train.checkpoint`). ``supports``: dense (N, N) arrays or
        tensors (put on the forecaster's device, as the test CLI does),
        block-sparse supports already there, ``[]`` (aptonly) or None
        (temporal-only)."""
        from graph_wavenet_tpu_torch.models.gwnet import GWNet
        from graph_wavenet_tpu_torch.train import checkpoint as ckpt

        device = resolve_device(device)
        meta = ckpt.load_metadata(path)
        model = GWNet(meta["model_cfg"], device=device)
        model.load_state_dict(ckpt.load_state_dict(path, device=device))
        if supports is not None:
            supports = [torch.as_tensor(s, device=device)
                        if isinstance(s, (np.ndarray, torch.Tensor)) else s
                        for s in supports]
        return cls(meta["model_cfg"], model, supports,
                   meta.get("scaler") or StandardScaler(0.0, 1.0))

    @classmethod
    def from_city_checkpoint(cls, path: str, graph_npz: str,
                             device: torch.device | str = "cuda"
                             ) -> "Forecaster":
        """City-scale checkpoint: verifies the sidecar's graph fingerprint
        against ``graph_npz``, rebuilds the block-sparse supports under the
        persisted node permutation in the dtype they trained in (and the
        adaptive mask, widened by the layout's ``adaptive_hops``, when the
        model learned one; the mask alone for a model trained aptonly,
        ``n_supports`` 0, which the reference asks ``aptonly=True`` for),
        and returns a Forecaster that predicts in original node order."""
        from graph_wavenet_tpu_torch.graphs import city
        from graph_wavenet_tpu_torch.train import checkpoint as ckpt

        device = resolve_device(device)
        meta = ckpt.load_metadata(path)
        layout = (meta.get("extra") or {}).get("graph_layout")
        if layout is None:
            raise ValueError(
                f"{path} has no graph_layout sidecar record; it was not "
                "trained on a city graph, use from_checkpoint")
        supports = city.supports_from_layout(graph_npz, layout,
                                             meta["model_cfg"], device=device)
        fc = cls.from_checkpoint(path, supports, device=device)
        fc.node_layout = layout
        return fc

    @property
    def input_nodes(self) -> int:
        """Node count :meth:`predict` expects (original ids under a city
        layout, the model's padded count otherwise)."""
        if self.node_layout is not None:
            return self.node_layout["n_raw"]
        return self.cfg.num_nodes

    def _layout_maps(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather indices of the node-layout round trip, on the device:
        model position j reads input row src_idx[j] (a zero pad row for pad
        positions); output row r is model position perm[r]."""
        if "_maps" not in self.__dict__:
            layout = self.node_layout
            perm = np.asarray(layout["perm"], np.int64)
            n_raw, n_pad = layout["n_raw"], layout["n_pad"]
            src_idx = np.full(n_pad, n_raw, np.int64)
            src_idx[perm[:n_raw]] = np.arange(n_raw)
            self.__dict__["_maps"] = (
                torch.as_tensor(src_idx, device=self.device),
                torch.as_tensor(perm[:n_raw], device=self.device))
        return self.__dict__["_maps"]

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The predict forward on a (B, K, N, F) fp32 tensor on the device:
        what :meth:`predict` runs, the forecasts replay and the artifact
        holds."""
        if self.node_layout is not None:
            src_idx, out_idx = self._layout_maps()
            xz = torch.cat([x, torch.zeros_like(x[:, :, :1])], dim=2)
            x = xz.index_select(2, src_idx)
        out = self.model(x, self.supports)
        pred = out[:, -1].permute(0, 2, 1)          # (B, H, N)
        if self.node_layout is not None:
            pred = pred.index_select(2, out_idx)
        return pred * self.scaler.std + self.scaler.mean

    def predict(self, x) -> torch.Tensor:
        """x: (B, K, N, F) standardized features (array or tensor) ->
        (B, H, N) fp32 forecasts in raw units on the forecaster's device.
        N = :attr:`input_nodes`, original node order under a city layout."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self._forward(x)

    def _graph_slot(self, kind: str, key: tuple) -> dict:
        """The graph cache of one kind of forecast for ``run_steps``: it
        holds at most one graph, and a call with another ``key`` starts an
        empty one (the old graph, its pool and its inputs are freed)."""
        graphs = self.__dict__.setdefault("_graphs", {})
        slot = graphs.get(kind)
        if slot is None or key not in slot:
            slot = graphs[kind] = {}
        return slot

    def _steps(self, slot: dict, key: tuple, body, idx: torch.Tensor,
               keep: tuple) -> torch.Tensor:
        """``body`` over the rows of ``idx`` (S, 1): on the card a replayed
        CUDA graph of one step, on the CPU the eager loop. Returns the
        outputs stacked."""
        def step(sel):
            with torch.inference_mode():
                return body(sel)

        if self.device.type != "cuda":
            return torch.stack([step(sel) for sel in idx])
        stream = self.__dict__.get("_stream")
        if stream is None:
            stream = self.__dict__["_stream"] = torch.cuda.Stream(self.device)
        return step_graph.run_steps(slot, key, step, idx, stream, keep=keep)

    def step_graphs(self) -> list:
        """The captured forecasts (:class:`train.step_graph.StepGraph`), for
        their per-replay launch counts."""
        return [g for slot in self.__dict__.get("_graphs", {}).values()
                for g in slot.values()]


# ---------------------------------------------------------------------------
# the per-sample-graph (diff-G) model
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class DiffGForecaster:
    """Inference bundle of the diff-G family: per-sample supports in, the
    fine signal or the pooled F/E modalities out (the reference's diff-G
    eval loop). :meth:`bind_bank` attaches a deployment's graph bank, so a
    request names its graph by index (:meth:`predict_indexed`).

    Under ``cfg.fresh_nodevec`` every forward draws its embeddings from a
    generator seeded 0, so equal inputs give equal answers (the JAX
    package draws from ``jax.random.key(0)``; the values differ)."""

    cfg: ModelConfig
    model: torch.nn.Module
    scaler: StandardScaler = field(
        default_factory=lambda: StandardScaler(0.0, 1.0))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: str, device: torch.device | str = "cuda"
                        ) -> "DiffGForecaster":
        """Model, config and scaler of a diff-G port checkpoint."""
        from graph_wavenet_tpu_torch.models.gwnet_diff_g import GWNetDiffG
        from graph_wavenet_tpu_torch.train import checkpoint as ckpt

        device = resolve_device(device)
        meta = ckpt.load_metadata(path)
        model = GWNetDiffG(meta["model_cfg"], device=device)
        model.load_state_dict(ckpt.load_state_dict(path, device=device))
        return cls(meta["model_cfg"], model,
                   meta.get("scaler") or StandardScaler(0.0, 1.0))

    def _fresh_nodevecs(self, batch: int):
        """Under ``fresh_nodevec``: the embeddings a generator seeded 0
        draws for ``batch`` samples, as the model would draw them (what the
        engine's eval draws), made once per batch size."""
        cache = self.__dict__.setdefault("_fresh", {})
        if batch not in cache:
            gen = torch.Generator(device=self.device).manual_seed(0)
            n, r = self.cfg.num_nodes, self.cfg.adapt_rank
            with torch.inference_mode(False):
                cache[batch] = (
                    torch.randn((batch, n, r), generator=gen,
                                device=self.device),
                    torch.randn((batch, r, n), generator=gen,
                                device=self.device))
        return cache[batch]

    def _forward(self, x: torch.Tensor, supports) -> torch.Tensor:
        """(B, 1, N, K) raw-unit output of the model on device tensors."""
        nv = None
        if self.cfg.fresh_nodevec and supports is not None:
            nv = self._fresh_nodevecs(x.shape[0])
        out = self.model(x, supports, aptinit_nodevecs=nv)
        return out * self.scaler.std + self.scaler.mean

    @staticmethod
    def _squeeze(p: torch.Tensor) -> torch.Tensor:
        return p[:, -1].permute(0, 2, 1)               # (B, K, N)

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _supports(self, supports):
        return (None if supports is None else
                [torch.as_tensor(s, dtype=torch.float32, device=self.device)
                 for s in supports])

    def predict(self, x, supports) -> torch.Tensor:
        """The fine signal: x (B, K, N, F) standardized, ``supports`` the
        per-sample (B, N, N) supports (``[]``/None as in training) ->
        (B, K, N) raw units."""
        with torch.inference_mode():
            return self._squeeze(self._forward(self._x(x),
                                               self._supports(supports)))

    def _modalities(self, x, supports, projector, F_t: int):
        from graph_wavenet_tpu_torch.train.engine import pool_E, pool_F

        out = self._forward(x, supports)
        return (self._squeeze(pool_F(out, F_t)),
                self._squeeze(pool_E(out, projector)))

    def predict_modalities(self, x, supports, projector, F_t: int):
        """The pooled modality estimates the task is supervised on:
        ``(pred_F, pred_E)``, each (B, K, N) raw units. ``projector``: the
        cluster-mean projector, shared (N, N) or per sample (B, N, N)."""
        proj = torch.as_tensor(projector, dtype=torch.float32,
                               device=self.device)
        with torch.inference_mode():
            return self._modalities(self._x(x), self._supports(supports),
                                    proj, F_t)

    # -- graph-bank serving ----------------------------------------------

    def bind_bank(self, bank: dict, adjtype: str = "doubletransition"
                  ) -> "DiffGForecaster":
        """Attach a graph bank (:func:`load_graph_bank`): every graph's
        adjacency normalized into the model's supports (``mod_adj``) and
        stacked on the device, and, where the bank has community labels,
        their cluster-mean projectors for the pooled modalities."""
        from graph_wavenet_tpu_torch.graphs.normalize import mod_adj
        from graph_wavenet_tpu_torch.train.engine import (
            cluster_mean_projector,
        )

        W = np.asarray(bank["W"], np.float32)
        per_graph = [mod_adj(w, adjtype) for w in W]
        n_sup = len(per_graph[0])
        if n_sup != self.cfg.n_supports:
            raise ValueError(
                f"bank graphs normalize to {n_sup} supports under "
                f"adjtype={adjtype!r} but the checkpoint was trained "
                f"with n_supports={self.cfg.n_supports}")
        self.sup_stack = [
            torch.as_tensor(np.stack([g[j] for g in per_graph]),
                            device=self.device) for j in range(n_sup)]
        self.n_graphs = len(W)
        self.proj_stack = None
        self.F_t = int(bank["F_t"]) if bank.get("F_t") else None
        if bank.get("labels") is not None:
            labels = np.asarray(bank["labels"])
            n_comm = int(labels.max()) + 1
            self.proj_stack = torch.as_tensor(np.stack(
                [cluster_mean_projector(lab, n_comm) for lab in labels]),
                device=self.device)
        return self

    def _require_bank(self) -> None:
        if getattr(self, "sup_stack", None) is None:
            raise ValueError(
                "no graph bank bound; call bind_bank(load_graph_bank(path)) "
                "(gwt-torch-serve --graph_bank) before indexed prediction")

    def _bank_index(self, adj_idx) -> torch.Tensor:
        """``adj_idx`` (B,) as an index tensor on the device, range-checked
        on the host (an index past the bank would fault on the card)."""
        self._require_bank()
        idx = torch.as_tensor(adj_idx)
        if idx.numel() and (int(idx.min()) < 0
                            or int(idx.max()) >= self.n_graphs):
            raise ValueError(f"adj_idx out of range for a bank of "
                             f"{self.n_graphs} graphs")
        return idx.to(device=self.device, dtype=torch.long)

    def _predict_indexed(self, x: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
        """The indexed forward on device tensors: what the artifact
        holds."""
        sup = [s.index_select(0, idx) for s in self.sup_stack]
        return self._squeeze(self._forward(x, sup))

    def predict_indexed(self, x, adj_idx) -> torch.Tensor:
        """The fine signal against bank graph ``adj_idx[i]`` per sample:
        (B, K, N) raw units."""
        idx = self._bank_index(adj_idx)
        with torch.inference_mode():
            return self._predict_indexed(self._x(x), idx)

    def predict_modalities_indexed(self, x, adj_idx):
        """The pooled ``(pred_F, pred_E)`` against bank graphs; needs the
        bank's labels and F_t."""
        idx = self._bank_index(adj_idx)
        if self.proj_stack is None or self.F_t is None:
            raise ValueError(
                "modality prediction needs community labels and F_t in "
                "the graph bank (save_graph_bank(..., labels=, F_t=))")
        sup = [s.index_select(0, idx) for s in self.sup_stack]
        with torch.inference_mode():
            return self._modalities(self._x(x), sup,
                                    self.proj_stack.index_select(0, idx),
                                    self.F_t)


def save_graph_bank(path: str, W, labels=None, F_t: int | None = None
                    ) -> None:
    """Write a graph bank: ``W`` (G, N, N) raw adjacencies (normalized at
    bind time, so one bank serves any adjtype), optional ``labels`` (G, N)
    community labels and ``F_t``, for the pooled modalities. The reference
    package's format: either package loads the other's banks."""
    W = np.asarray(W, np.float32)
    if W.ndim != 3 or W.shape[1] != W.shape[2]:
        raise ValueError(f"W must be (G, N, N), got {W.shape}")
    arrays = dict(W=W)
    if labels is not None:
        labels = np.asarray(labels, np.int32)
        if labels.shape != W.shape[:2]:
            raise ValueError(f"labels must be (G, N) = {W.shape[:2]}, got "
                             f"{labels.shape}")
        arrays["labels"] = labels
    if F_t is not None:
        arrays["F_t"] = np.int64(F_t)
    np.savez(path, **arrays)


def load_graph_bank(path: str) -> dict:
    """``{"W", "labels" (or None), "F_t" (or None)}`` of a bank file."""
    with np.load(path) as z:
        return {"W": z["W"].astype(np.float32),
                "labels": (z["labels"].astype(np.int32)
                           if "labels" in z else None),
                "F_t": int(z["F_t"]) if "F_t" in z else None}


def _rows(n: int, device: torch.device) -> torch.Tensor:
    """(n, 1) int32 step indices 0..n-1 on the device."""
    return torch.arange(n, dtype=torch.int32, device=device)[:, None]


def rolling_forecast(forecaster: Forecaster, history,
                     window: int) -> torch.Tensor:
    """Streaming forecasts at every origin of a long history.

    history: (T_total, N, F) standardized features. Returns
    (T_total - window + 1, H, N): the H-step forecast issued at each origin,
    each equal to :meth:`Forecaster.predict` on its window. On the card
    the history stays on the device and one forward is a CUDA graph,
    replayed per origin, its window gathered through the graph's index
    buffer; a later call on the same history tensor and window replays it
    for every origin. Pass a device tensor: an array is copied anew per
    call and so captured anew."""
    fc = forecaster
    history = torch.as_tensor(history, dtype=torch.float32, device=fc.device)
    if history.ndim != 3 or not 1 <= window <= history.shape[0]:
        raise ValueError(f"history {tuple(history.shape)} must be (T, N, F) "
                         f"with T >= window = {window}")
    offsets = torch.arange(window, dtype=torch.int32, device=fc.device)

    def body(sel):
        x = history.index_select(0, sel + offsets)[None]
        return fc._forward(x)[0]

    key = ("rolling", window, id(history))
    slot = fc._graph_slot("rolling", key)
    return fc._steps(slot, key, body,
                     _rows(history.shape[0] - window + 1, fc.device),
                     keep=(history, offsets))


def autoregressive_forecast(forecaster: Forecaster, x, n_rounds: int,
                            future_aux=None) -> torch.Tensor:
    """Closed-loop rollout: forecast H steps, feed them back as the signal
    channel, repeat.

    x: (B, K, N, F) standardized features with K >= H; returns (B,
    n_rounds * H, N) raw-unit forecasts, round 1 equal to
    :meth:`Forecaster.predict` on x.

    ``future_aux`` (B, n_rounds * H, N, F - 1): the auxiliary feature
    channels of the forecast horizon (calendar features are known for the
    future). Without it the last window's aux tail is repeated, which
    matches the true calendar only when the aux pattern's period divides H.
    On the card the rolled window is a device buffer and one round is a
    CUDA graph, replayed per round, its ``future_aux`` chunk selected
    through the graph's index buffer."""
    fc = forecaster
    h = fc.cfg.out_dim
    x = torch.as_tensor(x, dtype=torch.float32, device=fc.device)
    if x.ndim != 4 or x.shape[1] < h or n_rounds < 1:
        raise ValueError(f"x {tuple(x.shape)} must be (B, K, N, F) with K "
                         f">= H = {h}, and n_rounds >= 1")
    b, _, n, f = x.shape
    aux = None
    if future_aux is not None and f > 1:
        aux = torch.as_tensor(future_aux, dtype=torch.float32,
                              device=fc.device)
        if aux.shape != (b, n_rounds * h, n, f - 1):
            raise ValueError(f"future_aux {tuple(aux.shape)} must be "
                             f"{(b, n_rounds * h, n, f - 1)}")
        # (B, rounds*H, N, F-1) -> (rounds, B, H, N, F-1): one chunk a round
        aux = aux.reshape(b, n_rounds, h, n, f - 1).transpose(0, 1)
    key = ("ar", n_rounds, id(x), None if future_aux is None
           else id(future_aux))
    slot = fc._graph_slot("ar", key)
    g = slot.get(key)
    if g is None:
        state = x.clone()
        chunks = None if aux is None else aux.contiguous()
    else:
        # the buffers the graph reads, refilled for this call
        state, chunks = g.keep[-2:]
        state.copy_(x)
        if chunks is not None:
            chunks.copy_(aux)

    def body(sel):
        pred = fc._forward(state)                        # (B, H, N)
        feats = [((pred - fc.scaler.mean) / fc.scaler.std)[..., None]]
        if f > 1:
            feats.append(state[:, -h:, :, 1:] if chunks is None
                         else chunks.index_select(0, sel)[0])
        state.copy_(torch.cat([state[:, h:], torch.cat(feats, -1)], 1))
        return pred

    preds = fc._steps(slot, key, body, _rows(n_rounds, fc.device),
                      keep=(x, future_aux, state, chunks))
    # (rounds, B, H, N) -> (B, rounds*H, N)
    return preds.transpose(0, 1).reshape(b, n_rounds * h, n)


def reconstruct_sequence(rolling) -> torch.Tensor:
    """Average overlapping rolling forecasts into one sequence.

    rolling: (n_origins, H, N) stride-1 forecasts -> (n_origins + H - 1,
    N), summing each step's forecasts in origin order as the reference's
    loop does."""
    rolling = torch.as_tensor(rolling, dtype=torch.float32)
    n_origins, h, n = rolling.shape
    total = rolling.new_zeros((n_origins + h - 1, n))
    count = rolling.new_zeros((n_origins + h - 1, 1))
    # step t gets origin i's lead t - i; the last lead first is origin order
    for lead in range(h - 1, -1, -1):
        total[lead:lead + n_origins] += rolling[:, lead]
        count[lead:lead + n_origins] += 1.0
    return total / count


# ---------------------------------------------------------------------------
# deployment artifact
# ---------------------------------------------------------------------------

_META = "gwt_torch.json"


class _PredictModule(torch.nn.Module):
    """:meth:`Forecaster.predict`'s forward as a module for
    ``torch.export``: the model is a submodule (its weights become the
    artifact's parameters and buffers); the supports, layout gathers and
    scaler, reached through the forecaster, become its constants."""

    def __init__(self, fc: Forecaster):
        super().__init__()
        self.model = fc.model
        self.fc = fc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc._forward(x)


class _IndexedModule(torch.nn.Module):
    """:meth:`DiffGForecaster.predict_indexed`'s forward for
    ``torch.export``: the bank's supports become the artifact's
    constants."""

    def __init__(self, fc: DiffGForecaster):
        super().__init__()
        self.model = fc.model
        self.fc = fc

    def forward(self, x: torch.Tensor, adj_idx: torch.Tensor
                ) -> torch.Tensor:
        return self.fc._predict_indexed(x, adj_idx)


def _save_artifact(module: torch.nn.Module, args: tuple, path: str,
                   meta: dict) -> str:
    with torch.no_grad():
        ep = torch.export.export(module.eval(), args)
    ep.example_inputs = None          # the sample batch is not stored
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta)})
    return path


def export_forecaster(forecaster: Forecaster, path: str, batch_size: int,
                      seq_len: int | None = None) -> str:
    """Write the predict forward as a ``torch.export`` artifact (``.pt2``)
    with the weights and supports baked in; it serves through
    :func:`load_exported_forecaster` without the model code, config or
    checkpoint. Its input is fixed: (batch_size, seq_len, input_nodes,
    in_dim) fp32 on the forecaster's device, which is the device the
    artifact runs on.

    seq_len: the input window baked in (default: the model's receptive
    field, the smallest window it reads in full). The loader left-pads
    shorter inputs with zeros, as the model pads its own input, so a
    default artifact serves K-step windows bit for bit."""
    fc = forecaster
    if fc.node_layout is not None:
        # built for real before the trace, or the trace would cache fakes
        fc._layout_maps()
    seq_len = seq_len or fc.cfg.receptive_field
    shape = (batch_size, seq_len, fc.input_nodes, fc.cfg.in_dim)
    x = torch.zeros(shape, dtype=torch.float32, device=fc.device)
    return _save_artifact(_PredictModule(fc), (x,), path,
                          {"in_shape": list(shape), "device": str(fc.device)})


def export_diffg_forecaster(forecaster: DiffGForecaster, path: str,
                            batch_size: int, seq_len: int | None = None
                            ) -> str:
    """Write :meth:`DiffGForecaster.predict_indexed` as a ``torch.export``
    artifact with the weights and the bound bank baked in, called as
    ``(x, adj_idx)``: (batch_size, seq_len, N, in_dim) fp32 and
    (batch_size,) int64 graph indices. ``seq_len`` defaults to the trained
    K (``cfg.out_dim``: the model forecasts its own window); shorter inputs
    are left-padded by the loader."""
    fc = forecaster
    fc._require_bank()
    cfg = fc.cfg
    if cfg.fresh_nodevec:
        # made for real before the trace, or the trace would cache fakes
        fc._fresh_nodevecs(batch_size)
    seq_len = seq_len or cfg.out_dim
    shape = (batch_size, seq_len, cfg.num_nodes, cfg.in_dim)
    x = torch.zeros(shape, dtype=torch.float32, device=fc.device)
    idx = torch.zeros(batch_size, dtype=torch.long, device=fc.device)
    return _save_artifact(_IndexedModule(fc), (x, idx), path,
                          {"in_shape": list(shape), "device": str(fc.device),
                           "n_graphs": fc.n_graphs})


def artifact_metadata(path: str) -> dict:
    """The ``in_shape`` and ``device`` an artifact of
    :func:`export_forecaster` was written with, read without loading
    it."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith("/extra/" + _META)]
        if not names:
            raise ValueError(f"{path} is not an artifact of "
                             "export_forecaster (no extra/" + _META + ")")
        return json.loads(z.read(names[0]))


class ExportedForecaster:
    """A loaded artifact (:func:`load_exported_forecaster`). ``n_graphs``:
    the bank size of a diff-G artifact, which then takes ``(x, adj_idx)``
    (``n_inputs`` 2); None for a shared-graph one."""

    def __init__(self, module: torch.nn.Module, in_shape: tuple,
                 device: torch.device, n_graphs: int | None = None):
        self._module = module
        self.in_shape = in_shape
        self.device = device
        self.n_graphs = n_graphs
        self.n_inputs = 1 if n_graphs is None else 2

    def predict(self, x, adj_idx=None) -> torch.Tensor:
        """x: (B, K, N, F) standardized features, B and N and F as baked,
        K at most the baked window (shorter windows are left-padded with
        zeros) -> (B, H, N) raw-unit forecasts on the artifact's device. A
        diff-G artifact also takes ``adj_idx`` (B,), each sample's bank
        graph, and returns (B, K, N)."""
        if (adj_idx is None) != (self.n_graphs is None):
            raise ValueError("a diff-G artifact takes (x, adj_idx), a "
                             "shared-graph one x alone")
        args = ()
        if adj_idx is not None:
            idx = torch.as_tensor(adj_idx)
            if (idx.shape != (self.in_shape[0],) or int(idx.min()) < 0
                    or int(idx.max()) >= self.n_graphs):
                raise ValueError(
                    f"adj_idx must be ({self.in_shape[0]},) graph indices "
                    f"into a bank of {self.n_graphs} graphs")
            args = (idx.to(device=self.device, dtype=torch.long),)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        b, t, n, f = self.in_shape
        if (x.ndim != 4 or (x.shape[0], x.shape[2], x.shape[3]) != (b, n, f)
                or x.shape[1] > t):
            raise ValueError(f"the artifact takes {self.in_shape} (a "
                             f"shorter window is padded), got "
                             f"{tuple(x.shape)}")
        if x.shape[1] < t:
            x = F.pad(x, (0, 0, 0, 0, t - x.shape[1], 0))
        with torch.inference_mode():
            return self._module(x, *args)


def load_exported_forecaster(path: str, device: torch.device | str | None
                             = None) -> ExportedForecaster:
    """Load an :func:`export_forecaster` or :func:`export_diffg_forecaster`
    artifact. It runs on the device
    type it was exported on; ``device`` (default: that device) of another
    type, or another card, raises. Needs the hand kernels' ops
    (``ops.cuda.block_diffusion``, imported here), not the model code.
    The loaded constants (the supports' blocks among them) sit in storage
    of their own, on the 16-byte boundaries the bf16 kernels' TMA reads
    need (the kernels refuse any other)."""
    # registers the gwt_torch ops the artifact's graph names
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion  # noqa: F401

    meta = artifact_metadata(path)
    saved = torch.device(meta["device"])
    if device is not None:
        asked = torch.device(device)
        if asked.type != saved.type or asked.index not in (None,
                                                           saved.index):
            raise ValueError(f"{path} was exported on {saved} and runs only "
                             f"there; asked for {asked}")
    resolve_device(saved)
    ep = torch.export.load(path)
    return ExportedForecaster(ep.module(), tuple(meta["in_shape"]), saved,
                              meta.get("n_graphs"))


class MicroBatcher:
    """Dynamic request batching for a batch predictor.

    Concurrent single-example ``submit(x)`` calls coalesce into one device
    call: the worker thread drains requests arriving within ``window_ms``
    of the first (up to ``max_batch``), pads the stack up to the next
    power-of-two bucket (so the device sees a few batch shapes), runs
    ``predict_fn`` once, and hands each caller its row. A tuple example
    (diff-G's ``(x, adj_idx)``) is stacked per component and
    ``predict_fn`` called with one argument each, so requests that name
    different graphs share a call. ``fixed_batch``
    pads every call to exactly that batch instead (an artifact bakes one)
    and caps a call at it. Pad rows repeat the last real example and are
    dropped. Thread-safe; use as a context manager or call :meth:`stop`.

    Spans (``train.profiling``, on the profiler's clock): a call's
    ``serve.call``, from taking its first request to handing back the last
    answer (``requests``, ``bucket``, ``request_ids``; ``error=True`` if it
    failed), and inside it ``serve.stack`` (the stack and pad rows;
    ``bytes``) and ``serve.predict`` (``predict_fn`` and the read back;
    ``bucket``); each request's ``serve.queued``, from ``submit`` to the
    worker taking it, under its call and with the request's id.
    """

    def __init__(self, predict_fn, max_batch: int = 64,
                 window_ms: float = 2.0, fixed_batch: int | None = None):
        if fixed_batch is not None:
            max_batch = fixed_batch
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._predict = predict_fn
        self.max_batch = max_batch
        self.fixed_batch = fixed_batch
        self.window_s = window_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stopped = False
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "device_calls": 0,
                      "batch_histogram": {}}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="gwt-microbatcher")
        self._worker.start()

    def _bucket(self, n: int) -> int:
        if self.fixed_batch is not None:
            return self.fixed_batch
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [(*item, profiling.now_ns())]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append((*nxt, profiling.now_ns()))
            self._flush(batch)

    def _flush(self, batch):
        """One call for ``batch``, items ``(x, future, request id, put_ns,
        taken_ns)``; records the call's spans."""
        n = len(batch)
        bucket = self._bucket(n)
        call = next(profiling.ids)

        def stack(parts):
            xs = np.stack(parts)
            if n < bucket:
                xs = np.concatenate([xs, np.repeat(xs[-1:], bucket - n,
                                                   axis=0)])
            return xs

        rows = [b[0] if isinstance(b[0], tuple) else (b[0],) for b in batch]
        error = {}
        try:
            with profiling.span("serve.stack", call, bytes=bucket * sum(
                    a.nbytes for a in rows[0])):
                args = tuple(stack(parts) for parts in zip(*rows))
            with profiling.span("serve.predict", call, bucket=bucket):
                out = self._predict(*args)
                out = (out.cpu().numpy() if isinstance(out, torch.Tensor)
                       else np.asarray(out))
        except Exception as e:              # deliver, don't kill the worker
            error = {"error": True}
            for b in batch:
                b[1].set_exception(e)
        else:
            with self._stats_lock:
                self.stats["requests"] += n
                self.stats["device_calls"] += 1
                h = self.stats["batch_histogram"]
                h[n] = h.get(n, 0) + 1
            for i, b in enumerate(batch):
                b[1].set_result(out[i])
        profiling.record("serve.call", batch[0][4], profiling.now_ns(),
                         span_id=call, requests=n, bucket=bucket,
                         request_ids=[b[2] for b in batch], **error)
        for _, _, rid, put, taken in batch:
            profiling.record("serve.queued", put, taken, call, span_id=rid)

    def submit(self, x) -> np.ndarray:
        """Enqueue one example (no batch dim; a tuple of arrays for a
        predictor of several inputs); blocks until its result."""
        if self._stopped:
            raise RuntimeError("MicroBatcher is stopped")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        x = (tuple(map(np.asarray, x)) if isinstance(x, tuple)
             else np.asarray(x))
        self._q.put((x, fut, next(profiling.ids), profiling.now_ns()))
        return fut.result()

    def stop(self):
        self._stopped = True
        self._q.put(None)
        self._worker.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
