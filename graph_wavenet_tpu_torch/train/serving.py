"""Serving: a frozen model + supports + scaler bundle, and request batching.

Counterpart of ``graph_wavenet_tpu/train/serving.py``'s :class:`Forecaster`
(``predict``, ``from_checkpoint``, ``from_city_checkpoint`` and the node
layout gathers) and :class:`MicroBatcher`. PyTorch runs eagerly, so there
is no compile cache: the model and the supports live on the forecaster's
device, and a prediction is one forward under ``torch.inference_mode``.
Rolling and autoregressive forecasts and export wait for a later slice.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import ModelConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models.gwnet import GWNet


@dataclass(eq=False)
class Forecaster:
    """Inference bundle around a trained shared-graph model.

    ``supports``: block-sparse supports on the model's device, or None for
    the temporal-only model. ``node_layout`` (city checkpoints): when set,
    :meth:`predict` speaks original node ids; inputs are permuted and
    padded into model node order on the device and predictions mapped back.
    """

    cfg: ModelConfig
    model: GWNet
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
        (:mod:`train.checkpoint`); ``supports`` as for the constructor."""
        from graph_wavenet_tpu_torch.train import checkpoint as ckpt

        device = resolve_device(device)
        meta = ckpt.load_metadata(path)
        model = GWNet(meta["model_cfg"], device=device)
        model.load_state_dict(ckpt.load_state_dict(path, device=device))
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

    def predict(self, x) -> torch.Tensor:
        """x: (B, K, N, F) standardized features (array or tensor) ->
        (B, H, N) fp32 forecasts in raw units on the forecaster's device.
        N = :attr:`input_nodes`, original node order under a city layout."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            if self.node_layout is not None:
                src_idx, out_idx = self._layout_maps()
                xz = torch.cat([x, torch.zeros_like(x[:, :, :1])], dim=2)
                x = xz.index_select(2, src_idx)
            out = self.model(x, self.supports)
            pred = out[:, -1].permute(0, 2, 1)          # (B, H, N)
            if self.node_layout is not None:
                pred = pred.index_select(2, out_idx)
            return pred * self.scaler.std + self.scaler.mean


class MicroBatcher:
    """Dynamic request batching for a batch predictor.

    Concurrent single-example ``submit(x)`` calls coalesce into one device
    call: the worker thread drains requests arriving within ``window_ms``
    of the first (up to ``max_batch``), pads the stack up to the next
    power-of-two bucket (so the device sees a few batch shapes), runs
    ``predict_fn`` once, and hands each caller its row. Pad rows repeat the
    last real example and are dropped. Thread-safe; use as a context
    manager or call :meth:`stop`.
    """

    def __init__(self, predict_fn, max_batch: int = 64,
                 window_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._predict = predict_fn
        self.max_batch = max_batch
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
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
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
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch):
        n = len(batch)
        bucket = self._bucket(n)
        xs = np.stack([x for x, _ in batch])
        if n < bucket:
            xs = np.concatenate([xs, np.repeat(xs[-1:], bucket - n, axis=0)])
        try:
            out = self._predict(xs)
            out = (out.cpu().numpy() if isinstance(out, torch.Tensor)
                   else np.asarray(out))
        except Exception as e:              # deliver, don't kill the worker
            for _, fut in batch:
                fut.set_exception(e)
            return
        with self._stats_lock:
            self.stats["requests"] += n
            self.stats["device_calls"] += 1
            h = self.stats["batch_histogram"]
            h[n] = h.get(n, 0) + 1
        for i, (_, fut) in enumerate(batch):
            fut.set_result(out[i])

    def submit(self, x) -> np.ndarray:
        """Enqueue one example (no batch dim); blocks until its result."""
        if self._stopped:
            raise RuntimeError("MicroBatcher is stopped")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((np.asarray(x), fut))
        return fut.result()

    def stop(self):
        self._stopped = True
        self._q.put(None)
        self._worker.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
