"""Checkpoints: a ``torch.save`` payload plus a JSON sidecar.

Counterpart of ``graph_wavenet_tpu/train/checkpoint.py``. The payload is
``{"model": state_dict}`` plus, from the trainer, ``"optimizer"``,
``"step"`` and ``"generator"`` (the dropout generator's state). The sidecar
keeps the reference schema (``model_cfg``, ``train_cfg``, ``scaler``,
``extra.graph_layout``) under ``"format": "graph_wavenet_tpu_torch/v2"``,
and :func:`load_metadata` also reads the reference package's sidecars.
:func:`load_checkpoint` restores a trainer's whole state into an
``Engine``, :class:`AsyncCheckpointer` writes checkpoints on a thread, and
:func:`prune_checkpoints` keeps the best ones.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import asdict
from typing import Any

import torch

from graph_wavenet_tpu_torch.config import (
    DCRNNConfig,
    ModelConfig,
    TrainConfig,
    from_dict,
)
from graph_wavenet_tpu_torch.data.scaler import StandardScaler

FORMAT = "graph_wavenet_tpu_torch/v2"


def save_checkpoint(path: str, state_dict: dict,
                    model_cfg: ModelConfig | None = None,
                    train_cfg: TrainConfig | None = None,
                    scaler: StandardScaler | None = None,
                    extra: dict | None = None,
                    train_state: dict | None = None) -> None:
    """Write ``path`` (the state dict on the CPU, and ``train_state``'s
    entries, e.g. :meth:`train.engine.Engine.train_state`) and
    ``path + ".json"``. Both publish atomically, the sidecar first."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta: dict[str, Any] = {"format": FORMAT}
    if model_cfg is not None:
        meta["model_cfg"] = asdict(model_cfg)
    if train_cfg is not None:
        meta["train_cfg"] = asdict(train_cfg)
    if scaler is not None:
        meta["scaler"] = {"mean": scaler.mean, "std": scaler.std}
    if extra:
        meta["extra"] = extra
    jtmp = path + ".json.tmp"
    with open(jtmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(jtmp, path + ".json")
    tmp = path + ".tmp"
    payload = {"model": {k: v.detach().cpu()
                         for k, v in state_dict.items()},
               **(train_state or {})}
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_state_dict(path: str, device: torch.device | str = "cpu") -> dict:
    """The model's state dict of a checkpoint."""
    meta = load_metadata(path)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path} is a {meta.get('format')!r} checkpoint, not {FORMAT!r}; "
            "convert reference-package weights with "
            "convert.params_from_jax first")
    return torch.load(path, map_location=device, weights_only=True)["model"]


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        meta = json.load(f)
    if "model_cfg" in meta:
        # a DCRNN checkpoint's extra record names its model
        cls = (DCRNNConfig if meta.get("extra", {}).get("model") == "dcrnn"
               else ModelConfig)
        meta["model_cfg"] = from_dict(cls, meta["model_cfg"])
    if "train_cfg" in meta:
        meta["train_cfg"] = from_dict(TrainConfig, meta["train_cfg"])
    if "scaler" in meta:
        meta["scaler"] = StandardScaler(**meta["scaler"])
    return meta


def load_checkpoint(path: str, engine) -> dict:
    """Restore a trainer's state from ``path`` into ``engine`` (a
    ``train.engine.Engine`` of the same configuration): the module's state
    dict (BatchNorm buffers included), Adam's state, the step count and
    the dropout generator. Returns the sidecar (:func:`load_metadata`)."""
    meta = load_metadata(path)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} is a {meta.get('format')!r} checkpoint, "
                         f"not {FORMAT!r}")
    # on the CPU first: the generator's state is a CPU byte tensor
    payload = torch.load(path, map_location="cpu", weights_only=True)
    missing = [k for k in ("optimizer", "step", "generator")
               if k not in payload]
    if missing:
        raise ValueError(f"{path} holds no train state ({missing} missing); "
                         "it was saved without Engine.train_state()")
    engine.model.load_state_dict(payload["model"])
    engine.load_train_state(payload)
    return meta


def _to_cpu(obj):
    """A copy of a state (nested dicts, lists, tensors) on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Writes checkpoints on a thread, so the next epoch's compute overlaps
    serialization and disk IO.

    :meth:`save` copies the state to the CPU when the save is queued (the
    training loop may then change it) and hands the write to one worker
    thread; one write is in flight at a time (a second ``save`` waits for
    the queue's slot), which bounds the host copies at two. :meth:`wait`
    drains the queue. A write's error is raised by the next ``save`` or
    ``wait``. Both files publish atomically, as :func:`save_checkpoint`'s
    do."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: list[BaseException] = []
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                save_checkpoint(*item[0], **item[1])
            except Exception as e:      # re-raised on the caller's thread
                with self._lock:
                    self._err.append(e)
            finally:
                self._q.task_done()

    def _check(self):
        with self._lock:
            err = self._err.pop(0) if self._err else None
        if err is not None:
            raise err

    def save(self, path: str, state_dict: dict, *,
             train_state: dict | None = None, **kwargs) -> None:
        """Queue :func:`save_checkpoint` of a CPU snapshot of the state."""
        self._check()
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="gwt-torch-ckpt-writer")
            self._thread.start()
        snap = _to_cpu(dict(state_dict))
        kwargs["train_state"] = _to_cpu(train_state)
        self._q.put(((path, snap), kwargs))

    def wait(self) -> None:
        self._q.join()
        self._check()


def prune_checkpoints(keep: int, scores: dict[str, float]) -> None:
    """Keep the ``keep`` best (lowest-score) checkpoints of ``scores``
    (path -> validation loss) and delete the rest, payload and sidecar;
    ``keep < 0`` keeps all. A ranked-out path whose payload is not on disk
    yet (its asynchronous write is still queued) stays in ``scores`` for
    the next prune: the payload publishes after the sidecar, so a pair is
    complete once the payload exists, and deleting only the sidecar would
    orphan the payload the writer publishes next."""
    if keep < 0:
        return
    ranked = sorted(scores.items(), key=lambda kv: kv[1])
    for path, _ in ranked[keep:]:
        if not os.path.exists(path):
            continue
        if os.path.exists(path + ".json"):
            os.remove(path + ".json")
        os.remove(path)
        scores.pop(path, None)
