"""Weights from the JAX package's parameter pytrees into the port's
``state_dict``.

The inverse of the reference package's ``utils/torch_import.py``
(``import_state_dict``), kept here as the port's own copy. Takes pytrees
of numpy arrays (e.g. a JAX checkpoint read with
``flax.serialization.msgpack_restore``, where lists come back as dicts
keyed "0", "1", ...):

- dense ``w (in, out)``        -> Conv2d ``weight (out, in, 1, 1)``
- tap-major ``w (k, in, out)`` -> Conv2d ``weight (out, in, 1, k)``
- BN ``scale``/``bias`` + state ``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``

The per-sample-graph (diff-G) model has the same tree; under
``fresh_nodevec`` it has no ``nodevec1``/``nodevec2``, and neither has
the port's ``GWNetDiffG``.

:func:`load_pth` loads a reference checkpoint (a ``.pth`` holding the
reference model's raw ``state_dict``, whose names and layouts the port's
``GWNet`` keeps) into a ``GWNet``: the counterpart of JAX
``utils/torch_import.load_pth``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from graph_wavenet_tpu_torch.config import ModelConfig


def _seq(tree) -> list:
    """A pytree list, or the dict msgpack makes of one."""
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(len(tree))]
    return list(tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(p: dict, prefix: str, sd: dict) -> None:
    w = np.asarray(p["w"])
    sd[f"{prefix}.weight"] = _t(w.T[:, :, None, None])
    sd[f"{prefix}.bias"] = _t(p["b"])


def _tapped(p: dict, prefix: str, sd: dict) -> None:
    w = np.asarray(p["w"])                       # (k, in, out)
    sd[f"{prefix}.weight"] = _t(w.transpose(2, 1, 0)[:, :, None, :])
    sd[f"{prefix}.bias"] = _t(p["b"])


def params_from_jax(params: dict, model_state: dict,
                    cfg: ModelConfig) -> dict[str, Any]:
    """JAX ``(params, model_state)`` -> the port's ``GWNet`` (or
    ``GWNetDiffG``) state dict."""
    layers = _seq(params["layers"])
    bn_state = _seq(model_state["bn"])
    n_layers = cfg.blocks * cfg.layers
    if len(layers) != n_layers or len(bn_state) != n_layers:
        raise ValueError(f"pytree has {len(layers)} layers, config "
                         f"{n_layers}")
    sd: dict[str, Any] = {}
    _dense(params["start_conv"], "start_conv", sd)
    _dense(params["end1"], "end_conv_1", sd)
    _dense(params["end2"], "end_conv_2", sd)
    if "nodevec1" in params:
        sd["nodevec1"] = _t(params["nodevec1"])
        sd["nodevec2"] = _t(params["nodevec2"])
    for i, (layer, bn) in enumerate(zip(layers, bn_state)):
        _tapped(layer["filter"], f"filter_convs.{i}", sd)
        _tapped(layer["gate"], f"gate_convs.{i}", sd)
        _dense(layer["skip"], f"skip_convs.{i}", sd)
        _dense(layer["residual"], f"residual_convs.{i}", sd)
        if "gcn" in layer:
            _dense(layer["gcn"], f"gconv.{i}.mlp.mlp", sd)
        sd[f"bn.{i}.weight"] = _t(layer["bn"]["scale"])
        sd[f"bn.{i}.bias"] = _t(layer["bn"]["bias"])
        sd[f"bn.{i}.running_mean"] = _t(bn["mean"])
        sd[f"bn.{i}.running_var"] = _t(bn["var"])
        sd[f"bn.{i}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def load_pth(path: str, cfg: ModelConfig, *,
             device: torch.device | str = "cuda"):
    """A :class:`models.gwnet.GWNet` of ``cfg`` holding the weights of the
    reference ``.pth`` at ``path``, in eval mode on ``device``. Refuses a
    key set or a shape that ``cfg`` does not make (a missing
    ``num_batches_tracked``, which older checkpoints lack, counts 0)."""
    from graph_wavenet_tpu_torch import resolve_device
    from graph_wavenet_tpu_torch.models.gwnet import GWNet

    device = resolve_device(device)
    sd = {k: torch.as_tensor(v) for k, v in torch.load(
        path, map_location="cpu", weights_only=True).items()}
    model = GWNet(cfg, device="cpu")
    want = model.state_dict()
    for k in want:
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros((), dtype=torch.long)
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"{path} does not fit the config: missing "
                         f"{missing[:8]}, unexpected {extra[:8]}")
    bad = [f"{k} {tuple(sd[k].shape)} (config: {tuple(v.shape)})"
           for k, v in want.items() if sd[k].shape != v.shape]
    if bad:
        raise ValueError(f"{path} does not fit the config: {bad[:8]}")
    model.load_state_dict({k: sd[k].to(v.dtype) for k, v in want.items()})
    return model.to(device).eval()
