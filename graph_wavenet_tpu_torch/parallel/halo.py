"""Time-halo sequence parallelism for the dilated causal conv.

Counterpart of ``graph_wavenet_tpu/parallel/halo.py``. The ranks of a time
group (``Mesh.time_group``) hold equal blocks of the time axis of ``(B, T,
N, C)``; a dilated conv with kernel k needs ``dilation * (k-1)`` steps
beyond a block's edge, which one point-to-point exchange brings from the
neighbour (``parallel.collectives.shift``, differentiable: its backward
sends the halo's cotangent back to the rank that owns those steps).

- :func:`halo_exchange_right` and :func:`sharded_causal_conv` keep JAX's
  names and contract: blocks left-aligned, the halo the right neighbour's
  first steps, the last rank's wrapping around to the first rank's, so
  the last ``dilation*(k-1)`` steps of the result are garbage.
- The model (``models.gwnet``) runs its blocks right-aligned, as its
  valid convs are: a layer's output step p reads input steps up to p, so
  :func:`halo_from_left` brings the previous rank's last steps and the
  first rank receives zeros (its garbage stays finite). The valid steps of
  every layer are then the last ones of the global axis; every rank keeps
  its block's width through the stack, and :func:`valid_steps` says how
  many of its steps are valid at a layer (BatchNorm's ``t_valid``).

JAX's CLI path lets GSPMD partition the step over time; the port keeps
that step's semantics with these explicit exchanges.
"""

from __future__ import annotations

import torch

from graph_wavenet_tpu_torch.ops.temporal import causal_conv_apply
from graph_wavenet_tpu_torch.parallel import collectives


def check_halo(halo: int, width: int, time_axis: int, total: int) -> None:
    """Refuse a halo wider than a block: one exchange reaches only the
    neighbour (JAX's text)."""
    if halo > width:
        raise ValueError(
            f"time-halo SP needs the per-shard time width (T/time_axis = "
            f"{total}/{time_axis} = {width}) >= the halo "
            f"dilation*(kernel-1) = {halo}: one exchange only reaches the "
            "immediate neighbor. Use fewer time shards or a smaller "
            "dilation at this depth.")


def halo_exchange_right(x_local: torch.Tensor, halo: int,
                        mesh) -> torch.Tensor:
    """This rank's block (B, T/S_t, N, C) with the first ``halo`` steps of
    the next time rank's block appended; the last rank appends the first
    rank's (wrap-around)."""
    head = x_local[:, :halo]
    recv = collectives.shift(head, mesh.time_group, mesh.time_ranks, -1,
                             wrap=True)
    return torch.cat([x_local, recv], dim=1)


def sharded_causal_conv(x_local: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, dilation: int,
                        mesh) -> torch.Tensor:
    """The valid dilated conv of ``ops.temporal.causal_conv_apply`` on this
    rank's block of a time axis split over ``mesh.time`` ranks, left-
    aligned: the ranks' outputs, in order, are the unsharded conv's output
    followed by ``dilation*(k-1)`` garbage steps (static shapes).
    ``weight`` (out, in, 1, k) and ``bias``: a ``CausalConv``'s."""
    halo = dilation * (weight.shape[-1] - 1)
    width = x_local.shape[1]
    check_halo(halo, width, mesh.time, width * mesh.time)
    return causal_conv_apply(weight, bias,
                             halo_exchange_right(x_local, halo, mesh),
                             dilation)


def halo_from_left(x_local: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """The ``halo`` steps before this rank's block: the previous time
    rank's last ones, zeros on the first rank (differentiable)."""
    if halo == 0:
        return x_local[:, :0]
    return collectives.shift(x_local[:, x_local.shape[1] - halo:],
                             mesh.time_group, mesh.time_ranks, 1)


def padded_width(length: int, time_axis: int) -> int:
    """The time axis ``length`` left-padded to a multiple of the time
    axis."""
    return -(-length // time_axis) * time_axis


def valid_steps(t_valid: int, width: int, mesh) -> int:
    """How many of this rank's ``width`` steps lie in the last ``t_valid``
    steps of the global axis (``width`` x ``mesh.time`` steps)."""
    first = mesh.time * width - t_valid
    lo = mesh.time_index * width
    return min(width, max(0, lo + width - first))
