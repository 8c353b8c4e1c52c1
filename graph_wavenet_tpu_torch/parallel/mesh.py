"""The grid of ranks: data parallelism (DP) x node tensor parallelism x
time-halo sequence parallelism, or data x pipeline stages.

Counterpart of ``graph_wavenet_tpu/parallel/mesh.py``. JAX builds a device
mesh and lets GSPMD partition a step by the arrays' ``NamedSharding``s; the
port runs one process per rank, and a :class:`Mesh` tells each rank which
part of the work is its own:

- axis ``data`` (D ranks): rank (d, m, t) takes the rows ``[d*B/D,
  (d+1)*B/D)`` of every global batch of B rows (with ``n_micro``
  micro-batches, the d-th share of each, so that every micro-batch is the
  single-process one);
- axis ``model`` (S ranks): node-TP; rank (d, m, t) holds the nodes
  ``[m*P, min((m+1)*P, N))`` of every activation, P = ceil(N/S) (JAX's
  layout: the last ranks hold fewer where S does not divide N, and only
  their real nodes), its rows of the dense supports
  (``parallel.dense_tp``) and its shard of the flat block-sparse supports
  (``parallel.sparse_tp``);
- axis ``time`` (S_t ranks): time-halo sequence parallelism; rank (d, m,
  t) computes the t-th of S_t equal blocks of the model's padded time axis
  (``parallel.halo``), every rank of a time group given the same rows.

The global rank is ``(d * S + m) * S_t + t``, the time index innermost, as
in JAX's ``(data, model, time)`` reshape. Parameters are replicated: every
rank holds all of them and applies the same update. The axes compose: the
ranks of a time group share a node range, those of a model group a time
block.

The pipeline (``parallel.pipeline``) has a mesh of its own, JAX's (data,
pipe) grid: axis ``pipe`` (S_p ranks) holds the stages, rank ``d * S_p +
p``, the stage index innermost; ``pipe_group`` is a data row's stages and
``data_group`` a stage's data ranks (its BatchNorm statistics). It has no
model or time axis, and :func:`make_mesh` refuses to compose them.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from graph_wavenet_tpu_torch.config import MeshConfig

DATA, MODEL, TIME, PIPE = "data", "model", "time", "pipe"


@dataclass(eq=False)
class Mesh:
    """This rank's place in the grid and its process groups. A group of
    one rank is None (its collectives are the identity); ``world`` is None
    only without a process group (one process)."""

    data: int                 # ranks on the data axis (D)
    model: int                # ranks on the model axis (S)
    rank: int
    device: torch.device
    world: object = None      # every rank: BatchNorm, loss, gradients
    model_group: object = None  # the ranks of this rank's (data, time)
    model_ranks: tuple = (0,)  # global ranks of model_group, in order
    time: int = 1             # ranks on the time axis (S_t)
    time_group: object = None  # the ranks of this rank's (data, model)
    time_ranks: tuple = (0,)  # global ranks of time_group, in order
    pipe: int = 1             # pipeline stages (S_p)
    pipe_group: object = None  # the stages of this rank's data row
    pipe_ranks: tuple = (0,)  # global ranks of pipe_group, in order
    data_group: object = None  # the pipeline: this stage's data ranks
    data_ranks: tuple = (0,)  # global ranks of data_group, in order

    @property
    def data_index(self) -> int:
        return self.rank // (self.model * self.time * self.pipe)

    @property
    def pipe_index(self) -> int:
        return self.rank % self.pipe

    @property
    def model_index(self) -> int:
        return self.rank // self.time % self.model

    @property
    def time_index(self) -> int:
        return self.rank % self.time

    @property
    def holds_output(self) -> bool:
        """True on the last rank of the time group: the one whose block
        ends the time axis, where the model's output steps are."""
        return self.time_index == self.time - 1

    @property
    def world_size(self) -> int:
        return self.data * self.model * self.time * self.pipe

    @property
    def shape(self) -> dict:
        if self.pipe > 1:
            return {DATA: self.data, PIPE: self.pipe}
        return {DATA: self.data, MODEL: self.model, TIME: self.time}

    def batch_rows(self, b: int, n_micro: int = 1) -> np.ndarray:
        """This rank's rows of a global batch of ``b`` rows: the d-th share
        of each of its ``n_micro`` micro-batches. Refuses a batch that
        ``D * n_micro`` does not divide."""
        if b % (self.data * n_micro):
            raise ValueError(
                f"global batch {b} must divide by the data axis {self.data}"
                + (f" x grad_accum {n_micro}" if n_micro > 1 else ""))
        mb = b // n_micro
        share = mb // self.data
        lo = self.data_index * share
        return np.concatenate([np.arange(i * mb + lo, i * mb + lo + share)
                               for i in range(n_micro)])

    def index_share(self, idx: torch.Tensor) -> torch.Tensor:
        """This rank's columns of an (S, B) index matrix of S global
        batches (sample indices or window anchors): for every row the
        :meth:`batch_rows` of B, so a fused step selects the rows the eager
        step takes."""
        cols = torch.as_tensor(self.batch_rows(idx.shape[1]),
                               device=idx.device)
        return idx.index_select(1, cols)

    def node_block(self, n: int) -> int:
        """ceil(n / S): the nodes of every model rank but the last ones
        (the row count a node exchange pads each rank's block to)."""
        return -(-n // self.model)

    def node_counts(self, n: int) -> list[int]:
        """The real nodes of each model rank, in model order (207 over 2:
        104 and 103; over 4: 52, 52, 52 and 51). Refuses a layout that
        leaves a rank none."""
        p = self.node_block(n)
        counts = [min(p, n - m * p) for m in range(self.model)]
        if counts[-1] <= 0:
            raise ValueError(f"{n} nodes over a model axis of {self.model} "
                             f"leave a rank no node (blocks of {p})")
        return counts

    def node_range(self, n: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` nodes (:meth:`node_counts`)."""
        lo = self.model_index * self.node_block(n)
        return lo, lo + self.node_counts(n)[self.model_index]

    def shard_batch(self, a: torch.Tensor, n_micro: int = 1,
                    n_nodes: int | None = None) -> torch.Tensor:
        """This rank's rows (:meth:`batch_rows`) of a (B, T, N, F) batch,
        and its node range where axis 2 holds all ``n_nodes`` nodes and the
        model axis splits them (a loader's batch holds the range already)."""
        rows = self.batch_rows(a.shape[0], n_micro)
        if n_micro == 1:
            a = a[int(rows[0]):int(rows[-1]) + 1]
        else:
            a = a.index_select(0, torch.as_tensor(rows, device=a.device))
        if self.model > 1 and n_nodes is not None and a.shape[2] == n_nodes:
            lo, hi = self.node_range(n_nodes)
            a = a[:, :, lo:hi]
        return a.contiguous()

    def barrier(self) -> None:
        if self.world is None:
            return
        if dist.get_backend(self.world) == "nccl":
            dist.barrier(self.world, device_ids=[self.device.index])
        else:
            dist.barrier(self.world)


def make_mesh(cfg: MeshConfig | None = None,
              device: torch.device | str = "cpu",
              timeout_s: float = 600.0, pipe: int = 1,
              ranks: int | None = None) -> Mesh | None:
    """This rank's :class:`Mesh` over the initialized process group
    (``parallel.multihost.initialize``), or the one-rank mesh without one.
    The data axis takes what the model and time axes (or the ``pipe``
    stages) leave. Every rank must call it, in the same order: it creates
    the groups.

    ``ranks``: the mesh spans only the first ``ranks`` ranks of the group
    (default: all of them), which keep their global rank numbers; a rank
    outside it gets None and takes no part in the mesh's steps (weak
    scaling over 1, 2, 4 ... ranks)."""
    cfg = cfg or MeshConfig()
    device = torch.device(device)
    total = dist.get_world_size() if dist.is_initialized() else 1
    n = total if ranks is None else ranks
    if not 1 <= n <= total:
        raise ValueError(f"a mesh over {n} ranks needs 1 to {total}")
    s, st = cfg.model_axis, cfg.time_axis
    if pipe > 1 and (s > 1 or st > 1):
        raise ValueError(
            f"the pipeline's mesh is (data, pipe): a model axis of {s} and "
            f"a time axis of {st} do not compose with {pipe} stages")
    if pipe < 1 or n % pipe:
        raise ValueError(f"{n} ranks do not divide into {pipe} pipeline "
                         "stages")
    if n % (s * st):
        axis = (f"model x time axes {s} x {st}" if s > 1 and st > 1 else
                f"time axis {st}" if st > 1 else f"model axis {s}")
        raise ValueError(f"{n} ranks do not divide by the {axis}")
    d = n // (s * st * pipe)
    if not dist.is_initialized():
        return Mesh(d, s, 0, device, time=st, pipe=pipe)
    rank = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    world = (dist.group.WORLD if n == total else
             dist.new_group(list(range(n)), timeout=timeout))
    if rank >= n:
        world = None

    def groups(size: int, members) -> tuple:
        """Every rank creates every group of ``size`` ranks (collectively,
        in one order) and keeps its own: (group, its global ranks)."""
        mine, own = None, ()
        for ranks in members:
            if size == n:
                g = world
            elif size == 1:
                g = None
            else:
                g = dist.new_group(list(ranks), timeout=timeout)
            if rank in ranks:
                mine, own = g, tuple(ranks)
        return mine, own

    model_group, model_ranks = groups(s, [
        [(i * s + m) * st + t for m in range(s)]
        for i in range(d) for t in range(st)])
    time_group, time_ranks = groups(st, [
        [(i * s + m) * st + t for t in range(st)]
        for i in range(d) for m in range(s)])
    pipe_groups = data_groups = (None, ())
    if pipe > 1:
        pipe_groups = groups(pipe, [
            [i * pipe + p for p in range(pipe)] for i in range(d)])
        data_groups = groups(d, [
            [i * pipe + p for i in range(d)] for p in range(pipe)])
    if rank >= n:
        return None
    mesh = Mesh(d, s, rank, device, world=world, model_group=model_group,
                model_ranks=model_ranks, time=st, time_group=time_group,
                time_ranks=time_ranks, pipe=pipe)
    if pipe > 1:
        mesh.pipe_group, mesh.pipe_ranks = pipe_groups
        mesh.data_group, mesh.data_ranks = data_groups
    return mesh
