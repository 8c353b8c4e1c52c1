"""Sparse diffusion supports in the padded max-degree neighbour (ELL) form.

Counterpart of ``graph_wavenet_tpu/ops/sparse.py``. A support is a table of
static width D per node::

    idx (N, D) int32  source node of each incoming edge (padding: the
                      row's own index)
    w   (N, D)        edge weight (padding: 0)

``out[n] = sum_d w[n, d] * x[idx[n, d]]``, which is ``nconv`` with a dense
support A whose column n holds row n's weights. The backward is a gather as
well: a transpose table (``idx_t``, ``perm_t``, built once) gives
``dx = A^T-mix(g)`` with the transpose weights taken from the current
``w``, and ``dw[n, d] = <x[idx[n, d]], g[n]>`` is a per-edge row dot,
pinned to zero at padding slots (``live``) so that the forward never grows
edges the transpose table cannot see. Plain PyTorch: the reference computes
this form in XLA, with no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graph_wavenet_tpu_torch import resolve_device


@dataclass(eq=False)
class SparseSupport:
    """Padded neighbour-table support (ELL) with its transpose table."""

    idx: torch.Tensor      # (N, D) int32
    w: torch.Tensor        # (N, D)
    idx_t: torch.Tensor    # (N, Dt) int32: nodes whose tables reference v
    perm_t: torch.Tensor   # (N, Dt) int32 into w.ravel(); N*D = zero slot
    live: torch.Tensor     # (N, D) bool: build-time edges

    @property
    def n_nodes(self) -> int:
        return self.idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.idx.shape[1]

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        """Node-leading (N, R) -> (N, R): one diffusion hop."""
        return _EllMix.apply(x2, self.w, self)

    def to_dense(self) -> np.ndarray:
        """Dense (N, N) support with the same ``nconv`` semantics."""
        n, d = self.idx.shape
        dense = np.zeros((n, n), np.float32)
        np.add.at(dense, (self.idx.cpu().numpy().reshape(-1),
                          np.repeat(np.arange(n), d)),
                  self.w.float().cpu().numpy().reshape(-1))
        return dense


def _build(idx: np.ndarray, w: np.ndarray,
           device: torch.device) -> SparseSupport:
    """Assemble a support, deriving the transpose table."""
    n, d = idx.shape
    targets = idx.reshape(-1)                    # edge e feeds node e // d
    flat = np.arange(n * d, dtype=np.int64)
    live = w.reshape(-1) != 0
    order = np.argsort(targets[live], kind="stable")
    tgt_sorted = targets[live][order]
    flat_sorted = flat[live][order]
    counts = np.bincount(tgt_sorted, minlength=n)
    dt = max(int(counts.max()) if counts.size else 0, 1)
    idx_t = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, dt))
    perm_t = np.full((n, dt), n * d, dtype=np.int64)   # sentinel: zero slot
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(tgt_sorted), dtype=np.int64) - starts[tgt_sorted]
    idx_t[tgt_sorted, pos] = flat_sorted // d          # source row n
    perm_t[tgt_sorted, pos] = flat_sorted

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return SparseSupport(i32(idx), torch.as_tensor(w, device=device),
                         i32(idx_t), i32(perm_t),
                         torch.as_tensor(w != 0, device=device))


def from_dense(a: np.ndarray, max_degree: int | None = None, *,
               device: torch.device | str = "cuda") -> SparseSupport:
    """The padded neighbour form of a dense support: row r lists column r's
    nonzeros. A column with more than ``max_degree`` keeps its largest
    magnitudes; the default D is the largest column degree (exact)."""
    device = resolve_device(device)
    a = np.asarray(a, np.float32)
    n = a.shape[0]
    cols = a.T                                   # row r = incoming weights
    nnz = (cols != 0).sum(1)
    d = int(max_degree if max_degree is not None else max(int(nnz.max()), 1))
    # zeros sort last, so kept nonzeros are compacted to each row's front
    order = np.argsort(-np.abs(cols), axis=1, kind="stable")[:, :d]
    vals = np.take_along_axis(cols, order, axis=1)
    live = vals != 0
    idx = np.where(live, order, np.arange(n, dtype=np.int64)[:, None])
    w = np.where(live, vals, 0.0).astype(np.float32)
    return _build(idx.astype(np.int64), w, device)


def from_edges(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
               n_nodes: int, max_degree: int | None = None, *,
               device: torch.device | str = "cuda") -> SparseSupport:
    """Build from an edge list, O(E): edge (src -> dst, weight) contributes
    ``weight * x[src]`` to node dst; duplicate pairs accumulate.
    ``max_degree`` keeps the largest-magnitude incoming edges per node."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    pair = dst * n_nodes + src
    uniq, inv = np.unique(pair, return_inverse=True)
    wsum = np.zeros(len(uniq), np.float32)
    np.add.at(wsum, inv, weight)
    u_dst, u_src = uniq // n_nodes, uniq % n_nodes
    keep_nz = wsum != 0
    u_dst, u_src, wsum = u_dst[keep_nz], u_src[keep_nz], wsum[keep_nz]
    # per dest node by descending |w|, for the top-k cut
    order = np.lexsort((-np.abs(wsum), u_dst))
    u_dst, u_src, wsum = u_dst[order], u_src[order], wsum[order]
    counts = np.bincount(u_dst, minlength=n_nodes)
    d_full = max(int(counts.max()) if counts.size else 0, 1)
    d = min(max_degree, d_full) if max_degree is not None else d_full
    starts = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(u_dst), dtype=np.int64) - starts[u_dst]
    keep = pos < d
    idx = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, d))
    w = np.zeros((n_nodes, d), np.float32)
    idx[u_dst[keep], pos[keep]] = u_src[keep]
    w[u_dst[keep], pos[keep]] = wsum[keep]
    return _build(idx, w, device)


def random_sparse_support(n_nodes: int, degree: int,
                          rng: np.random.Generator | None = None,
                          row_normalize: bool = True, *,
                          device: torch.device | str = "cuda"
                          ) -> SparseSupport:
    """Synthetic constant-degree support without a dense intermediate. The
    same ``rng`` gives the reference builder's support."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng()
    idx = rng.integers(0, n_nodes, size=(n_nodes, degree))
    w = rng.random((n_nodes, degree)).astype(np.float32)
    if row_normalize:
        w = w / w.sum(1, keepdims=True)
    return _build(idx.astype(np.int64), w, device)


def _ell_mix_rows(x2: torch.Tensor, idx: torch.Tensor,
                  w_rows: torch.Tensor) -> torch.Tensor:
    """(N, R), (N, D), (N, D) -> (N, R): ``out[n] = sum_d w_rows[n, d] *
    x2[idx[n, d]]``, products in x's dtype, the sum in fp32, cast back."""
    n, d = idx.shape
    rows = x2.index_select(0, idx.reshape(-1).long())     # (N*D, R)
    rows = rows * w_rows.reshape(-1, 1).to(x2.dtype)
    return rows.reshape(n, d, -1).sum(1, dtype=torch.float32).to(x2.dtype)


class _EllMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, sp: SparseSupport):
        if x2.shape[0] != sp.n_nodes:
            raise ValueError(f"x has {x2.shape[0]} nodes, the support "
                             f"{sp.n_nodes}")
        ctx.sp = sp
        ctx.save_for_backward(x2, w)
        return _ell_mix_rows(x2, sp.idx, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        sp = ctx.sp
        g = g.to(x2.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # transpose weights from the current w (exact gradients in w)
            w_pad = torch.cat([w.reshape(-1), w.new_zeros(1)])
            w_t = w_pad.index_select(0, sp.perm_t.reshape(-1).long())
            dx = _ell_mix_rows(g, sp.idx_t, w_t.reshape(sp.perm_t.shape))
        if ctx.needs_input_grad[1]:
            xg = x2.index_select(0, sp.idx.reshape(-1).long()).reshape(
                *sp.idx.shape, -1)                          # (N, D, R)
            dw = torch.einsum("ndr,nr->nd", xg.float(), g.float()).to(w.dtype)
            dw = torch.where(sp.live, dw, torch.zeros_like(dw))
        return dx, dw, None


def nconv_sparse(x: torch.Tensor, sp) -> torch.Tensor:
    """Sparse diffusion step, same contract as ``nconv``: x (B, T, N, C) ->
    (B, T, N, C) through any support with ``mix_2d``."""
    b, t, n, c = x.shape
    x2 = x.permute(2, 0, 1, 3).reshape(n, b * t * c)
    out = sp.mix_2d(x2)
    return out.reshape(n, b, t, c).permute(1, 2, 0, 3)
