"""Synthetic multi-modality (fMRI/EEG-like) prediction dataset.

A copy of ``graph_wavenet_tpu/data/synthetic.py`` (numpy), the reference's
``MultiModalityPrediction`` (`Utils/dataTools.py:24-292`)
and ``load_dataset_syn`` (`Utils/util.py:219-324`): a
linear graph-diffusion AR(1) process rolled out on an SBM graph and seen
through two coarsened modalities,

- **F** (temporally coarse, fMRI-like): pooled over windows of ``F_t``
  steps, repeated back to full rate;
- **E** (spatially coarse, EEG-like): pooled over the SBM communities,
  broadcast back to the member nodes.

Stride-1 windows of length K (input) and the following K steps (target)
make the samples. One seed draws the same graphs, samples, ``adj_idx`` and
scaler as the reference package, bit for bit; the reference's quirks are
kept (the 'weighted' F pool forces alpha=1, the 'weighted' E pool's
hop-decay weights are unnormalized). The batchers are the port's
(``data.device_loader.array_loader``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from graph_wavenet_tpu_torch.config import DataConfig
from graph_wavenet_tpu_torch.data.device_loader import array_loader
from graph_wavenet_tpu_torch.data.scaler import (
    StandardScaler,
    apply_feature0_scaling,
)
from graph_wavenet_tpu_torch.data.windows import sliding_windows
from graph_wavenet_tpu_torch.graphs.generate import Graph
from graph_wavenet_tpu_torch.graphs.normalize import mod_adj


def _cov_factor(cov: np.ndarray) -> np.ndarray:
    """L with L @ L.T = cov for a PSD (possibly singular) covariance.

    Cholesky when positive definite; an eigen factor otherwise — sigma=0
    and/or rho=0 are legitimate "no noise" settings (the reference's
    np.random.multivariate_normal defaults to SVD and accepts them,
    `dataTools.py:125-127`), and rank-1 rho^2*ones is singular by
    construction."""
    if not cov.any():
        return np.zeros_like(cov)
    try:
        return np.linalg.cholesky(cov)
    except np.linalg.LinAlgError:
        vals, vecs = np.linalg.eigh(cov)
        return vecs * np.sqrt(np.maximum(vals, 0.0))[None, :]


def _mvn(rng: np.random.Generator, n_dim: int, sigma: float, rho: float,
         size) -> np.ndarray:
    """MVN(0, sigma^2 I + rho^2 * ones) samples of shape (*size, n_dim)."""
    cov = sigma ** 2 * np.eye(n_dim) + rho ** 2 * np.ones((n_dim, n_dim))
    size = tuple(np.atleast_1d(size))
    return rng.standard_normal(size + (n_dim,)) @ _cov_factor(cov).T


def diffusion_rollout(G: Graph, n_samples: int, horizon: int,
                      sigma_spatial: float, sigma_temporal: float,
                      rho_spatial: float, rho_temporal: float,
                      rng: np.random.Generator) -> np.ndarray:
    """x_{t+1} = x_t A + spatial noise + temporal noise, A = W / lambda_max
    (`dataTools.py:104-132`). Returns (n_samples, N, horizon).

    All noise is sampled up front with a single covariance factor (the
    reference re-factorizes the spatial covariance every timestep,
    `dataTools.py:125-127` — same distribution, ~100x faster dataset
    builds)."""
    A = G.W / G.lambda_max()   # reuses the cached GFT when computed
    x_t = rng.random((n_samples, G.N))
    x = [x_t]
    temp_noise = _mvn(rng, horizon, sigma_temporal, rho_temporal,
                      (n_samples, G.N))            # (L, N, horizon)
    temp_noise = np.transpose(temp_noise, (2, 0, 1))
    cov_spatial = (sigma_spatial ** 2 * np.eye(G.N) +
                   rho_spatial ** 2 * np.ones((G.N, G.N)))
    spatial_all = rng.standard_normal(
        (horizon - 1, n_samples, G.N)) @ _cov_factor(cov_spatial).T
    for t in range(horizon - 1):
        x_t = x_t @ A + spatial_all[t] + temp_noise[t]
        x.append(x_t)
    return np.stack(x, axis=-1)


def pool_temporal(x: np.ndarray, F_t: int, pooltype: str = "avg",
                  alpha: float = 0.8) -> np.ndarray:
    """F modality: (L, N, T) -> (L, T, N) pooled per F_t window and repeated
    back (`dataTools.py:167-190`)."""
    L, N, T = x.shape
    if T % F_t:
        # reference behavior for this combination is an opaque reshape crash
        # (avg/weighted) or a mis-sized F that breaks the later FE stack
        # (selectOne); name the real constraint instead
        raise ValueError(
            f"temporal F pooling needs the series length T={T} "
            f"(num_timestep) divisible by F_t={F_t}")
    if pooltype == "selectOne":
        F = x[:, :, np.arange(0, T, F_t)]
    elif pooltype == "avg":
        F = x.reshape(L, N, -1, F_t).mean(-1)
    elif pooltype == "weighted":
        alpha = 1.0  # reference quirk: weighted F pool forces alpha=1
        w = np.array([alpha ** abs(i - F_t // 2) for i in range(F_t)])
        w = w / w.sum()
        F = (x.reshape(L, N, -1, F_t) * w[None, None, None, :]).sum(-1)
    else:
        raise ValueError(f"unknown pooltype {pooltype!r}")
    F = F.transpose(0, 2, 1)
    return F.repeat(F_t, axis=1)


def _hop_decay_weights(cluster_W: np.ndarray, chosen: int,
                       beta: float) -> np.ndarray:
    """Unnormalized hop-decay weights from a center node within a cluster
    (`dataTools.py:208-227`); capped BFS guards disconnected clusters."""
    n = len(cluster_W)
    weight = np.zeros(n)
    remained = np.ones(n, dtype=int)
    weight[chosen] = 1.0
    remained[chosen] = 0
    nei = cluster_W[chosen].astype(bool)
    k = 1
    while remained.sum() != 0 and k <= n:
        weight[nei] = beta ** k
        remained = remained - nei
        nei = (cluster_W[nei].sum(0).astype(bool) * remained).astype(bool)
        k += 1
    return weight


def pool_spatial(x: np.ndarray, G: Graph, pooltype: str = "avg",
                 beta: float = 0.8) -> np.ndarray:
    """E modality: (L, N, T) -> (L, T, N) pooled per community and broadcast
    back to member nodes (`dataTools.py:192-238`)."""
    assign = G.assign_dict
    pooled = []
    for _, v in assign.items():
        v = np.asarray(v)
        if pooltype == "selectOne":
            pooled.append(x[:, v[len(v) // 2], :])
        elif pooltype == "avg":
            pooled.append(x[:, v, :].mean(axis=1))
        elif pooltype == "weighted":
            w = _hop_decay_weights(G.W[np.ix_(v, v)], len(v) // 2, beta)
            pooled.append((x[:, v, :] * w[None, :, None]).sum(1))
        else:
            raise ValueError(f"unknown pooltype {pooltype!r}")
    stacked = np.stack(pooled, axis=-1)             # (L, T, C)
    E = np.zeros((x.shape[0], x.shape[2], x.shape[1]))
    for c, v in assign.items():
        E[:, :, np.asarray(v)] = stacked[:, :, c:c + 1]
    return E


@dataclass
class MultiModalityPrediction:
    """Generates and splits the synthetic 2-channel (F, E) samples.

    x: (n, K, N, 2) input windows; y: (n, K, N, 2) the *next* K steps
    (`dataTools.py:148-150`).
    """

    G: Graph
    K: int
    n_train: int
    n_valid: int
    n_test: int
    horizon: int
    F_t: int = 5
    pooltype: str = "weighted"
    f_pool_decay: float = 0.8
    e_pool_decay: float = 0.8
    sigma_spatial: float = 1.0
    sigma_temporal: float = 0.0
    rho_spatial: float = 0.0
    rho_temporal: float = 0.0
    rng: np.random.Generator | None = None
    samples: dict = field(init=False)

    def __post_init__(self):
        assert self.K % self.F_t == 0, "K must divide by F_t"
        if self.horizon % self.F_t:
            raise ValueError(
                f"num_timestep (horizon={self.horizon}) must be divisible "
                f"by F_t={self.F_t} — the F modality pools the whole "
                f"rollout in F_t blocks (`dataTools.py:172-182`)")
        if self.horizon - self.K + 1 <= self.K:
            raise ValueError(
                f"num_timestep (horizon={self.horizon}) too short for "
                f"seq_length K={self.K}: y windows are the NEXT K steps of "
                f"each x window, so horizon must be >= 2K "
                f"(`dataTools.py:148-150`); every split would be empty")
        rng = self.rng if self.rng is not None else np.random.default_rng()
        n_total = self.n_train + self.n_valid + self.n_test
        x = diffusion_rollout(self.G, n_total, self.horizon,
                              self.sigma_spatial, self.sigma_temporal,
                              self.rho_spatial, self.rho_temporal, rng)
        F = pool_temporal(x, self.F_t, self.pooltype, self.f_pool_decay)
        E = pool_spatial(x, self.G, self.pooltype, self.e_pool_decay)
        FE = np.stack((F, E), axis=-1)              # (L, horizon, N, 2)

        K = self.K
        windows = sliding_windows(FE, K, axis=1)    # (L, n_win, K, N, 2)
        signals = windows[:, :-K]
        labels = windows[:, K:]
        self.samples = {}
        bounds = [0, self.n_train, self.n_train + self.n_valid, n_total]
        for name, lo, hi in zip(("train", "val", "test"), bounds, bounds[1:]):
            self.samples[name] = {"x": signals[lo:hi], "y": labels[lo:hi]}

    def get_samples(self, split: str) -> tuple[np.ndarray, np.ndarray]:
        """Flattened (n*windows, K, N, 2) arrays (`dataTools.py:240-258`)."""
        x = self.samples[split]["x"]
        y = self.samples[split]["y"]
        return (x.reshape(-1, *x.shape[2:]).copy(),
                y.reshape(-1, *y.shape[2:]).copy())


def load_dataset_syn(cfg: DataConfig, batch_size: int, seed: int = 0,
                     resident: str = "host",
                     device: torch.device | str = "cuda"):
    """Build the synthetic dataset + loaders (the reference's
    `Utils/util.py:219-324`).

    ``resident``: ``"host"`` batchers, or ``"device"`` ones keeping the
    splits on ``device`` (``data.device_loader.array_loader``).

    Returns ``(data, adjs, F_t, G)``:
    - same_g: ``adjs`` = list of normalized supports of the single graph,
      ``G`` a single :class:`Graph`;
    - per-sample graphs: ``adjs`` = per-sample support lists, ``G`` a dict
      of per-split Graph lists, and loaders yield ``(x, y, adj_idx)``.

    Under data parallelism every rank calls it with the same ``seed``, so
    every rank holds the same splits and draws the same batches; the
    engine takes the rank's rows of each (``train.engine``).
    """
    rng = np.random.default_rng(seed)
    graph_options = {"nCommunities": cfg.n_communities,
                     "probIntra": cfg.prob_intra,
                     "probInter": cfg.prob_inter}
    F_t = cfg.seq_length // 12  # K % F_t == 0 convention (`util.py:234`)
    if F_t < 1:
        raise ValueError(
            f"synthetic dataset needs seq_length >= 12: F_t = "
            f"seq_length//12 = {F_t} (the reference convention, "
            "util.py:234) must be a positive pooling factor")
    gen_kw = dict(F_t=F_t, pooltype=cfg.pooltype,
                  sigma_spatial=cfg.sigma_spatial,
                  sigma_temporal=cfg.sigma_temporal,
                  rho_spatial=cfg.rho_spatial, rho_temporal=cfg.rho_temporal)

    if cfg.same_g:
        G = Graph("SBM", cfg.num_nodes, graph_options, rng=rng)
        G.computeGFT()
        gen = MultiModalityPrediction(
            G, cfg.seq_length, cfg.n_train, cfg.n_valid, cfg.n_test,
            cfg.num_timestep, rng=rng, **gen_kw)
        data = {}
        for category in ("train", "val", "test"):
            data["x_" + category], data["y_" + category] = \
                gen.get_samples(category)
        scaler = StandardScaler.fit(data["x_train"][..., 0])
        apply_feature0_scaling(data, scaler)
        for category in ("train", "val", "test"):
            data[category + "_loader"] = array_loader(
                resident, data["x_" + category], data["y_" + category],
                batch_size, rng, device=device)
        data["scaler"] = scaler
        return data, mod_adj(G.W, cfg.adjtype), F_t, G

    # ---- per-sample graphs (`util.py:267-324`) ------------------------
    n_total = cfg.n_train + cfg.n_valid + cfg.n_test
    graphs, adjs, xs, ys = [], [], [], []
    for _ in range(n_total):
        G = Graph("SBM", cfg.num_nodes, graph_options, rng=rng)
        G.computeGFT()
        gen = MultiModalityPrediction(
            G, cfg.seq_length, 1, 0, 0, cfg.num_timestep, rng=rng, **gen_kw)
        x, y = gen.get_samples("train")
        xs.append(x)
        ys.append(y)
        graphs.append(G)
        adjs.append(mod_adj(G.W, cfg.adjtype))

    xs = np.stack(xs)                                # (L, n_win, K, N, 2)
    ys = np.stack(ys)

    n_tr, n_va = cfg.n_train, cfg.n_valid
    G = {"train": graphs[:n_tr], "val": graphs[n_tr:n_tr + n_va],
         "test": graphs[n_tr + n_va:]}
    data = {
        "x_train": xs[:n_tr], "y_train": ys[:n_tr],
        "x_val": xs[n_tr:n_tr + n_va], "y_val": ys[n_tr:n_tr + n_va],
        "x_test": xs[n_tr + n_va:], "y_test": ys[n_tr + n_va:],
    }
    adj_idx = {}
    for split, n in (("train", n_tr), ("val", n_va), ("test", cfg.n_test)):
        n_win = data["x_" + split].shape[1]
        adj_idx[split] = np.repeat(np.arange(n)[:, None], n_win, axis=1)
    # subject-major flattening: "train on one subject then finetune"
    # batching of the reference (`util.py:304-308`)
    for k, v in list(data.items()):
        data[k] = v.reshape(-1, *v.shape[2:])
    for split in adj_idx:
        adj_idx[split] = adj_idx[split].reshape(-1)

    scaler = StandardScaler.fit(data["x_train"][..., 0])
    apply_feature0_scaling(data, scaler)
    for category in ("train", "val", "test"):
        data[category + "_loader"] = array_loader(
            resident, data["x_" + category], data["y_" + category],
            batch_size, rng, adj_idx=adj_idx[category], device=device)
    data["scaler"] = scaler
    return data, adjs, F_t, G


def stack_support_splits(adjs: list[list[np.ndarray]], n_train: int,
                         n_test: int) -> dict[str, list[np.ndarray]]:
    """Per-sample support lists -> per-split stacked (n, N, N) arrays, the
    layout the diff-G engine gathers from (`train.py:94-121`).
    """
    n_supports = len(adjs[0])
    n = len(adjs)
    # explicit bounds: adjs[n_train:-0] would be empty and adjs[-0:] the
    # whole list for n_test == 0
    splits = {"train": adjs[:n_train], "val": adjs[n_train:n - n_test],
              "test": adjs[n - n_test:]}

    def _stack(samples, s):
        if not samples:
            return np.zeros((0,) + np.asarray(adjs[0][s]).shape,
                            np.asarray(adjs[0][s]).dtype)
        return np.stack([sample[s] for sample in samples])

    return {
        split: [_stack(samples, s) for s in range(n_supports)]
        for split, samples in splits.items()
    }
