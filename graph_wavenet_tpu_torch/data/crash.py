"""CRASH-style multi-modal neuroimaging pipeline (fMRI + EEG + structural
connectivity).

A copy of ``graph_wavenet_tpu/data/crash.py`` (numpy), which finishes the
reference's dead-code CRASH path (``load_dataset_CRASH`` stops at an
``ipdb.set_trace()``, `Utils/util.py:326-484`), driven by
records the caller provides or by a synthetic stand-in generator (the real
recordings are private):

1. per subject/session records of EEG (electrode-level, fast sampling),
   fMRI (region-level BOLD, slow sampling) and an SC matrix;
2. session alignment: keep sessions present in all three modalities, clip
   to a common length, pad or drop irregular sequences (``pad_seq``);
3. temporal extension: fMRI frame i repeats ``round((i+1)*F_t) -
   round(i*F_t)`` times, so the non-integer rate ratio F_t accumulates
   without drift;
4. spatial extension: EEG electrodes -> regions, each region averaging its
   mapped electrodes;
5. feature-0 standardization, stride-1 windows of K = int(F_t * 5),
   per-session adjacency indices, and batchers with ``adj_idx``: the
   interface of the per-sample-graph synthetic task, so the diff-G engine
   and runner consume CRASH unchanged.

The E-modality communities are the region groups that share a primary
electrode. One seed gives the same arrays as the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graph_wavenet_tpu_torch.data.device_loader import array_loader
from graph_wavenet_tpu_torch.data.scaler import (
    StandardScaler,
    apply_feature0_scaling,
)
from graph_wavenet_tpu_torch.data.windows import sliding_windows
from graph_wavenet_tpu_torch.graphs.generate import Graph
from graph_wavenet_tpu_torch.graphs.normalize import mod_adj


def loadmat(path: str) -> dict:
    """Recursive Matlab .mat -> plain nested dicts (mat_structs and object
    arrays unwrapped), the util the reference raw loaders build on
    (`Utils/CRASH_loader.py:22-70` semantics)."""
    import scipy.io as sio

    def _unwrap(v):
        if isinstance(v, sio.matlab.mat_struct):
            return {f: _unwrap(getattr(v, f)) for f in v._fieldnames}
        if isinstance(v, np.ndarray) and v.dtype == object:
            return np.array([_unwrap(e) for e in v.ravel()],
                            dtype=object).reshape(v.shape)
        return v

    raw = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    return {k: _unwrap(v) for k, v in raw.items()
            if not k.startswith("__")}


def load_records_from_dir(root: str) -> list["CrashRecord"]:
    """Ingest real subject-session records from a directory of npz files.

    Layout: ``<root>/<subject>/<session>.npz`` with arrays ``eeg``
    (n_electrodes, T_eeg), ``fmri`` (T_fmri, n_regions), ``sc``
    (n_regions, n_regions). This replaces the reference's loaders that
    hardcode private local paths (`CRASH_loader.py:15-19`); only sessions
    with all three modalities present are kept (`get_comn_ids` semantics,
    `CRASH_loader.py:293-311`).
    """
    import os

    records = []
    for subject in sorted(os.listdir(root)):
        sdir = os.path.join(root, subject)
        if not os.path.isdir(sdir):
            continue
        for fname in sorted(os.listdir(sdir)):
            if not fname.endswith(".npz"):
                continue
            data = np.load(os.path.join(sdir, fname))
            if not all(k in data for k in ("eeg", "fmri", "sc")):
                continue
            records.append(CrashRecord(
                subject, fname[:-4], np.asarray(data["eeg"]),
                np.asarray(data["fmri"]), np.asarray(data["sc"])))
    return records


@dataclass
class CrashRecord:
    """One subject-session triple."""

    subject: str
    session: str
    eeg: np.ndarray          # (n_electrodes, T_eeg) at eeg_time_res
    fmri: np.ndarray         # (T_fmri, n_regions) at fmri_time_res
    sc: np.ndarray           # (n_regions, n_regions) structural connectivity


def check_arithmetic_progression(arr) -> bool:
    """True iff the sequence advances by a constant step — the reference's
    session-regularity check ``checkIsAP`` (`CRASH_loader.py:79-88`), used to
    detect gaps in session numbering before alignment."""
    arr = list(arr)
    if len(arr) <= 1:
        return True
    d = arr[1] - arr[0]
    return all(arr[i] - arr[i - 1] == d for i in range(2, len(arr)))


def closest_idx(pt: np.ndarray, li: np.ndarray, k: int = 1) -> list[int]:
    """Indices of the k nearest points in ``li`` to ``pt`` by Euclidean
    distance (`CRASH_loader.py:90-100`)."""
    d = np.linalg.norm(np.asarray(li) - np.asarray(pt)[None, :], axis=1)
    return np.argsort(d)[:k].tolist()


def show_slices(slices, path: str | None = None):
    """Row of grayscale image slices (`CRASH_loader.py:72-77`) — NIfTI QC
    helper; saves to ``path`` instead of blocking on plt.show() when given."""
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, len(slices))
    if len(slices) == 1:
        axes = [axes]
    for ax, sl in zip(axes, slices):
        ax.imshow(np.asarray(sl).T, cmap="gray", origin="lower")
    if path is not None:
        fig.savefig(path)
        plt.close(fig)
    else:                      # pragma: no cover - interactive
        plt.show()
    return fig


def region_assignment(n_regions: int, n_electrodes: int,
                      region_pos: np.ndarray | None = None,
                      electrode_pos: np.ndarray | None = None,
                      k: int = 3) -> dict[int, list[int]]:
    """region -> k nearest electrodes by centroid distance
    (`CRASH_loader.py:313-332` semantics). Without positions, a deterministic
    ring layout stands in for the private centroid files."""
    if region_pos is None:
        theta = 2 * np.pi * np.arange(n_regions) / n_regions
        region_pos = np.stack([np.cos(theta), np.sin(theta)], 1)
    if electrode_pos is None:
        theta = 2 * np.pi * np.arange(n_electrodes) / n_electrodes
        electrode_pos = np.stack([np.cos(theta), np.sin(theta)], 1)
    d = ((region_pos[:, None, :] - electrode_pos[None, :, :]) ** 2).sum(-1)
    return {r: np.argsort(d[r])[:k].tolist() for r in range(n_regions)}


def inverse_assignment(assignment: dict[int, list[int]]
                       ) -> dict[int, list[int]]:
    """Invert a region -> electrodes map into electrode -> sorted regions.

    The spatial extension itself consumes ``assignment`` directly (each
    region averages its mapped electrodes, `util.py:432-437`); the inverse
    map is what defines the community structure for the E-modality
    supervision (regions sharing an electrode form a cluster)."""
    inv: dict[int, list[int]] = {}
    for region, electrodes in assignment.items():
        for e in electrodes:
            inv.setdefault(e, [])
            if region not in inv[e]:
                inv[e].append(region)
    return {k: sorted(v) for k, v in inv.items()}


def region_communities(assignment: dict[int, list[int]],
                       n_regions: int) -> np.ndarray:
    """Community label per region = its primary (nearest) electrode,
    re-indexed densely."""
    primary = np.array([assignment[r][0] for r in range(n_regions)])
    _, labels = np.unique(primary, return_inverse=True)
    return labels.astype(np.int32)


def synthetic_crash_records(n_subjects: int = 3, sessions_per_subject: int = 2,
                            n_regions: int = 20, n_electrodes: int = 5,
                            fmri_len: int = 30, fmri_time_res: float = 2.0,
                            eeg_time_res: float = 0.5,
                            rng: np.random.Generator | None = None
                            ) -> list[CrashRecord]:
    """Stand-in records with CRASH's shape properties: slow region-level BOLD
    driven by an SC graph diffusion, fast electrode-level EEG, non-integer
    rate ratio."""
    rng = rng if rng is not None else np.random.default_rng(0)
    F_t = fmri_time_res / eeg_time_res
    eeg_len = 1 + int((fmri_len - 1) * F_t)
    assignment = region_assignment(n_regions, n_electrodes)
    records = []
    for s in range(n_subjects):
        sc = rng.random((n_regions, n_regions))
        sc = np.triu(sc, 1)
        sc = sc + sc.T
        for sess in range(sessions_per_subject):
            A = sc / np.linalg.eigvalsh(sc).max()
            bold = [rng.random(n_regions)]
            for _ in range(fmri_len - 1):
                bold.append(bold[-1] @ A + 0.1 * rng.standard_normal(
                    n_regions))
            fmri = np.stack(bold)
            eeg = np.zeros((n_electrodes, eeg_len))
            inv = inverse_assignment(assignment)
            up = np.repeat(fmri, int(np.ceil(F_t)), axis=0)[:eeg_len]
            for e in range(n_electrodes):
                regions = inv.get(e, [0])
                eeg[e] = up[:, regions].mean(-1) + \
                    0.05 * rng.standard_normal(eeg_len)
            records.append(CrashRecord(f"sub{s}", f"ses{sess}", eeg, fmri,
                                       sc))
    return records


def temporal_extension(fmri: np.ndarray, F_t: float,
                       target_len: int) -> np.ndarray:
    """Repeat frame i ``round((i+1)F_t) - round(i F_t)`` times — integer
    repeats that track the non-integer ratio without drift
    (`util.py:423-429`). fmri: (T_f, N) -> (target_len, N)."""
    chunks = []
    for i in range(len(fmri) - 1):
        rpt = round((i + 1) * F_t) - round(i * F_t)
        chunks.append(np.repeat(fmri[i:i + 1], rpt, axis=0))
    chunks.append(fmri[-1:])
    out = np.concatenate(chunks, axis=0)
    if len(out) < target_len:
        out = np.concatenate(
            [out, np.repeat(out[-1:], target_len - len(out), axis=0)])
    return out[:target_len]


def spatial_extension(eeg: np.ndarray,
                      assignment: dict[int, list[int]],
                      n_regions: int) -> np.ndarray:
    """EEG (T, n_electrodes) -> (T, n_regions): each region averages its
    assigned electrodes (`util.py:432-437`)."""
    out = np.zeros((eeg.shape[0], n_regions))
    for r in range(n_regions):
        out[:, r] = eeg[:, assignment[r]].mean(-1)
    return out


def load_dataset_crash(batch_size: int, records: list[CrashRecord] | None
                       = None, adjtype: str = "doubletransition",
                       fmri_time_res: float = 2.0, eeg_time_res: float = 0.5,
                       fmri_len: int | None = None, pad_seq: bool = False,
                       K: int | None = None, train_frac: float = 0.7,
                       val_frac: float = 0.15, seed: int = 0,
                       assignment: dict[int, list[int]] | None = None,
                       resident: str = "host",
                       device: torch.device | str = "cuda"):
    """Full pipeline -> (data dict, supports_by_split, F_t_int, G_by_split).

    Output contract matches the per-sample-graph synthetic task so the diff-G
    engine/runner run CRASH unchanged: loaders yield (x, y, adj_idx); the
    returned F_t is the integer pooling factor for the F-modality supervision
    (ceil of the rate ratio, clipped to divide K). Under data parallelism
    every rank calls it with the same ``seed`` and records and draws the
    same batches; the engine takes the rank's rows.
    """
    rng = np.random.default_rng(seed)
    if records is None:
        records = synthetic_crash_records(
            fmri_time_res=fmri_time_res, eeg_time_res=eeg_time_res, rng=rng)

    n_regions = records[0].fmri.shape[1]
    n_electrodes = records[0].eeg.shape[0]
    F_t = fmri_time_res / eeg_time_res
    if fmri_len is None:
        fmri_len = min(len(r.fmri) for r in records)
    eeg_len = 1 + int((fmri_len - 1) * F_t)

    # session alignment: clip, then pad or drop irregular sequences
    kept: list[CrashRecord] = []
    for r in records:
        fmri = r.fmri[:fmri_len]
        eeg = r.eeg[:, :eeg_len].T            # (T_e, n_elec)
        if len(fmri) < fmri_len or len(eeg) < eeg_len:
            if not pad_seq:
                continue
            if len(fmri) < fmri_len:
                fmri = np.concatenate([fmri, np.repeat(
                    fmri[-1:], fmri_len - len(fmri), axis=0)])
            if len(eeg) < eeg_len:
                eeg = np.concatenate([eeg, np.repeat(
                    eeg[-1:], eeg_len - len(eeg), axis=0)])
        kept.append(CrashRecord(r.subject, r.session, eeg.T, fmri, r.sc))
    assert kept, "no sessions survived alignment"
    # subject-major order: the split below cuts this list chronologically,
    # and (with >= 3 subjects) at subject boundaries — interleaved input
    # records must not scatter one subject across the cut points
    subject_order = list(dict.fromkeys(r.subject for r in kept))
    kept = [r for s in subject_order for r in kept if r.subject == s]

    assignment = assignment or region_assignment(n_regions, n_electrodes)
    communities = region_communities(assignment, n_regions)
    n_communities = int(communities.max()) + 1

    # per-session signals: channel 0 = upsampled fMRI, channel 1 = EEG
    # expanded to regions
    signals = []
    for r in kept:
        f_up = temporal_extension(r.fmri, F_t, eeg_len)
        e_reg = spatial_extension(r.eeg.T[:eeg_len], assignment, n_regions)
        signals.append(np.stack([f_up, e_reg], axis=-1))  # (T, N, 2)
    signals = np.stack(signals).astype(np.float32)        # (S, T, N, 2)

    if K is None:
        K = int(F_t * 5)                                  # `util.py:417`
    # integer F-pool factor for supervision; must divide K. Start at the
    # documented ceil of the rate ratio and fall back to the largest
    # divisor of K below it — warn when that degrades pooling to 1 (no
    # F-modality coarsening), rather than silently disabling supervision.
    F_t_ceil = max(1, int(np.ceil(F_t)))
    F_t_int = F_t_ceil
    while K % F_t_int:
        F_t_int -= 1
    # warn on ANY material deviation from the intended ceil(F_t), not only
    # total degradation to 1 (ADVICE r1: K=int(582.4*5)=2912's largest
    # divisor below 583 is 448, a silent ~23% coarsening)
    if F_t_ceil - F_t_int > 0.05 * F_t_ceil:
        print(f"CRASH loader: F-pool factor degraded from ceil(F_t)="
              f"{F_t_ceil} to {F_t_int} (largest divisor of K={K}) — "
              f"pass K as a multiple of {F_t_ceil}, e.g. "
              f"K={F_t_ceil * max(1, round(K / F_t_ceil))}", flush=True)

    # stride-1 windows: x = window, y = next K steps (`dataTools.py:148-150`)
    windows = sliding_windows(signals, K, axis=1)          # (S, n_win, K, N, 2)
    xs = windows[:, :-K]
    ys = windows[:, K:]

    # chronological split of sessions. With >= 3 subjects the cuts land on
    # SUBJECT boundaries (nearest to the requested fractions, one subject
    # minimum per split), so a subject's dynamics and SC graph never leak
    # from train into val/test; with fewer subjects that is impossible and
    # the split falls back to per-session cuts (subjects then straddle
    # splits — unavoidable with < 3 subjects).
    n_sessions = len(kept)
    if n_sessions < 3:
        raise ValueError(
            f"CRASH split needs >= 3 aligned sessions (one per split), got "
            f"{n_sessions} — add sessions or relax alignment (pad_seq)")
    counts = [sum(1 for r in kept if r.subject == s) for s in subject_order]
    if len(subject_order) >= 3:
        cum = np.cumsum(counts)
        b1 = int(np.clip(
            np.argmin(np.abs(cum - train_frac * n_sessions)) + 1,
            1, len(subject_order) - 2))
        b2 = int(np.clip(
            np.argmin(np.abs(cum - (train_frac + val_frac) * n_sessions))
            + 1, b1 + 1, len(subject_order) - 1))
        n_train = int(cum[b1 - 1])
        n_val = int(cum[b2 - 1]) - n_train
        n_test = n_sessions - n_train - n_val
    else:
        n_train = max(1, round(n_sessions * train_frac))
        n_val = max(1, round(n_sessions * val_frac))
        n_test = max(1, n_sessions - n_train - n_val)
        n_train = n_sessions - n_val - n_test
    if n_train < 1:
        raise ValueError(
            f"CRASH split fractions train_frac={train_frac}, "
            f"val_frac={val_frac} leave no training sessions out of "
            f"{n_sessions} (train/val/test = {n_train}/{n_val}/{n_test})")

    graphs = []
    supports = []
    for r in kept:
        g = Graph("adjacency", n_regions, {"adjacencyMatrix": r.sc})
        g.assign_dict = {c: np.nonzero(communities == c)[0]
                         for c in range(n_communities)}
        graphs.append(g)
        supports.append(mod_adj(r.sc, adjtype))

    bounds = [0, n_train, n_train + n_val, n_sessions]
    names = ("train", "val", "test")
    data: dict = {}
    G_by_split: dict = {}
    sup_by_split: dict = {}
    for name, lo, hi in zip(names, bounds, bounds[1:]):
        # .copy(): stride-trick windows are read-only views, and the scaler
        # standardizes feature 0 in place downstream
        x = xs[lo:hi].reshape(-1, *xs.shape[2:]).copy()
        y = ys[lo:hi].reshape(-1, *ys.shape[2:]).copy()
        idx = np.repeat(np.arange(hi - lo), xs.shape[1])
        data["x_" + name] = x
        data["y_" + name] = y
        data[name + "_adj_idx"] = idx
        G_by_split[name] = graphs[lo:hi]
        n_sup = len(supports[0])
        sup_by_split[name] = [
            np.stack([supports[s][j] for s in range(lo, hi)])
            for j in range(n_sup)]

    scaler = StandardScaler.fit(data["x_train"][..., 0])
    apply_feature0_scaling(data, scaler)
    for name in names:
        data[name + "_loader"] = array_loader(
            resident, data["x_" + name], data["y_" + name], batch_size, rng,
            adj_idx=data[name + "_adj_idx"], device=device)
    data["scaler"] = scaler
    data["n_communities"] = n_communities
    data["K"] = K
    return data, sup_by_split, F_t_int, G_by_split
