"""Raw CRASH directory ingestion: the reference's on-disk layout, portable.

A copy of ``graph_wavenet_tpu/data/crash_raw.py`` (numpy, and scipy for the
``.mat`` files, imported where they are read).

The reference ships loaders for its private export tree
(`Utils/CRASH_loader.py`) with the base directory hardcoded
to a local path (`CRASH_loader.py:15-19`). This module implements the same
tree walk and file/key conventions against a caller-supplied ``base_dir``,
so a reference user's exported data (eeglab ``.mat`` EEG, region-level BOLD
``.mat``, structural-connectivity ``.mat``, Schaefer parcellation text
files) loads into this framework unchanged:

    base_dir/
      eeg/<subj>/<ses-s{n}...>/eeg/data.mat            key 'data'
      fmri/matfiles/sub-<subj>/<ses-{n}>/*rest*{R}plus.mat
                                                       key 'corrected_bold'
      sc/sub-<subj>/<ses-{n}>/*{R}plus.mat             key 'CRASH_schaefer
                        {R}plus_2mm_mni_17network_lps_ncount_pass'
      sc/Parcellations/MNI/Schaefer2018_{R}Parcels_17Networks_order_
                        FSLMNI152_2mm.txt              region centroids
      utils/eeg_coor_conv/ny_x_z                       electrode coords

``collect_records`` bridges the raw tree to :class:`CrashRecord`, so
``load_dataset_crash`` (and through it the diff-G engine/runner) consumes a
real CRASH export end-to-end. ``export_pickles`` mirrors the reference's
``__main__`` artifact dump (`CRASH_loader.py:334-373`).
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from graph_wavenet_tpu_torch.data.crash import CrashRecord, closest_idx

EEG_HZ = 640.0            # all exported EEG shares one rate, CRASH_loader.py:127-131
FMRI_TIME_RES = 0.910     # seconds per BOLD bin, CRASH_loader.py:190,231
SC_KEY = "CRASH_schaefer{R}plus_2mm_mni_17network_lps_ncount_pass"
# 'ncount' chosen of the four exported streamline metrics, CRASH_loader.py:283-289


def _session_dirs(subj_dir: str) -> list[str]:
    """Sorted session subdirectories whose name starts with 's'
    (`CRASH_loader.py:137-140` and the fmri/sc twins)."""
    if not os.path.isdir(subj_dir):
        return []
    return sorted(
        os.path.join(subj_dir, o) for o in os.listdir(subj_dir)
        if os.path.isdir(os.path.join(subj_dir, o)) and o.startswith("s"))


def _eeg_session_num(sess_dir: str) -> int:
    """``ses-s{n}_...`` -> n (`CRASH_loader.py:143`: last '-' field, first
    '_' field, leading character dropped)."""
    return int(os.path.basename(sess_dir).split("-")[-1].split("_")[0][1:])


def _fmri_session_num(sess_dir: str) -> int:
    """``ses-{n}`` -> n (`CRASH_loader.py:205,246,274`)."""
    return int(os.path.basename(sess_dir).split("-")[-1])


def _glob_one(pattern: str, what: str) -> str:
    names = glob.glob(pattern)
    if len(names) != 1:
        raise FileNotFoundError(
            f"expected exactly one {what} matching {pattern}, "
            f"found {len(names)}")  # reference hits ipdb here instead
    return names[0]


def get_comn_ids(base_dir: str) -> list[str]:
    """Subject ids present in all three modality trees — digit-leading
    directory names under eeg/, ``sub-`` prefixed under fmri/matfiles and
    sc/ (`CRASH_loader.py:293-311`)."""
    def _digit_dirs(d: str, strip_sub: bool) -> list[str]:
        if not os.path.isdir(d):
            return []
        out = []
        for o in sorted(os.listdir(d)):
            if not os.path.isdir(os.path.join(d, o)):
                continue
            name = o[4:] if strip_sub else o
            if (strip_sub and (len(o) <= 4 or not o.startswith("sub-"))):
                continue
            if name[:1].isdigit():
                out.append(name)
        return out

    eeg_ids = _digit_dirs(os.path.join(base_dir, "eeg"), False)
    fmri_ids = _digit_dirs(os.path.join(base_dir, "fmri", "matfiles"), True)
    sc_ids = _digit_dirs(os.path.join(base_dir, "sc"), True)
    comn = sorted(v for v in eeg_ids if v in fmri_ids)
    return sorted(v for v in sc_ids if v in comn)


def get_eeg(base_dir: str, comn_ids: list[str]) -> dict:
    """``{subj: {sess_num: (n_electrodes, T) array}, 'time_res': 1/640}``
    from ``eeg/<subj>/<ses>/eeg/data.mat`` (`CRASH_loader.py:102-183`)."""
    import scipy.io as sio

    eeg: dict = {"time_res": 1.0 / EEG_HZ}
    for subj in comn_ids:
        eeg[subj] = {}
        for sess_dir in _session_dirs(os.path.join(base_dir, "eeg", subj)):
            data = sio.loadmat(os.path.join(sess_dir, "eeg", "data.mat"),
                               squeeze_me=True)["data"]
            eeg[subj][_eeg_session_num(sess_dir)] = np.asarray(data)
    return eeg


def get_fmri(base_dir: str, comn_ids: list[str], num_region: int) -> dict:
    """``{subj: {sess_num: (T, num_region) BOLD}, 'time_res': 0.910}`` from
    ``fmri/matfiles/sub-<subj>/<ses>/*rest*{R}plus.mat`` key
    'corrected_bold' (`CRASH_loader.py:227-256`)."""
    import scipy.io as sio

    fmri: dict = {"time_res": FMRI_TIME_RES}
    for subj in comn_ids:
        fmri[subj] = {}
        subj_dir = os.path.join(base_dir, "fmri", "matfiles", "sub-" + subj)
        for sess_dir in _session_dirs(subj_dir):
            name = _glob_one(
                os.path.join(sess_dir, f"*rest*{num_region}plus.mat"),
                "fmri file")
            bold = sio.loadmat(name)["corrected_bold"]
            fmri[subj][_fmri_session_num(sess_dir)] = \
                np.asarray(bold)[:, :num_region]
    return fmri


def get_sc(base_dir: str, comn_ids: list[str], num_region: int) -> dict:
    """``{subj: {sess_num: (num_region, num_region) ncount SC}}`` from
    ``sc/sub-<subj>/<ses>/*{R}plus.mat`` (`CRASH_loader.py:258-291`)."""
    import scipy.io as sio

    sc: dict = {}
    key = SC_KEY.format(R=num_region)
    for subj in comn_ids:
        sc[subj] = {}
        subj_dir = os.path.join(base_dir, "sc", "sub-" + subj)
        for sess_dir in _session_dirs(subj_dir):
            name = _glob_one(
                os.path.join(sess_dir, f"*{num_region}plus.mat"), "sc file")
            mat = sio.loadmat(name)[key]
            sc[subj][_fmri_session_num(sess_dir)] = \
                np.asarray(mat)[:num_region, :num_region]
    return sc


def get_fmri_bold(base_dir: str, comn_ids: list[str], atlas: np.ndarray,
                  load_img=None) -> dict:
    """Voxel-level BOLD pooled to region level: region r's series is the
    mean over atlas==r voxels per frame.

    The reference's version is unfinished — it loops over the *tuple*
    ``(1, num_roi+1)`` instead of a range and collapses every frame into one
    scalar mean, stopping at an ``ipdb.set_trace()``
    (`CRASH_loader.py:185-225`); this implements the intended per-frame
    per-region pooling. ``load_img(path) -> (x, y, z, T) ndarray``; defaults
    to nibabel when available (not baked into this image — pass arrays or a
    loader otherwise). ``base_dir`` is required like the other loaders (the
    reference hardcodes it, `CRASH_loader.py:15-19`)."""
    if load_img is None:
        def load_img(path):
            try:
                import nibabel as nib
            except ImportError as e:  # pragma: no cover - env-dependent
                raise ImportError(
                    "get_fmri_bold needs nibabel or an explicit load_img "
                    "callable") from e
            return np.asarray(nib.load(path).get_fdata())

    atlas = np.asarray(atlas)
    num_roi = int(atlas.max())
    fmri_data: dict = {"time_res": FMRI_TIME_RES}
    for subj in comn_ids:
        fmri_data[subj] = {}
        subj_dir = os.path.join(base_dir, "fmri", "matfiles",
                                "sub-" + subj)
        for sess_dir in _session_dirs(subj_dir):
            name = _glob_one(
                os.path.join(sess_dir, "func",
                             "0_sub-*_rest_bold_MNI_3mm.nii.gz"),
                "bold file")
            ts = np.asarray(load_img(name))          # (x, y, z, T)
            roi = np.zeros((num_roi, ts.shape[-1]))
            for r in range(1, num_roi + 1):
                vox = ts[atlas == r]                  # (n_voxels, T)
                if vox.size:
                    roi[r - 1] = vox.mean(axis=0)
            fmri_data[subj][_fmri_session_num(sess_dir)] = roi
    return fmri_data


def get_region_assignment(base_dir: str, num_region: int,
                          k: int = 3) -> dict[int, list[int]]:
    """**electrode -> regions** map from the real coordinate files: each
    region's centroid (parcellation text, cols 3-6 = x,y,z,label) is
    assigned to its ``k`` nearest electrodes (``ny_x_z`` cols 1-3, axes
    permuted y,x,z -> x,y,z) (`CRASH_loader.py:313-332`). The reference's
    ``__main__`` calls this with no argument — a latent TypeError
    (`CRASH_loader.py:353`); here ``num_region`` is required.

    NB conventions: this returns the reference's pickle format,
    ``{electrode: [regions]}``. The downstream pipeline
    (``load_dataset_crash`` / ``spatial_extension`` /
    ``region_communities`` in `data/crash.py`) consumes the INVERSE map
    ``{region: [electrodes]}`` — invert with :func:`invert_assignment`
    (the reference inverts inline at `util.py:399-404`)."""
    coor_mri = np.loadtxt(
        os.path.join(base_dir, "sc", "Parcellations", "MNI",
                     f"Schaefer2018_{num_region}Parcels_17Networks_order_"
                     "FSLMNI152_2mm.txt"), usecols=(3, 4, 5, 6))
    coor_eeg = np.loadtxt(
        os.path.join(base_dir, "utils", "eeg_coor_conv", "ny_x_z"),
        usecols=(1, 2, 3))[:, [1, 0, 2]]

    assignment: dict[int, list[int]] = {e: [] for e in range(len(coor_eeg))}
    for i in range(num_region):
        centroid = coor_mri[coor_mri[:, -1] == (i + 1)][:, :3].mean(0)
        for e in closest_idx(centroid, coor_eeg, k=k):
            assignment[e].append(i)
    return assignment


def invert_assignment(assignment: dict[int, list[int]],
                      num_region: int) -> dict[int, list[int]]:
    """Invert the electrode -> regions map of
    :func:`get_region_assignment` into the **region -> sorted electrodes**
    map the pipeline consumes, mirroring the reference's inline inversion
    (`util.py:399-404`: sorted de-duplicated electrode lists).

    A region that no electrode claims would silently average zero
    electrodes downstream (the reference notes the "empty nodes" issue at
    `util.py:410` and its ``inv_mapping[i]`` would KeyError); here it is a
    hard error naming the regions — raise ``k`` or fix the coordinates."""
    inv: dict[int, list[int]] = {r: [] for r in range(num_region)}
    for electrode, regions in assignment.items():
        for r in regions:
            if r not in inv:
                raise ValueError(
                    f"assignment references region {r} outside "
                    f"num_region={num_region} — electrode->regions and "
                    "region->electrodes conventions swapped?")
            if electrode not in inv[r]:
                inv[r].append(electrode)
    empty = [r for r, es in inv.items() if not es]
    if empty:
        raise ValueError(
            f"{len(empty)} regions have no assigned electrode (e.g. "
            f"{empty[:5]}): the EEG spatial extension would average an "
            "empty set — increase k in get_region_assignment or check "
            "the coordinate files")
    return {r: sorted(es) for r, es in inv.items()}


def common_sessions(eeg: dict, fmri: dict, sc: dict,
                    comn_ids: list[str]) -> tuple[dict, dict, dict]:
    """Keep only session numbers present in all three modalities per
    subject (`CRASH_loader.py:341-351`)."""
    for subj in comn_ids:
        keep = [s for s in eeg[subj] if s in sc[subj] and s in fmri[subj]]
        eeg[subj] = {s: v for s, v in eeg[subj].items() if s in keep}
        sc[subj] = {s: v for s, v in sc[subj].items() if s in keep}
        fmri[subj] = {s: v for s, v in fmri[subj].items() if s in keep}
    return eeg, fmri, sc


def collect_records(base_dir: str, num_region: int = 200
                    ) -> list[CrashRecord]:
    """Walk a reference-layout export tree into :class:`CrashRecord`s
    (common subjects, common sessions), ready for ``load_dataset_crash``."""
    ids = get_comn_ids(base_dir)
    eeg = get_eeg(base_dir, ids)
    fmri = get_fmri(base_dir, ids, num_region)
    sc = get_sc(base_dir, ids, num_region)
    eeg, fmri, sc = common_sessions(eeg, fmri, sc, ids)
    records = []
    for subj in ids:
        for sess in sorted(eeg[subj]):
            records.append(CrashRecord(
                subj, str(sess), np.asarray(eeg[subj][sess]),
                np.asarray(fmri[subj][sess]), np.asarray(sc[subj][sess])))
    return records


def export_pickles(base_dir: str, out_dir: str, num_region: int = 200,
                   k: int = 3) -> dict[str, str]:
    """The reference ``__main__``'s artifact dump: eeg/sc/fmri/assignment
    pickles after the common-session filter (`CRASH_loader.py:334-373`).
    Returns ``{name: path}``."""
    ids = get_comn_ids(base_dir)
    eeg = get_eeg(base_dir, ids)
    sc = get_sc(base_dir, ids, num_region)
    fmri = get_fmri(base_dir, ids, num_region)
    eeg, fmri, sc = common_sessions(eeg, fmri, sc, ids)
    assignment = get_region_assignment(base_dir, num_region, k=k)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, obj in (("eeg", eeg), ("sc", sc), ("fmri", fmri),
                      ("assignment", assignment)):
        path = os.path.join(out_dir, f"{name}.pkl")
        with open(path, "wb") as handle:
            pickle.dump(obj, handle, protocol=pickle.HIGHEST_PROTOCOL)
        paths[name] = path
    return paths
