"""The port's CRASH pipeline held to the JAX package on the CPU: the
stand-in records, the temporal and spatial extensions, the region
assignment and communities, and ``load_dataset_crash`` (arrays,
``adj_idx``, per-split supports, graphs, F_t) equal the JAX package's for
one seed, exactly (numpy against numpy); ``crash_raw`` reads a synthetic
export tree in the reference's layout as the JAX copy does; and the
training CLI's ``--data crash`` branch runs end to end on stand-ins, on
``.npz`` records and on the export tree."""

import os
import pickle

import numpy as np
import pytest
import scipy.io as sio

from graph_wavenet_tpu.data import crash as jcrash
from graph_wavenet_tpu.data import crash_raw as jraw
from graph_wavenet_tpu_torch.data import crash as tcrash
from graph_wavenet_tpu_torch.data import crash_raw as traw

CPU = "cpu"
R, E, T_F, T_E = 8, 4, 30, 117     # regions, electrodes, fMRI, EEG lengths


def assert_same(got, want, path="root"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif hasattr(want, "__dataclass_fields__"):
        for k in want.__dataclass_fields__:
            assert_same(getattr(got, k), getattr(want, k), f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def test_stand_in_records_and_extensions_match_jax():
    rt = tcrash.synthetic_crash_records(rng=np.random.default_rng(4))
    rj = jcrash.synthetic_crash_records(rng=np.random.default_rng(4))
    assert_same(rt, rj)
    fmri, eeg = rt[0].fmri, rt[0].eeg.T
    assert_same(tcrash.temporal_extension(fmri, 2.6, 90),
                jcrash.temporal_extension(fmri, 2.6, 90))
    a = tcrash.region_assignment(20, 5)
    assert_same(a, jcrash.region_assignment(20, 5))
    assert_same(tcrash.spatial_extension(eeg, a, 20),
                jcrash.spatial_extension(eeg, a, 20))
    assert_same(tcrash.inverse_assignment(a), jcrash.inverse_assignment(a))
    assert_same(tcrash.region_communities(a, 20),
                jcrash.region_communities(a, 20))
    pts = np.random.default_rng(1).random((9, 3))
    assert tcrash.closest_idx(pts[0], pts, 3) == jcrash.closest_idx(
        pts[0], pts, 3)
    for seq in ([1, 2, 3], [1, 3, 4], [5]):
        assert (tcrash.check_arithmetic_progression(seq)
                == jcrash.check_arithmetic_progression(seq))


@pytest.mark.parametrize("resident", ["host", "device"])
def test_load_dataset_crash_matches_jax(resident):
    kw = dict(batch_size=4, seed=3, resident=resident)
    td, tsup, tft, tG = tcrash.load_dataset_crash(device=CPU, **kw)
    jd, jsup, jft, jG = jcrash.load_dataset_crash(**kw)
    assert tft == jft
    for k in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test",
              "train_adj_idx", "val_adj_idx", "test_adj_idx", "K",
              "n_communities"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert (td["scaler"].mean, td["scaler"].std) == (jd["scaler"].mean,
                                                     jd["scaler"].std)
    assert_same(tsup, jsup)
    for split in ("train", "val", "test"):
        for a, b in zip(tG[split], jG[split]):
            np.testing.assert_array_equal(a.W, b.W)
            np.testing.assert_array_equal(a.community_labels,
                                          b.community_labels)
        tl, jl = td[split + "_loader"], jd[split + "_loader"]
        tl.shuffle()
        jl.shuffle()
        for bt, bj in zip(tl.get_iterator(), jl.get_iterator()):
            for a, b in zip(bt, bj):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_crash_loader_warns_on_fpool_degradation(capsys):
    tcrash.load_dataset_crash(batch_size=2, fmri_time_res=2.0,
                              eeg_time_res=0.5, K=35, device=CPU)
    out = capsys.readouterr().out
    assert "F-pool factor degraded" in out and "multiple of 4" in out


# ---------------------------------------------------------------------------
# the export-tree reader on a synthetic tree
# ---------------------------------------------------------------------------

def write_tree(root, subjects=("01", "02", "03"), sessions=(1, 2), seed=0):
    """A tree in the reference's export layout and .mat key conventions,
    with the coordinate files of the region assignment."""
    rng = np.random.default_rng(seed)
    sc_key = traw.SC_KEY.format(R=R)
    for subj in subjects:
        for s in sessions:
            d = os.path.join(root, "eeg", subj, f"ses-s{s}_task", "eeg")
            os.makedirs(d, exist_ok=True)
            sio.savemat(os.path.join(d, "data.mat"),
                        {"data": rng.standard_normal((E, T_E))})
            d = os.path.join(root, "fmri", "matfiles", "sub-" + subj,
                             f"ses-{s}")
            os.makedirs(d, exist_ok=True)
            sio.savemat(os.path.join(d, f"sub_rest_{R}plus.mat"),
                        {"corrected_bold":
                         rng.standard_normal((T_F, R + 2))})
            d = os.path.join(root, "sc", "sub-" + subj, f"ses-{s}")
            os.makedirs(d, exist_ok=True)
            w = rng.random((R + 1, R + 1))
            sio.savemat(os.path.join(d, f"conn_{R}plus.mat"),
                        {sc_key: w + w.T})
    mni = os.path.join(root, "sc", "Parcellations", "MNI")
    os.makedirs(mni, exist_ok=True)
    rows = [[0, 0, 0, *(rng.standard_normal(3) * 10), label]
            for label in range(1, R + 1) for _ in range(2)]
    np.savetxt(os.path.join(
        mni, f"Schaefer2018_{R}Parcels_17Networks_order_FSLMNI152_2mm.txt"),
        np.asarray(rows))
    util = os.path.join(root, "utils", "eeg_coor_conv")
    os.makedirs(util, exist_ok=True)
    np.savetxt(os.path.join(util, "ny_x_z"),
               np.c_[np.arange(E), rng.standard_normal((E, 3)) * 10])


def test_crash_raw_reads_the_tree_as_jax_does(tmp_path):
    root = str(tmp_path / "raw")
    write_tree(root)
    os.makedirs(os.path.join(root, "eeg", "99", "ses-s1_x", "eeg"))
    ids = traw.get_comn_ids(root)
    assert ids == jraw.get_comn_ids(root) == ["01", "02", "03"]
    assert_same(traw.collect_records(root, num_region=R),
                jraw.collect_records(root, num_region=R))
    e2r = traw.get_region_assignment(root, R, k=3)
    assert_same(e2r, jraw.get_region_assignment(root, R, k=3))
    assert_same(traw.invert_assignment(e2r, R),
                jraw.invert_assignment(e2r, R))
    with pytest.raises(ValueError, match="no assigned electrode"):
        traw.invert_assignment({0: [0], 1: [0]}, 3)
    paths = traw.export_pickles(root, str(tmp_path / "out"), num_region=R)
    assert sorted(paths) == ["assignment", "eeg", "fmri", "sc"]
    with open(paths["assignment"], "rb") as f:
        assert_same(pickle.load(f), e2r)


def test_fmri_bold_and_slices_match_jax(tmp_path):
    """``get_fmri_bold`` pools a synthetic session's voxels per region and
    frame as the JAX copy does; ``show_slices`` saves its figure."""
    root = str(tmp_path)
    func = os.path.join(root, "fmri", "matfiles", "sub-01", "ses-1", "func")
    os.makedirs(func)
    open(os.path.join(func, "0_sub-01_rest_bold_MNI_3mm.nii.gz"),
         "wb").close()
    rng = np.random.default_rng(1)
    ts = rng.standard_normal((3, 3, 2, 5))
    atlas = rng.integers(0, 3, size=(3, 3, 2))
    got = traw.get_fmri_bold(root, ["01"], atlas, load_img=lambda p: ts)
    assert_same(got, jraw.get_fmri_bold(root, ["01"], atlas,
                                        load_img=lambda p: ts))
    np.testing.assert_array_equal(got["01"][1][1], ts[atlas == 2].mean(0))
    tcrash.show_slices([rng.random((6, 5))] * 2,
                       path=str(tmp_path / "s.png"))
    assert (tmp_path / "s.png").exists()


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

CLI = ["--data", "crash", "--nhid", "4", "--blocks", "2", "--batch_size",
       "4", "--epochs", "1", "--gcn_bool", "--addaptadj", "--device", CPU]


@pytest.mark.parametrize("source", ["stand_in", "npz", "mat"])
def test_train_cli_crash(tmp_path, capsys, source):
    from graph_wavenet_tpu_torch.cli import train

    argv = CLI + ["--save", str(tmp_path / "ck")]
    if source == "npz":
        for r in tcrash.synthetic_crash_records(
                n_subjects=3, rng=np.random.default_rng(0)):
            os.makedirs(tmp_path / "npz" / r.subject, exist_ok=True)
            np.savez(tmp_path / "npz" / r.subject / f"{r.session}.npz",
                     eeg=r.eeg, fmri=r.fmri, sc=r.sc)
        argv += ["--crash_dir", str(tmp_path / "npz"), "--crash_format",
                 "npz"]
    elif source == "mat":
        write_tree(str(tmp_path / "raw"))
        argv += ["--crash_dir", str(tmp_path / "raw"), "--crash_num_region",
                 str(R), "--fmri_time_res", "2.0", "--eeg_time_res", "0.5"]
    out = train.main(argv)
    res, runner = out["result"], out["runner"]
    assert np.isfinite(res.test_metrics["loss"])
    assert runner.engine.diff_g and runner.engine.model_cfg.out_dim == 20
    if source == "mat":
        assert "assignment from coordinate files" in capsys.readouterr().out
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no complete CRASH records"):
        train.main(CLI + ["--crash_dir", str(tmp_path / "empty"),
                          "--save", str(tmp_path / "x")])
