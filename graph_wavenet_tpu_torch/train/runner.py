"""Experiment runner: the epoch loop, a checkpoint per epoch, the best
model, and the per-horizon test.

Counterpart of ``graph_wavenet_tpu/train/runner.py`` on one device:
``Runner.fit`` and ``Runner.test`` for shared-graph datasets, and
``fit_syn_shared``/``test_syn_shared`` and ``fit_syn``/``test_syn`` for the
synthetic and CRASH tasks (below). Every epoch of ``fit`` shuffles the
training split and runs its steps through one of three feeds:

- a device-resident window loader (``resident_series``) with
  ``scan_steps`` > 1: ``Engine.train_steps_windows`` per superbatch of
  ``scan_steps`` steps, the leftover batches one ``train_step`` each;
- a device-resident array loader (``resident_arrays``) likewise, through
  ``Engine.train_steps_resident``;
- otherwise a ``train_step`` per batch, or ``train_step_accum`` under
  ``grad_accum`` > 1 (which the fused feeds refuse);

then the validation pass (one fused call over the split where the train
feed is fused), a line in ``save_dir/history.jsonl`` and a checkpoint with
the full train state, written on a thread under ``async_checkpoint`` and
pruned to the best ``keep_checkpoints``. ``early_stop_patience`` ends the
run after that many epochs without a new best validation loss;
``epoch_timeout_s`` arms a SIGALRM watchdog per epoch that writes
``emergency.json`` and raises :class:`DeviceWedgedError`; ``fit(...,
resume_from=path)`` restores a checkpoint's train state and continues at
its epoch + 1. After the last epoch the writes drain, the checkpoints are
pruned once more and the best-validation weights reload; the test scores
them per horizon on the real (unpadded) test samples. Step metrics stay on
the device until the end of the epoch. ``prefetch`` waits for its slice
(ROADMAP.md), and the runner refuses it.

Under a mesh (``Runner(engine, cfg, mesh=...)``, the engine's: DP, node-TP
and time SP, one process per rank) every rank runs the same loop on the same
shuffle: the engine takes its rows and node range of each global batch, and
the metrics it returns are global, so validation loss, best epoch, early
stop and resume decide the same on every rank. Rank 0 alone logs and writes
checkpoints, ``history.jsonl`` and ``emergency.json`` (the parameters are
replicated, so its checkpoint is the model); the others wait at a barrier
after each epoch's checkpoint, and after the last one take rank 0's best
weights by broadcast. A resume reads the checkpoint on every rank (a path
every rank can read). The test scores the rank's rows and nodes and sums
over the ranks (under time SP over the last rank of each time group, which
holds the predictions). The fused feeds (``scan_steps`` > 1) run under a
mesh too: every rank passes the same global index matrices (the loaders
shuffle alike from one seed) and the engine keeps its columns inside the
fused call; the barrier, the checkpoint writes and the final broadcast stay
between fused calls. A resident loader must hold its arrays on the mesh's
device (JAX: "mesh-replicated"), else ``fit`` raises a ``ValueError`` naming
both devices.

The two-modality tasks run the same epoch machinery (resume, early stop,
watchdog, asynchronous best-k checkpoints) over ``Engine.train_step_syn``
(or ``train_step_syn_accum``) and ``eval_step_syn``: the shared-graph one
with one graph's supports and cluster-mean projector, the per-sample-graph
(diff-G) one gathering each batch's supports and projectors from per-split
stacks by the batch's ``adj_idx``, and fusing ``scan_steps`` steps per
call on a device-resident loader (``train_steps_syn_resident``). Its test
scores against the test split's own graphs. Checkpoint sidecars record
``"diff_g"``. Under a mesh every rank runs the same loop on the same
batches and their gathered supports and projectors (``_gathered``), the
engine takes the rank's rows (and the model its nodes) of each and returns
global metrics; the test's pooled predictions are the ranks' rows and node
ranges gathered in order (under time SP the last time rank's of each time
group).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from graph_wavenet_tpu_torch.config import TrainConfig
from graph_wavenet_tpu_torch.parallel.collectives import all_gather_rows
from graph_wavenet_tpu_torch.parallel.dense_tp import gather_nodes
from graph_wavenet_tpu_torch.parallel.multihost import replicate_pytree
from graph_wavenet_tpu_torch.train import checkpoint as ckpt
from graph_wavenet_tpu_torch.train.engine import (
    Engine,
    cluster_mean_projector,
)
from graph_wavenet_tpu_torch.train.metrics import metric


class DeviceWedgedError(RuntimeError):
    """An epoch ran longer than ``TrainConfig.epoch_timeout_s``. The runner
    writes ``save_dir/emergency.json`` first; restart with ``resume_from=``
    the last epoch's checkpoint (it holds the full train state)."""


@contextlib.contextmanager
def _epoch_watchdog(timeout_s: float, epoch: int):
    """SIGALRM stall detector around one epoch, armed only in the main
    thread of a platform with ``setitimer`` (a no-op elsewhere). CPython
    runs a signal handler between bytecodes, so the alarm fires when the
    epoch loop next runs Python (between steps, in a host wait that polls);
    one C-level wait that never returns cannot be interrupted in-process,
    and needs a supervisor outside plus ``resume_from=``."""
    usable = (timeout_s > 0 and hasattr(signal, "setitimer")
              and threading.current_thread() is threading.main_thread())
    if not usable:
        yield
        return

    def fire(signum, frame):
        # re-arm first: if this raise is swallowed inside C code, the next
        # alarm retries; the finally below disarms once it propagates
        signal.setitimer(signal.ITIMER_REAL, max(timeout_s, 1.0))
        raise DeviceWedgedError(
            f"epoch {epoch} exceeded {timeout_s}s; the device appears "
            "wedged; restart with resume_from= the last epoch checkpoint")

    prev = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, timeout_s)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev)


def _epoch_mean(steps: list[dict]) -> dict:
    """Mean of each metric over step-metric dicts with one device sync.
    An entry is a scalar (one step) or an (S,) vector (a fused call of S
    steps); every step weighs the same."""
    if not steps:
        return {}
    stacked = torch.stack([
        torch.cat([s[k].reshape(-1) for s in steps]) for k in steps[0]])
    host = stacked.cpu().double().numpy()
    return {k: float(np.mean(host[i])) for i, k in enumerate(steps[0])}


@dataclass
class EpochLog:
    epoch: int
    train: dict
    valid: dict
    train_time: float
    valid_time: float


@dataclass
class RunResult:
    history: list[EpochLog] = field(default_factory=list)
    best_epoch: int = -1
    best_val_loss: float = float("inf")
    best_checkpoint: str = ""
    test_metrics: dict = field(default_factory=dict)
    per_horizon: list[tuple[float, float, float]] = field(
        default_factory=list)


def _print_flush(*args, **kwargs):
    print(*args, flush=True, **kwargs)


class Runner:
    """Drives an :class:`Engine` over a dataset dict of
    :func:`data.metr.load_dataset`. ``extra_meta``: JSON records merged
    into every checkpoint sidecar's ``extra`` (the city node layout).
    ``mesh``: the engine's mesh (module docstring)."""

    def __init__(self, engine: Engine, train_cfg: TrainConfig,
                 log_fn=_print_flush, extra_meta: dict | None = None,
                 mesh=None):
        if train_cfg.prefetch > 0:
            raise NotImplementedError(
                "TrainConfig.prefetch > 0: the host prefetch pipeline is not "
                "ported (ROADMAP.md); the device-resident loaders "
                "(resident='device') need none")
        mesh = engine.mesh if mesh is None else mesh
        if mesh is not engine.mesh:
            raise ValueError("Runner(mesh=) must be the engine's mesh")
        self.engine = engine
        self.cfg = train_cfg
        self.mesh = mesh
        # rank 0 logs and writes; the others compute the same decisions
        self.lead = mesh is None or mesh.rank == 0
        self.log = log_fn if self.lead else (lambda *a, **k: None)
        self.extra_meta = extra_meta or {}
        self._ckpt_scores: dict[str, float] = {}
        self._ckpt_writer = (ckpt.AsyncCheckpointer()
                             if train_cfg.async_checkpoint and self.lead
                             else None)

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _check_resident(self, data: dict) -> None:
        """Under a mesh the fused feeds gather inside the engine from the
        loaders' resident arrays: they must sit on the mesh's device
        (JAX's ``_fused_mesh_args``)."""
        if self.mesh is None or self.cfg.scan_steps <= 1:
            return
        for name in ("train_loader", "val_loader"):
            loader = data.get(name)
            for attr in ("resident_arrays", "resident_series"):
                if hasattr(loader, attr):
                    dev = getattr(loader, attr)()[0].device
                    if dev != self.mesh.device:
                        raise ValueError(
                            f"{name}'s resident arrays are on {dev}, but "
                            f"the mesh's device is {self.mesh.device}: "
                            "the fused steps under a mesh need the loaders "
                            "built on the rank's device (load_dataset(..., "
                            "device=mesh.device))")

    def _train_epoch(self, loader, supports) -> list[dict]:
        """One epoch's train steps through the loader's feed (see the
        module docstring); their metrics, on the device."""
        engine = self.engine
        scan = self.cfg.scan_steps
        steps = []
        if scan > 1 and hasattr(loader, "resident_series"):
            sx, sy = loader.resident_series()
            for sel in loader.superbatches(scan):
                steps.append(engine.train_steps_windows(
                    sx, sel, loader.window, loader.horizon, loader.y_start,
                    supports, y_series=sy))
        elif scan > 1 and hasattr(loader, "resident_arrays"):
            xs, ys = loader.resident_arrays()
            for sel in loader.superbatches(scan):
                steps.append(engine.train_steps_resident(xs, ys, sel,
                                                         supports))
        else:
            accum = self.cfg.grad_accum
            for it, (x, y) in enumerate(loader.get_iterator()):
                m = (engine.train_step_accum(x, y, supports, accum)
                     if accum > 1 else engine.train_step(x, y, supports))
                steps.append(m)
                if it % self.cfg.print_every == 0:
                    mm = _epoch_mean([m])
                    self.log(f"Iter: {it:03d}, Train Loss: {mm['loss']:.4f}, "
                             f"Train MAPE: {mm['mape']:.4f}, Train RMSE: "
                             f"{mm['rmse']:.4f}")
            return steps
        for x, y in loader.remainder_batches(scan):
            steps.append(engine.train_step(x, y, supports))
        return steps

    def _eval_split(self, loader, supports) -> list[dict]:
        """Eval metrics over a split: one fused call over the whole split
        where the train feed is fused and the loader device-resident."""
        engine = self.engine
        if self.cfg.scan_steps > 1 and hasattr(loader, "resident_series"):
            sx, sy = loader.resident_series()
            sel = next(loader.superbatches(loader.num_batch))
            return [engine.eval_steps_windows(
                sx, sel, loader.window, loader.horizon, loader.y_start,
                supports, y_series=sy)]
        if self.cfg.scan_steps > 1 and hasattr(loader, "resident_arrays"):
            xs, ys = loader.resident_arrays()
            sel = next(loader.superbatches(loader.num_batch))
            return [engine.eval_steps_resident(xs, ys, sel, supports)]
        return [engine.eval_step(x, y, supports)
                for x, y in loader.get_iterator()]

    def fit(self, data: dict, supports,
            resume_from: str | None = None) -> RunResult:
        """The epoch loop. ``resume_from``: a checkpoint of this run's
        configuration whose full train state (weights, BatchNorm buffers,
        Adam, step, dropout generator) is restored; the run continues at
        its epoch + 1."""
        if (self.cfg.grad_accum > 1 and self.cfg.scan_steps > 1
                and hasattr(data["train_loader"], "superbatches")):
            raise ValueError(
                "grad_accum > 1 does not combine with the fused multi-step "
                "feed (scan_steps > 1 on a device-resident loader); set "
                "scan_steps=1 to accumulate")
        self._check_resident(data)
        return self._epochs(
            data, lambda loader: self._train_epoch(loader, supports),
            lambda loader: self._eval_split(loader, supports), resume_from)

    def _epochs(self, data: dict, train_epoch, eval_split,
                resume_from: str | None) -> RunResult:
        """The epoch loop of every task: ``train_epoch(loader)`` runs an
        epoch's steps and ``eval_split(loader)`` the validation pass, each
        returning step metrics on the device; then the history line, the
        checkpoint, early stopping and the watchdog."""
        result = RunResult()
        start_epoch = self._resume(resume_from)
        for epoch in range(start_epoch, self.cfg.epochs + 1):
            try:
                with _epoch_watchdog(self.cfg.epoch_timeout_s, epoch):
                    t1 = time.time()
                    loader = data["train_loader"]
                    loader.shuffle()
                    train_m = _epoch_mean(train_epoch(loader))
                    t2 = time.time()      # after the sync: the real time
                    valid_m = _epoch_mean(eval_split(data["val_loader"]))
                    log = EpochLog(epoch, train_m, valid_m, t2 - t1,
                                   time.time() - t2)
                    result.history.append(log)
                    self._log_epoch_jsonl(log)
                    self.log(f"Epoch: {epoch:03d}, Train Loss: "
                             f"{train_m['loss']:.4f}, Valid Loss: "
                             f"{valid_m['loss']:.4f}, Training Time: "
                             f"{log.train_time:.4f}/epoch")
                    self._save_epoch(epoch, valid_m["loss"], result)
                    patience = self.cfg.early_stop_patience
                    if (patience > 0 and result.best_epoch > 0
                            and epoch - result.best_epoch >= patience):
                        self.log(f"early stop at epoch {epoch}: no val "
                                 f"improvement for {patience} epochs "
                                 f"(best epoch {result.best_epoch})")
                        break
            except DeviceWedgedError as e:
                self._emergency_dump(result, epoch, str(e))
                raise
        self._finalize_best(result)
        return result

    def test(self, data: dict, supports, result: RunResult | None = None,
             return_predictions: bool = False) -> RunResult:
        """Per-horizon test: predictions are truncated to the real test
        count, inverse-transformed by the engine's scaler and scored per
        horizon step. ``return_predictions``: also keep the standardized
        predictions (n, N, H) as ``test_metrics["yhat"]``, a numpy array."""
        result = result or RunResult()
        engine = self.engine
        loader = data["test_loader"]
        outputs, ids = [], []
        for i, (x, _) in enumerate(loader.get_iterator()):
            outputs.append(engine.predict_step(x, supports)[:, 0])
            ids.append(i * loader.batch_size
                       + engine.batch_rows(loader.batch_size))
        # the rank's real (unpadded) test samples, in model node order and
        # its node range: (n, N, H)
        y_test = data["y_test"]
        ids = np.concatenate(ids)
        keep = ids < y_test.shape[0]
        y_real = y_test[ids[keep]][..., 0]
        if (self.mesh is not None
                and y_real.shape[2] == engine.model_cfg.num_nodes):
            lo, hi = self.mesh.node_range(y_real.shape[2])
            y_real = y_real[:, :, lo:hi]
        realy = torch.as_tensor(np.transpose(y_real, (0, 2, 1)),
                                device=engine.device)
        yhat = torch.cat(outputs)[torch.as_tensor(keep,
                                                  device=engine.device)]
        world = None if self.mesh is None else self.mesh.world
        per_h = []
        for h in range(yhat.shape[-1]):
            pred = engine.scaler.inverse_transform(yhat[:, :, h])
            scores = torch.stack(metric(pred, realy[:, :, h], world,
                                        engine.holds_output)).cpu().tolist()
            per_h.append(tuple(scores))
            self.log(f"Evaluate best model on test data for horizon "
                     f"{h + 1:d}, Test MAE: {scores[0]:.4f}, Test MAPE: "
                     f"{scores[1]:.4f}, Test RMSE: {scores[2]:.4f}")
        result.per_horizon = per_h
        result.test_metrics = {
            name: float(np.mean([m[i] for m in per_h]))
            for i, name in enumerate(("mae", "mape", "rmse"))}
        if return_predictions:
            result.test_metrics["yhat"] = yhat.cpu().numpy()
        self.log("On average over seq_length horizons, Test MAE: "
                 f"{result.test_metrics['mae']:.4f}, Test MAPE: "
                 f"{result.test_metrics['mape']:.4f}, Test RMSE: "
                 f"{result.test_metrics['rmse']:.4f}")
        return result

    # ------------------------------------------------------------------
    # the synthetic two-modality tasks
    # ------------------------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32,
                               device=self.engine.device)

    def _syn_step(self, x, y, sup, proj, F_t: int) -> dict:
        accum = self.cfg.grad_accum
        if accum > 1:
            return self.engine.train_step_syn_accum(x, y, sup, proj, F_t,
                                                    accum)
        return self.engine.train_step_syn(x, y, sup, proj, F_t)

    @staticmethod
    def _scalars(ev: dict) -> dict:
        # the pooled predictions would pin a split's outputs all epoch
        return {k: ev[k] for k in ("loss", "mape", "rmse")}

    def fit_syn_shared(self, data: dict, supports, G, F_t: int,
                       n_communities: int,
                       resume_from: str | None = None) -> RunResult:
        """The epoch loop of the shared-graph synthetic task: one graph
        ``G`` for every sample, its supports (or ``[]``/None) and its
        cluster-mean projector; a step per batch (``grad_accum`` applies),
        as in the reference package."""
        sup = self._shared_supports(supports)
        proj = self._dev(cluster_mean_projector(G.community_labels,
                                                n_communities))
        engine = self.engine

        def train_epoch(loader):
            return [self._syn_step(b[0], b[1], sup, proj, F_t)
                    for b in loader.get_iterator()]

        def eval_split(loader):
            return [self._scalars(engine.eval_step_syn(b[0], b[1], sup, proj,
                                                       F_t))
                    for b in loader.get_iterator()]

        return self._epochs(data, train_epoch, eval_split, resume_from)

    def test_syn_shared(self, data: dict, supports, G, F_t: int,
                        n_communities: int,
                        result: RunResult | None = None) -> RunResult:
        """The shared-graph synthetic test: the mean eval metrics over the
        test split."""
        result = result or RunResult()
        sup = self._shared_supports(supports)
        proj = self._dev(cluster_mean_projector(G.community_labels,
                                                n_communities))
        steps = [self._scalars(self.engine.eval_step_syn(b[0], b[1], sup,
                                                         proj, F_t))
                 for b in data["test_loader"].get_iterator()]
        result.test_metrics = _epoch_mean(steps)
        self._log_test(result.test_metrics)
        return result

    def _shared_supports(self, supports):
        return (None if supports is None
                else [self._dev(s) for s in supports])

    def _split_stacks(self, supports_by_split: dict, graphs_by_split: dict,
                      n_communities: int) -> tuple[dict, dict]:
        """Per split: the supports' (n_graphs, N, N) stacks (None for the
        temporal-only model) and the graphs' cluster-mean projectors, on
        the device once for the run."""
        sup = {k: None if v is None else [self._dev(s) for s in v]
               for k, v in supports_by_split.items()}
        proj = {k: self._dev(np.stack(
            [cluster_mean_projector(g.community_labels, n_communities)
             for g in v])) for k, v in graphs_by_split.items()}
        return sup, proj

    def _gathered(self, sup, proj, adj_idx):
        """The supports and projector of the graphs of a batch's rows (the
        engine takes this rank's rows of them)."""
        idx = torch.as_tensor(np.asarray(adj_idx),
                              device=self.engine.device).long()
        return (None if sup is None else [s.index_select(0, idx)
                                          for s in sup],
                proj.index_select(0, idx))

    def fit_syn(self, data: dict, supports_by_split: dict,
                graphs_by_split: dict, F_t: int, n_communities: int,
                resume_from: str | None = None) -> RunResult:
        """The epoch loop of the per-sample-graph (diff-G) task: every
        batch gathers its samples' supports and projectors from the split's
        stacks. With ``scan_steps`` > 1 on a device-resident loader the
        epoch runs ``Engine.train_steps_syn_resident`` per superbatch (the
        gathers inside the fused call) and the leftover batches one step
        each; ``grad_accum`` > 1 runs ``train_step_syn_accum`` (not with
        the fused feed)."""
        if self.cfg.grad_accum > 1 and self.cfg.scan_steps > 1:
            raise ValueError(
                "grad_accum > 1 does not combine with the fused multi-step "
                "feed (scan_steps > 1); set scan_steps=1 to accumulate")
        self._check_resident(data)
        sup, proj = self._split_stacks(supports_by_split, graphs_by_split,
                                       n_communities)
        engine = self.engine
        scan = self.cfg.scan_steps

        def train_epoch(loader):
            steps = []
            batches = loader.get_iterator()
            if scan > 1 and hasattr(loader, "resident_arrays"):
                xs, ys = loader.resident_arrays()
                adj = loader.resident_adj_idx()
                for sel in loader.superbatches(scan):
                    steps.append(engine.train_steps_syn_resident(
                        xs, ys, sel, adj, sup["train"], proj["train"], F_t))
                batches = loader.remainder_batches(scan)
            for x, y, adj_idx in batches:
                steps.append(self._syn_step(
                    x, y, *self._gathered(sup["train"], proj["train"],
                                          adj_idx), F_t))
            return steps

        def eval_split(loader):
            return [self._scalars(engine.eval_step_syn(
                x, y, *self._gathered(sup["val"], proj["val"], adj_idx),
                F_t)) for x, y, adj_idx in loader.get_iterator()]

        return self._epochs(data, train_epoch, eval_split, resume_from)

    def test_syn(self, data: dict, supports_by_split: dict,
                 graphs_by_split: dict, F_t: int, n_communities: int,
                 result: RunResult | None = None) -> RunResult:
        """The diff-G test against the test split's own graphs (the
        reference evaluated against the validation graphs). Besides the
        mean metrics, ``test_metrics`` keeps the pooled predictions
        ``pred_F``/``pred_E`` (n, N, K) and the targets ``reals`` (n, K,
        N, 2) as numpy arrays, for sequence reconstruction."""
        result = result or RunResult()
        sup, proj = self._split_stacks(
            {"test": supports_by_split["test"]},
            {"test": graphs_by_split["test"]}, n_communities)
        steps, reals, pred_fs, pred_es = [], [], [], []
        for x, y, adj_idx in data["test_loader"].get_iterator():
            ev = self.engine.eval_step_syn(
                x, y, *self._gathered(sup["test"], proj["test"], adj_idx),
                F_t)
            steps.append(self._scalars(ev))
            reals.append(np.asarray(y.cpu() if torch.is_tensor(y) else y))
            # the ranks' rows of the batch, in order: the whole batch
            pred_fs.append(self._all_rows(ev["pred_F"][:, 0]).cpu().numpy())
            pred_es.append(self._all_rows(ev["pred_E"][:, 0]).cpu().numpy())
        result.test_metrics = _epoch_mean(steps)
        result.test_metrics.update(pred_F=np.concatenate(pred_fs),
                                   pred_E=np.concatenate(pred_es),
                                   reals=np.concatenate(reals))
        self._log_test(result.test_metrics)
        return result

    def _all_rows(self, a: torch.Tensor) -> torch.Tensor:
        """A batch's (B, N, ...) predictions from every rank: the model
        ranks' node ranges in order (``dense_tp.gather_nodes``), then the
        data ranks' rows in order (consecutive shares), under time SP those
        of the last time rank of each time group, which hold the
        predictions."""
        mesh = self.mesh
        if mesh is None:
            return a
        a = gather_nodes(a, mesh, 1, self.engine.model_cfg.num_nodes)
        rows = all_gather_rows(a, mesh.world).unflatten(
            0, (mesh.data, mesh.model, mesh.time, a.shape[0]))
        return rows[:, 0, -1].flatten(0, 1)

    def _log_test(self, m: dict) -> None:
        self.log("On average over seq_length horizons, Test MAE: "
                 f"{m['loss']:.4f}, Test MAPE: {m['mape']:.4f}, Test RMSE: "
                 f"{m['rmse']:.4f}")

    def _emergency_dump(self, result: RunResult, epoch: int,
                        reason: str) -> None:
        """Diagnostics of a wedged run, written without touching the
        device: the epoch history and the last complete checkpoint (rank 0
        only)."""
        if not self.lead:
            return
        if self._ckpt_writer is not None:
            try:
                # the queued states are on the host already; let their
                # writes land so the diagnostics point at whole files
                self._ckpt_writer.wait()
            except Exception as e:      # the dump must still be written
                self.log(f"checkpoint writer failed: {e!r}")
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        path = os.path.join(self.cfg.save_dir, "emergency.json")
        info = {
            "reason": reason,
            "epoch": epoch,
            "best_checkpoint": result.best_checkpoint,
            "best_val_loss": (result.best_val_loss
                              if np.isfinite(result.best_val_loss)
                              else None),
            "epochs_completed": len(result.history),
            "history_val_loss": [h.valid["loss"] for h in result.history],
        }
        with open(path, "w") as f:
            json.dump(info, f, indent=2)
        self.log(f"device wedged at epoch {epoch}; diagnostics -> {path}")

    def _resume(self, resume_from: str | None) -> int:
        """Restore the train state of ``resume_from`` (if given) and return
        the epoch to continue from; writes the run-start marker either
        way."""
        start_epoch = 1
        if resume_from:
            meta = ckpt.load_checkpoint(resume_from, self.engine)
            start_epoch = int(meta.get("extra", {}).get("epoch", 0)) + 1
            self.log(f"resumed from {resume_from} at epoch {start_epoch}")
        self._append_history({"run_start": time.time(),
                              "start_epoch": start_epoch,
                              "resumed_from": resume_from})
        return start_epoch

    def _append_history(self, rec: dict) -> None:
        if not self.lead:
            return
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        with open(os.path.join(self.cfg.save_dir, "history.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _log_epoch_jsonl(self, log: EpochLog) -> None:
        self._append_history({
            "epoch": log.epoch, "train": log.train, "valid": log.valid,
            "train_time_s": log.train_time, "valid_time_s": log.valid_time,
            "ts": time.time()})

    def _save_epoch(self, epoch: int, val_loss: float,
                    result: RunResult) -> None:
        engine = self.engine
        path = os.path.join(
            self.cfg.save_dir,
            f"exp{self.cfg.expid}_epoch_{epoch}_{round(val_loss, 2)}.pt")
        self._ckpt_scores[path] = val_loss
        if self.lead:
            meta = dict(model_cfg=engine.model_cfg, train_cfg=self.cfg,
                        scaler=engine.scaler,
                        extra={"epoch": epoch, "val_loss": val_loss,
                               # the serve and export CLIs pick the diff-G
                               # forecaster by this record
                               "diff_g": engine.diff_g, **self.extra_meta},
                        train_state=engine.train_state())
            if self._ckpt_writer is not None:
                self._ckpt_writer.save(path, engine.model.state_dict(),
                                       **meta)
            else:
                ckpt.save_checkpoint(path, engine.model.state_dict(), **meta)
            # 0 keeps every epoch's checkpoint, as the reference does; a
            # just-queued path whose write has not landed stays tracked
            # until a later prune (the last one runs in _finalize_best)
            if self.cfg.keep_checkpoints > 0:
                ckpt.prune_checkpoints(self.cfg.keep_checkpoints,
                                       self._ckpt_scores)
        self._barrier()
        if val_loss < result.best_val_loss:
            result.best_val_loss = val_loss
            result.best_epoch = epoch
            result.best_checkpoint = path

    def _finalize_best(self, result: RunResult) -> None:
        """Drain the checkpoint writes, prune once more, and reload the
        best-validation weights for the test."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
            if self.cfg.keep_checkpoints > 0:
                ckpt.prune_checkpoints(self.cfg.keep_checkpoints,
                                       self._ckpt_scores)
        if not result.best_checkpoint:
            return
        model = self.engine.model
        if self.lead and os.path.exists(result.best_checkpoint):
            model.load_state_dict(ckpt.load_state_dict(
                result.best_checkpoint, device=self.engine.device))
            self.log(f"The valid loss on best model is "
                     f"{result.best_val_loss:.4f}")
        # every rank takes rank 0's best weights (no shared file needed)
        replicate_pytree(model.state_dict(), self.mesh)
