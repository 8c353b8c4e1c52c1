"""GPipe pipeline parallelism over whole blocks of the WaveNet stack.

Counterpart of ``graph_wavenet_tpu/parallel/pipeline.py``
(``make_pipeline_mesh``, ``stack_stages``/``unstack_stages``,
``pipeline_apply``, ``make_pipeline_train_step``). JAX runs the stages as
one SPMD program under ``shard_map`` and lets ``jax.grad`` reverse its
``ppermute`` chain; the port runs one process per rank:

- the mesh is JAX's (data, pipe) grid (:func:`make_pipeline_mesh`,
  ``parallel.mesh``): stage ``p`` of data row ``d`` is rank ``d * S + p``;
  the stages are whole blocks, so every stage repeats one dilation
  schedule (:func:`_stage_dilations`);
- the batch is cut into ``n_micro`` micro-batches (a data rank takes the
  d-th share of each, ``Mesh.batch_rows``) that flow through ``n_micro +
  S - 1`` ticks: at tick t stage s runs its layers on micro-batch ``t -
  s`` and hands the activation, re-padded on the left to the stage-input
  width ``t0``, and the running skip sum to stage s+1, packed into one
  tensor, through the differentiable ``collectives.shift``. One exchange a
  tick, every rank in every tick, so every rank's backward runs the
  shifts' transposes in one order: the reverse ticks. A stage with no
  micro-batch in a tick (the bubble) passes what it holds on unchanged;
  the starting buffers require a gradient, so that every rank's shift of
  every tick but the last has a backward;
- a stage runs its layers on the valid tail of what it receives (the last
  ``t0 - s * delta`` steps; the prefix is the re-pad's zeros), at the
  single process's widths: its BatchNorm takes the statistics of exactly
  the single process's steps (JAX reaches the same with ``t_valid``),
  global over the stage's data ranks (``Mesh.data_group``), and each
  layer's dropout mask is the single process's, drawn before the ticks on
  every rank from one generator in ``Engine.train_step_accum``'s order
  (micro-batch by micro-batch, layer by layer, at the global shape; a rank
  keeps its rows of its stage's layers);
- BatchNorm's running statistics keep the last micro-batch's update, as
  ``train_step_accum``'s do, and each stage's are broadcast to the other
  stages of its data row, so every rank ends with every layer's;
- the last stage holds the output: every rank runs the head and the
  masked loss on what it collected (one program), and the ranks off the
  last stage contribute exact zeros (``masked_terms(holds=False)``), as
  under time SP. The last stage hands on its input, not its last layer's
  output, so that output reaches no gradient, as in one process;
- parameters are replicated: every rank holds all of them, computes the
  gradients of its stage's layers (and stage 0 of the start conv), and
  one all-reduce over the world sums them before one clip and one Adam
  step on every rank (JAX shards the stacked layers over pipe instead).

``cfg.remat`` recomputes a stage's tick in the backward
(``torch.utils.checkpoint``); the masks are arguments and the BatchNorm
statistics are folded in after the ticks, so a remat step equals a plain
one. The eval forward takes dense or block-sparse supports (on the card
the flat ones launch kernels 1 and 3 per stage); a training step takes
dense supports only, and the diff-G model, ``fresh_nodevec`` and a mesh
with model or time axes are refused, as in JAX. A step runs eagerly (JAX's
is a ``jit``; no CUDA graph captures it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from graph_wavenet_tpu_torch.config import MeshConfig, ModelConfig
from graph_wavenet_tpu_torch.ops.diffusion import (
    dropout_scale,
    is_dense,
    support_powers,
)
from graph_wavenet_tpu_torch.ops.temporal import (
    gated_tcn_apply,
    left_pad_time,
)
from graph_wavenet_tpu_torch.parallel import collectives
from graph_wavenet_tpu_torch.parallel.mesh import PIPE, Mesh, make_mesh

__all__ = ["PIPE", "make_pipeline_mesh", "make_pipeline_train_step",
           "pipeline_apply", "stack_stages", "unstack_stages"]


def make_pipeline_mesh(n_stages: int, device: torch.device | str = "cpu",
                       timeout_s: float = 600.0) -> Mesh:
    """This rank's (data, pipe) mesh: ``n_stages`` ranks on the pipe axis,
    the rest of the world on the data axis. Every rank calls it."""
    return make_mesh(MeshConfig(), device, timeout_s, pipe=n_stages)


def stack_stages(per_layer: list, n_stages: int):
    """A per-layer list of tensors (or of dicts of them) -> one tensor (or
    dict) whose leading axes are (n_stages, layers_per_stage)."""
    if len(per_layer) % n_stages:
        raise ValueError(f"{len(per_layer)} layers do not divide into "
                         f"{n_stages} stages")
    if isinstance(per_layer[0], dict):
        return {k: stack_stages([layer[k] for layer in per_layer], n_stages)
                for k in per_layer[0]}
    a = torch.stack([torch.as_tensor(t) for t in per_layer])
    return a.reshape(n_stages, len(per_layer) // n_stages, *a.shape[1:])


def unstack_stages(stacked, n_layers: int) -> list:
    """Inverse of :func:`stack_stages`: back to the per-layer list."""
    if isinstance(stacked, dict):
        parts = {k: unstack_stages(v, n_layers) for k, v in stacked.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n_layers)]
    return list(stacked.reshape(n_layers, *stacked.shape[2:]).unbind(0))


def _stage_dilations(cfg: ModelConfig, n_stages: int) -> list[int]:
    """The dilation schedule of one stage. Stages are whole blocks and
    every block repeats one schedule, so every stage's is the first's."""
    if cfg.blocks % n_stages:
        raise ValueError(f"blocks={cfg.blocks} must divide by n_stages="
                         f"{n_stages} (stages are whole blocks)")
    dils = cfg.dilations()
    lps = len(dils) // n_stages
    for s in range(n_stages):
        if dils[s * lps:(s + 1) * lps] != dils[:lps]:
            raise ValueError("stage dilation schedules differ: stages must "
                             "align with block boundaries")
    return dils[:lps]


def _check_mesh(mesh: Mesh) -> None:
    if mesh.model > 1 or mesh.time > 1:
        raise ValueError(
            f"the pipeline's mesh is (data, pipe): a model axis of "
            f"{mesh.model} and a time axis of {mesh.time} do not compose "
            "with it (make_pipeline_mesh)")


def _draw_masks(model, generator, mesh: Mesh, b: int, n_micro: int,
                t0: int) -> list:
    """Every layer's dropout mask of every micro-batch, drawn on every rank
    in ``train_step_accum``'s order at the global shape ``(b / n_micro,
    width, N, C)``: ``masks[i][g]`` is micro-batch i's mask of layer g,
    the rank's rows of it, or None for a layer of another stage."""
    cfg = model.cfg
    lps = len(cfg.dilations()) // mesh.pipe
    mine = range(mesh.pipe_index * lps, (mesh.pipe_index + 1) * lps)
    bm = b // n_micro
    share = bm // mesh.data
    lo = mesh.data_index * share
    dtype = _activation_dtype(cfg)
    masks = []
    for _ in range(n_micro):
        t_len, row = t0, []
        for g, dilation in enumerate(cfg.dilations()):
            t_len -= dilation * (cfg.kernel_size - 1)
            m = dropout_scale(generator, cfg.dropout,
                              (bm, t_len, cfg.num_nodes,
                               cfg.residual_channels), dtype, mesh.device)
            row.append(m[lo:lo + share] if g in mine else None)
        masks.append(row)
    return masks


def _activation_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def pipeline_apply(model, x: torch.Tensor, supports, *, mesh: Mesh,
                   n_micro: int, train: bool = False,
                   generator: torch.Generator | None = None
                   ) -> torch.Tensor:
    """The pipelined forward of a shared-graph :class:`models.gwnet.GWNet`
    (module docstring): ``GWNet.forward``'s contract, with x the global
    batch (B, T, N, in_dim) given to every rank, B divisible by ``n_micro``
    x the data axis. Returns the rank's rows (``mesh.batch_rows(B,
    n_micro)``) of the fp32 output; they are the output on the last stage
    only. In eval mode it equals the single-process forward; in train mode
    (``generator``: the dropout stream) each micro-batch's BatchNorm takes
    its own statistics and the running statistics keep the last one's
    update, ``Engine.train_step_accum``'s semantics."""
    return torch.cat(_pipeline(model, x, supports, mesh, n_micro, train,
                               generator))


def _pipeline(model, x, supports, mesh: Mesh, n_micro: int, train: bool,
              generator) -> list:
    """:func:`pipeline_apply`'s output, one tensor a micro-batch."""
    cfg = model.cfg
    _check_mesh(mesh)
    n_stages = mesh.pipe
    stage_dils = _stage_dilations(cfg, n_stages)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} must divide by n_micro={n_micro}")
    model.train(train)
    lps = len(stage_dils)
    s = mesh.pipe_index
    first, last = s == 0, s == n_stages - 1
    k1 = cfg.kernel_size - 1
    delta = k1 * sum(stage_dils)                 # a stage's time shrink
    x = mesh.shard_batch(x.to(mesh.device), n_micro)
    x = left_pad_time(x, cfg.receptive_field)
    t0 = x.shape[1]
    t_final = t0 - n_stages * delta
    supports = model._with_adaptive(supports)
    use_gcn = cfg.gcn_bool and supports is not None
    mode = cfg.resolved_gcn_mode
    stacks = None
    if (use_gcn and mode == "stacked" and supports
            and all(map(is_dense, supports))):
        stacks = [support_powers(a, cfg.diffusion_order) for a in supports]
    masks = None
    if train and use_gcn and cfg.dropout > 0.0:
        if generator is None:
            raise ValueError("training with dropout needs a generator")
        masks = _draw_masks(model, generator, mesh, b, n_micro, t0)
    dtype = _activation_dtype(cfg)
    bm = x.shape[0] // n_micro
    n, c_res = x.shape[2], cfg.residual_channels
    stats = [None] * lps

    def stage(h, skip, mb):
        """This stage's layers on micro-batch ``mb``: (activation, skip,
        BatchNorm statistics of each layer)."""
        t_len = h.shape[1]
        out_stats = []
        for j in range(lps):
            i = s * lps + j
            t_len -= stage_dils[j] * k1
            residual = h
            h = gated_tcn_apply(model.filter_convs[i], model.gate_convs[i],
                                h, stage_dils[j])
            skip = model.skip_convs[i](h[:, -t_final:]) + skip
            drop = None
            if use_gcn:
                h = model.gconv[i](h, supports, mode=mode, stacks=stacks)
                drop = None if masks is None else masks[mb][i]
            else:
                h = model.residual_convs[i](h)
            h, st = model.bn[i].tail(h, residual, drop, mesh.data_group)
            out_stats.append(st)
        return h, skip, out_stats

    grad = torch.is_grad_enabled()
    # every rank's buffers require a gradient, so every tick's shift has a
    # backward on every rank (module docstring)
    act = torch.zeros((bm, t0, n, c_res), dtype=dtype, device=mesh.device,
                      requires_grad=grad)
    skip = torch.zeros((bm, t_final, n, cfg.skip_channels), dtype=dtype,
                       device=mesh.device, requires_grad=grad)
    collected = []
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        mb = t - s
        if 0 <= mb < n_micro:
            if first:
                h = model.start_conv(x[mb * bm:(mb + 1) * bm].to(dtype))
            else:
                h = act[:, s * delta:]           # the valid tail
            if cfg.remat and grad:
                h, skip_out, st = checkpoint(stage, h, skip, mb,
                                             use_reentrant=False,
                                             preserve_rng_state=False)
            else:
                h, skip_out, st = stage(h, skip, mb)
            if mb == n_micro - 1:
                stats = st
            # the last stage hands on its input: its last layer's output
            # reaches no gradient, as in one process
            send = act if last else left_pad_time(h, t0)
        else:
            send, skip_out = act, skip
        if t >= n_stages - 1:
            collected.append(skip_out)
        if t < n_ticks - 1:
            packed = collectives.shift(
                torch.cat([send.reshape(-1), skip_out.reshape(-1)]),
                mesh.pipe_group, mesh.pipe_ranks)
            act = packed[:act.numel()].view(act.shape)
            skip = packed[act.numel():].view(skip.shape)
    if train:
        for j, st in enumerate(stats):
            if st is not None:
                model.bn[s * lps + j].track(*st)
        _share_running_stats(model, mesh, lps)
    return [model.end_conv_2(torch.relu(model.end_conv_1(torch.relu(sk))))
            .float() for sk in collected]


@torch.no_grad()
def _share_running_stats(model, mesh: Mesh, lps: int) -> None:
    """Every stage's layers' running statistics to every rank of its data
    row (one broadcast a stage); the batch counters all moved by one."""
    for p in range(mesh.pipe):
        layers = [model.bn[p * lps + j] for j in range(lps)]
        flat = torch.cat([torch.cat([bn.running_mean, bn.running_var])
                          for bn in layers])
        if mesh.pipe_group is not None:
            collectives.broadcast_(flat, mesh.pipe_ranks[p], mesh.pipe_group)
        if p == mesh.pipe_index:
            continue
        for bn, part in zip(layers, flat.chunk(lps)):
            c = bn.running_mean.numel()
            bn.running_mean.copy_(part[:c])
            bn.running_var.copy_(part[c:])
            bn.num_batches_tracked += 1


def make_pipeline_train_step(engine, mesh: Mesh, n_micro: int):
    """A pipeline-parallel training step for an :class:`train.engine.Engine`
    built without a mesh on the mesh's device: ``step(x, y, supports)``
    takes the global batch on every rank (x standardized, y raw, dense
    supports) and returns the metrics as device scalars. The plumbing of
    ``Engine.train_step_accum``: the mean of the micro-batches' masked-MAE
    losses (their gradients summed, then divided by ``n_micro``), one
    all-reduce of the gradients over the world, one clip and one Adam step;
    the metrics are the micro-batches' means. The engine keeps its layout,
    so checkpoints, eval and serving are unchanged."""
    from graph_wavenet_tpu_torch.train.engine import (
        METRICS,
        horizon_target,
    )
    from graph_wavenet_tpu_torch.train.metrics import (
        global_terms,
        masked_terms,
    )

    if engine.diff_g:
        raise ValueError(
            "pipeline parallelism supports the shared-graph gwnet only: "
            "the diff-G variant's per-sample supports are not wired into "
            "the pipelined stage")
    if engine.mesh is not None:
        raise ValueError("the pipeline step takes an engine without a "
                         "mesh; pass the pipeline's mesh to it")
    if mesh.device != engine.device:
        raise ValueError(f"the mesh's device {mesh.device} is not the "
                         f"engine's {engine.device}")
    _check_mesh(mesh)
    model = engine.model
    holds = mesh.pipe_index == mesh.pipe - 1

    def step(x, y, supports) -> dict:
        if supports is not None and not all(
                torch.is_tensor(a) for a in supports):
            raise ValueError(
                "pipeline training supports dense (N, N) supports only: "
                "the block-sparse supports' gradients are node-TP's work "
                "(parallel.sparse_tp); use dense supports here")
        x = torch.as_tensor(x, dtype=torch.float32, device=engine.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=engine.device)
        engine._set_lr()
        engine.optimizer.zero_grad(set_to_none=True)
        # the engine's one-step left pad, as in Engine._forward
        outs = _pipeline(model, F.pad(x, (0, 0, 0, 0, 1, 0)), supports,
                         mesh, n_micro, True, engine.generator)
        real = horizon_target(mesh.shard_batch(y, n_micro)).chunk(n_micro)
        scaler = engine.scaler
        loss, ms = 0.0, []
        for out, r in zip(outs, real):
            terms = masked_terms(out * scaler.std + scaler.mean, r, 0.0,
                                 mesh.world, holds)
            loss = loss + terms[0]
            ms.append(global_terms(*terms, mesh.world))
        loss.backward()
        params = list(model.parameters())
        _fill_grads(params, mesh)
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.div_(n_micro)
        collectives.all_reduce_grads(params, mesh.world)
        torch.nn.utils.clip_grad_norm_(params, engine.train_cfg.grad_clip)
        engine.optimizer.step()
        engine.step += 1
        m = torch.stack(ms).mean(0)
        return {k: m[i] for i, k in enumerate(METRICS)}

    return step


def _fill_grads(params: list, mesh: Mesh) -> None:
    """Give a zero gradient to every parameter that another rank's stage
    reached and this one's did not, so the ranks sum one set of gradients;
    a parameter that no rank's loss reaches keeps none (Adam skips it, as
    in one process)."""
    if mesh.world is None:
        return
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=mesh.device)
    collectives.all_reduce_(has, mesh.world)
    for p, h in zip(params, has.tolist()):
        if h and p.grad is None:
            p.grad = torch.zeros_like(p)
