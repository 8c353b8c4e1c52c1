"""The benchmark's own count of a Graph WaveNet step's work, from the
configuration's widths, the batch and the supports' live blocks: every
matrix product of the forward pass and, for a training step, of its
backward (the adaptive support's weight cotangent included). Elementwise
work (activations, normalization, the softmax, the loss, the optimizer)
is not counted. The count is the same whatever kernel runs a product.

``hop_units`` lists the block-sparse work the hand kernels are given, one
unit per support, layer and direction: an order-2 pair of diffusion hops
forward, its transpose backward, and each hop's weight cotangent for the
adaptive support. A unit's bytes read each input once and write each
output once; its least time on a card is the larger of its FLOPs over
the peak rate and its bytes over the peak bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def dilations(m: dict) -> list[int]:
    out = []
    for _ in range(m["blocks"]):
        d = 1
        for _ in range(m["layers"]):
            out.append(d)
            d *= 2
    return out


def layer_steps(m: dict, train: bool) -> tuple[int, list[int], int]:
    """(steps after padding, each layer's output steps, final steps). A
    training input is first padded by one step, as the reference trainer
    pads it; both are then padded to the receptive field."""
    t = 1 + (m["kernel_size"] - 1) * sum(dilations(m))
    t = max(t, m["seq_length"] + (1 if train else 0))
    t_in = t
    outs = []
    for d in dilations(m):
        t -= d * (m["kernel_size"] - 1)
        outs.append(t)
    return t_in, outs, t


@dataclass
class Work:
    flops: float = 0.0
    hop_units: list = field(default_factory=list)   # (kind, flops, bytes)

    def least_s(self, peak_flops: float, peak_bytes_s: float) -> float:
        return sum(max(f / peak_flops, b / peak_bytes_s)
                   for _, f, b in self.hop_units)


def _mm(rows: int, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def step_work(cfg: dict, graph: dict, batch: int, train: bool) -> Work:
    """The work of one step (``train``) or one forward of ``batch``
    windows. ``graph``: ``nodes``, and either ``block_size`` with
    ``live_blocks`` (one count per fixed support) and
    ``adaptive_live_blocks``, or dense supports."""
    m = cfg["model"]
    e = DTYPE_BYTES[cfg["precision"]["activations"]]
    n = graph["nodes"]
    c_res, c_dil = m["residual_channels"], m["dilation_channels"]
    order, k = m["diffusion_order"], m["kernel_size"]
    t_in, t_outs, t_fin = layer_steps(m, train)
    block = "block_size" in graph
    live = list(graph["live_blocks"]) if block else [None] * m["n_supports"]
    adaptive = m["gcn_bool"] and m["addaptadj"]
    if adaptive:
        live.append(graph["adaptive_live_blocks"] if block else None)
    bs = graph.get("block_size")
    n_sup = len(live)
    w = Work()
    bwd = 2.0 if train else 0.0

    def mm(rows, ci, co, grad_input=True):
        f = _mm(rows, ci, co)
        w.flops += f * (1 + (bwd if grad_input else bwd / 2))

    def hop_flops(lb, r):
        return 2.0 * lb * bs * bs * r if block else 2.0 * n * n * r

    mm(batch * t_in * n, m["in_dim"], c_res, grad_input=False)
    if adaptive:
        r = m["adapt_rank"]
        f = 2.0 * (graph["adaptive_live_blocks"] * bs * bs if block
                   else n * n) * r
        w.flops += f * (1 + bwd)
    last = len(t_outs) - 1
    for i, t in enumerate(t_outs):
        rows = batch * t * n
        mm(rows, c_res, 2 * c_dil * k)                  # filter and gate
        mm(batch * t_fin * n, c_dil, m["skip_channels"])
        if not m["gcn_bool"]:
            mm(rows, c_dil, c_res)                      # residual 1x1
            continue
        r = batch * t * c_dil
        back = train and i != last       # the last layer's diffusion
        for s, lb in enumerate(live):    # output reaches no loss term
            is_adp = adaptive and s == n_sup - 1
            h = hop_flops(lb, r)
            w.flops += order * h
            act = n * r * e
            blk = lb * bs * bs * e if block else 0
            if block:
                w.hop_units.append(("forward", order * h,
                                    act + blk + order * act))
            if back:
                w.flops += order * h * (2 if is_adp else 1)
                if block:
                    w.hop_units.append(("transpose", order * h,
                                        (order + 1) * act + blk))
                    if is_adp:
                        w.hop_units += [("cotangent", h, 2 * act + blk)
                                        ] * order
        proj = _mm(rows, (order * n_sup + 1) * c_dil, c_res)
        w.flops += proj * (1 + (2.0 if back else 0.0))
    rows = batch * t_fin * n
    mm(rows, m["skip_channels"], m["end_channels"])
    mm(rows, m["end_channels"], m["out_dim"])
    return w

