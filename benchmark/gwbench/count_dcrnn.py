"""The benchmark's own count of a DCRNN train step's work (``count.py``'s
terms: every matrix product of the forward pass and of its backward,
elementwise work not counted; hop units for the hand kernels' least
time), from the configuration's widths, the batch and the supports' live
blocks, at the model's own widths (the program's zero-padded input
channels are not counted).

A cell's two graph convolutions (gate ``2U`` and candidate ``U`` wide)
each diffuse ``C = C_in + U`` channels of every sample, ``R = B C``
columns, by one order-2 pair per support: ``2 x 2 L bs^2 R`` FLOPs, one
hop unit forward and, where the pair's input needs a gradient, its
transpose backward. The projection of the ``(1 + 2 S) C`` features costs
``2 N B K F``, twice more backward (input and weight gradients). The
encoder's first cell convolves its gate over inputs that need no
gradient: there the backward takes only the projection's weight gradient,
as autograd runs it. The decoder adds its output projection every step.
"""

from __future__ import annotations

from gwbench.count import DTYPE_BYTES, Work


def step_work(cfg: dict, graph: dict, batch: int) -> Work:
    """The work of one train step on ``batch`` windows; ``graph``:
    ``nodes``, ``block_size`` and ``live_blocks`` (one count per fixed
    support), or dense supports (no ``block_size``)."""
    m = cfg["model"]
    e = DTYPE_BYTES[cfg["precision"]["activations"]]
    n, u = graph["nodes"], m["rnn_units"]
    block = "block_size" in graph
    live = (list(graph["live_blocks"])[:m["n_supports"]] if block
            else [None] * m["n_supports"])
    bs = graph.get("block_size")
    w = Work()

    def hop_pair(lb, r, back):
        f = 2.0 * (2.0 * lb * bs * bs * r if block else 2.0 * n * n * r)
        act = n * r * e
        blk = lb * bs * bs * e if block else 0
        w.flops += f * (2 if back else 1)
        if block:
            w.hop_units.append(("forward", f, act + blk + 2 * act))
            if back:
                w.hop_units.append(("transpose", f, 3 * act + blk))

    def gconv(c, f, back):
        r = batch * c
        for lb in live:
            hop_pair(lb, r, back)
        k = (1 + 2 * len(live)) * c
        w.flops += 2.0 * n * batch * k * f * (3 if back else 2)

    def cell(c_in, first):
        c = c_in + u
        gconv(c, 2 * u, back=not first)
        gconv(c, u, back=True)

    for t in range(m["seq_len"]):
        for i in range(m["num_rnn_layers"]):
            cell(m["input_dim"] if i == 0 else u, first=t == 0 and i == 0)
    for _ in range(m["horizon"]):
        for i in range(m["num_rnn_layers"]):
            cell(m["output_dim"] if i == 0 else u, first=False)
        w.flops += 2.0 * n * batch * u * m["output_dim"] * 3
    return w
