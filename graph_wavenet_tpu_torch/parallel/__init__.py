"""Parallel layouts over ``torch.distributed``: one process per rank, with
explicit collectives (the JAX package's single controller lets GSPMD place
them).

- ``multihost``: bring up the process group, the rank's device, a state
  broadcast from rank 0;
- ``mesh``: the (data x model x time) grid of ranks, its process groups,
  a rank's batch rows and node range;
- ``collectives``: the sum all-reduce, the row all_gather and
  reduce-scatter (all three differentiable), the two-neighbour exchange,
  the one-direction shift (differentiable) and the gradient all-reduce;
- ``dense_tp``: node-TP of the dense supports, per-sample stacks and the
  dense adaptive adjacency (the rank's rows; a reduce-scatter a hop);
- ``sparse_tp``: node-TP of the flat block-sparse supports and of the
  block-masked adaptive adjacency (kernels 1 and 2 per shard);
- ``halo``: time-halo sequence parallelism of the dilated convs.

Every training path runs under data x model x time, the fused CUDA-graph
steps included (their collectives and halo exchanges captured on an NCCL
group). The pipeline waits for slice 7b.5 of ROADMAP.md.
"""
