"""Parallel layouts over ``torch.distributed``: one process per rank, with
explicit collectives (the JAX package's single controller lets GSPMD place
them).

- ``multihost``: bring up the process group, the rank's device, a state
  broadcast from rank 0;
- ``mesh``: the (data x model x time) grid of ranks, its process groups,
  a rank's batch rows and node range;
- ``collectives``: the sum all-reduce (differentiable), the row
  all_gather, the two-neighbour exchange, the one-direction shift
  (differentiable) and the gradient all-reduce;
- ``sparse_tp``: node-TP of the flat block-sparse supports and of the
  block-masked adaptive adjacency (kernels 1 and 2 per shard);
- ``halo``: time-halo sequence parallelism of the dilated convs.

Every training path runs under data parallelism and under data x time,
the fused CUDA-graph steps included (their collectives and halo exchanges
captured on an NCCL group). Dense node-TP, model x time and the pipeline
wait for slices 7b.4 and 7b.5 of ROADMAP.md.
"""
