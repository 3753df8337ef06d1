"""Multi-rank training over torch.distributed: the mesh, the collectives
with their autograd rules, task data-parallelism and the edge-partitioned
full-graph engine."""
