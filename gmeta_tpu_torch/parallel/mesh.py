"""The rank mesh over torch.distributed.

Counterpart of gmeta_tpu/parallel/mesh.py. JAX runs one controller over a
(task, edge) grid of devices; here each device is one process (a rank),
launched by `torchrun` or `launch.spawn_ranks`, and the grid is laid out as
the JAX package lays out its devices (`devices[:task*edge].reshape(task,
edge)`): rank r sits at task index t = r // edge and edge index
e = r % edge, edge innermost. Axes:
  - 'task': data-parallel over the meta-batch (the meta-gradient is summed
    over it);
  - 'edge': the edge-partitioned full-graph engine's shards
    (parallel/edgepart_train.py), which exchange halo rows.
Each rank holds three process groups: the world, its EDGE group (the ranks
of its task index, e = 0..edge-1 in order, so a rank's rank in that group
is e) and its TASK group (the ranks of its edge index, t = 0..task-1 in
order). The groups are made with `dist.new_group`, by every rank for every
group in the same order, as torch.distributed requires.

Every group has a finite timeout, so a collective that one rank never joins
fails instead of waiting forever.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# How long a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """This rank's place in the (task, edge) grid and its process groups.
    `device` is where the rank computes; collectives over a gloo group
    stage CUDA tensors through host memory (parallel/collectives.py)."""

    def __init__(self, task: int, edge: int, device, world, edge_group,
                 task_group):
        self.task, self.edge = task, edge
        self.rank = dist.get_rank()
        self.t, self.e = divmod(self.rank, edge)
        self.device = torch.device(device)
        self.world = world
        self.edge_group = edge_group
        self.task_group = task_group

    def barrier(self):
        """Every rank of the world has reached this point: an all-reduce of
        one element on the world's device (NCCL's own barrier guesses the
        device from the rank, which is wrong where --device pins ranks)."""
        x = torch.zeros((), device=comm_device(self.world, self.device))
        dist.all_reduce(x, group=self.world)
        x.item()

    def __repr__(self):
        return (f"Mesh(task={self.task}, edge={self.edge}, rank={self.rank}"
                f", t={self.t}, e={self.e}, device={self.device})")


def comm_device(group, device) -> torch.device:
    """Where a group's collectives take their tensors: the rank's device
    under NCCL, host memory under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device(device)
    return torch.device("cpu")


def make_mesh(task: int = 0, edge: int = 1, device="cpu",
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The (task, edge) mesh over the initialized world; task <= 0 fills
    the world (world // edge), as the JAX package's make_mesh does. The
    mesh must cover the world: every rank needs a place in it. Every rank
    must call this, in the same order as its other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    edge = max(edge, 1)
    world = dist.get_world_size()
    if task <= 0:
        task = world // edge
    if task * edge != world:
        raise ValueError(
            f"a mesh of task={task} x edge={edge} = {task * edge} ranks on a "
            f"world of {world}: {launch_hint(task * edge)}")
    edge_groups = [dist.new_group([t * edge + e for e in range(edge)],
                                  timeout=timeout) for t in range(task)]
    task_groups = [dist.new_group([t * edge + e for t in range(task)],
                                  timeout=timeout) for e in range(edge)]
    t, e = divmod(dist.get_rank(), edge)
    return Mesh(task, edge, device, dist.group.WORLD, edge_groups[t],
                task_groups[e])


def launch_hint(ranks: int) -> str:
    return (f"launch {ranks} ranks, e.g. torchrun --nproc_per_node {ranks} "
            f"-m gmeta_tpu_torch.run.train ..., so that each rank finds "
            f"RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT in "
            f"its environment")


def env_world() -> int:
    """The world size the launcher set (WORLD_SIZE), else 1."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(backend: str, device,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group unless one exists; returns whether this call
    created it. Counterpart of the JAX package's `init_multihost`.

    With RANK and WORLD_SIZE in the environment (torchrun, or
    launch.spawn_ranks) the ranks meet at MASTER_ADDR:MASTER_PORT. Without
    them this process is a world of one on an in-process store, so the
    collectives still run. Ends with the JAX package's check: an all-reduce
    of ones over the world equals its size."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if backend == "nccl":
        torch.cuda.set_device(device if device.index is not None
                              else torch.cuda.current_device())
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    one = torch.ones((), device=comm_device(None, device))
    dist.all_reduce(one)
    if int(one.item()) != dist.get_world_size():
        raise RuntimeError(f"the world's all-reduce of ones gave "
                           f"{one.item()}, not {dist.get_world_size()}")
    return True
