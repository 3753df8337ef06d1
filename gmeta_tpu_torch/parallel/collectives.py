"""Collectives with their autograd rules.

The JAX package has no counterpart file: inside `shard_map` its
collectives are differentiated by JAX itself. PyTorch's autograd knows
nothing of ranks, so each collective that a gradient crosses is a
`torch.autograd.Function` with the transpose written out:

- `all_reduce_sum(x, group)`: every rank gets the sum of the ranks' x. Its
  backward is the all-reduce (sum) of the cotangents. This is the transpose
  when each rank's output is its own variable, the convention of the
  edge-partitioned engine (parallel/edgepart_train.py): rank j's loss
  depends on its copy y_j of the sum, so d/dx_i = sum_j dL_j/dy_j.
- `all_to_all(x, group)` over a (D, M, ...) send buffer: rank d receives
  out[p] = x_p[d] from every rank p. It is a permutation of the rows across
  ranks, whose transpose is the reverse permutation: the same all-to-all
  of the cotangents.
Both backwards call the Functions again, so they are differentiable in
turn, as second-order MAML needs (`create_graph=True`). A group of one
rank skips the call (the identity), as the JAX engine statically skips the
one-shard halo.

Under gloo, CUDA tensors are staged through host memory (gloo's collectives
are for host tensors); that is how ranks that share one card meet. NCCL
takes them on the device. Counted (utils/metrics.py): under `SECONDS` the
host seconds spent in each kind of collective, waits included (exact where
the call blocks, gloo; the enqueue time under NCCL), under `CALLS` calls.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from gmeta_tpu_torch.utils.metrics import count

SECONDS = {k: f"{k}.seconds" for k in ("all_reduce", "all_to_all")}
CALLS = {k: f"{k}.calls" for k in SECONDS}


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of the ranks' x (no autograd)."""
    t0 = time.perf_counter()
    if _staged(x, group):
        buf = x.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(buf, group=group)
        out = buf.to(x.device)
    else:
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
    count(SECONDS["all_reduce"], time.perf_counter() - t0)
    count(CALLS["all_reduce"])
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x, on every rank of `group`, differentiable
    (backward: the all-reduce of the cotangents)."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _Pending:
    """The work handles of asynchronous all-to-alls and the host seconds
    spent starting them."""

    def __init__(self):
        self.works = []
        self.enqueue_s = 0.0

    def wait(self):
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        self.works = []
        count(SECONDS["all_to_all"],
              self.enqueue_s + time.perf_counter() - t0)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        count(CALLS["all_to_all"])
        t0 = time.perf_counter()
        if _staged(x, group):
            # gloo on CUDA tensors: through host memory, synchronously
            send = x.detach().to("cpu", copy=True).contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=group)
            out = recv.to(x.device)
        else:
            send = x.detach().contiguous()
            out = torch.empty_like(send)
            work = dist.all_to_all_single(out, send, group=group,
                                          async_op=pending is not None)
            if pending is not None:
                pending.works.append(work)
        dt = time.perf_counter() - t0
        if pending is not None:
            pending.enqueue_s += dt
        else:
            count(SECONDS["all_to_all"], dt)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group, None), None, None


def all_to_all_start(x: torch.Tensor, group):
    """Start the all-to-all of x (D, M, ...) over `group` (D ranks) without
    waiting: returns (out, wait). `out` must not be read before `wait()`
    returns. Differentiable; the backward's all-to-all is synchronous."""
    if dist.get_world_size(group) == 1:
        return x, lambda: None
    pending = _Pending()
    out = _AllToAll.apply(x, group, pending)
    return out, pending.wait


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """out[p] = x_p[me] for every rank p of `group`: the all-to-all of a
    (D, M, ...) send buffer, differentiable."""
    out, wait = all_to_all_start(x, group)
    wait()
    return out


def all_reduce_flat(tensors, group, differentiable: bool = False):
    """Sum a list of tensors over `group` as ONE flat buffer (one
    collective); returns new tensors of the same shapes. With
    `differentiable` the sum is `all_reduce_sum` (second-order MAML keeps
    it in the graph); otherwise the values are detached."""
    tensors = list(tensors)
    if dist.get_world_size(group) == 1:
        return tensors if differentiable else [t.detach() for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = (all_reduce_sum(flat, group) if differentiable
            else _all_reduce(flat, group))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def broadcast_(tensors, group, src: int = 0):
    """Overwrite every rank's tensors with global rank `src`'s, in one
    collective (no autograd)."""
    tensors = list(tensors)
    if dist.get_world_size(group) == 1 or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        if _staged(flat, group):
            buf = flat.cpu()
            dist.broadcast(buf, src=src, group=group)
            flat = buf.to(tensors[0].device)
        else:
            dist.broadcast(flat, src=src, group=group)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
