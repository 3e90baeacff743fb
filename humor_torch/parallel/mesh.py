"""Data-parallel helpers over torch.distributed (port of
humor_tpu/parallel/mesh.py).

The port's parallelism is the JAX package's: data-parallel training over
the batch, and the test-time fit with its windows split over ranks. JAX
expresses both as shardings over a 1-D "dp" mesh and lets XLA insert the
collectives; here a `Mesh` is the initialised process group, each rank
holds its contiguous rows of every batch, and the collectives are called
by hand.

Only `all_reduce` is used: an all-gather is an all-reduce of a
zero-padded (W * B_local, ...) buffer. gloo takes CUDA tensors for
all_reduce and broadcast only, so this lets two ranks share one card
over gloo (NCCL refuses two ranks on one GPU). `all_reduce_sum` and `all_gather_batch` are
differentiable: the backward of a sum over ranks is the sum over ranks of
the cotangents, so a term that every rank computes from a gathered tensor
counts W times in the gradient; charge such a term on one rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D data-parallel group."""

    group: Any               # a ProcessGroup; None is the default group
    rank: int
    size: int
    device: torch.device     # where this rank computes


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over an initialised process group (the default group when
    `group` is None); raises when none is initialised, so that a sharded
    fit or a data-parallel trainer never quietly runs on one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process "
            "group (init_from_env under torchrun, or "
            "torch.distributed.init_process_group)")
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group),
                device=torch.device(device) if device is not None
                else _default_device())


def init_from_env(backend: Optional[str] = None, device=None) -> Mesh:
    """Initialise the default group from torchrun's variables (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return its mesh.
    The backend is NCCL on CUDA and gloo on the CPU; pass "gloo" to put
    several ranks on one card. On CUDA each rank's current device is
    cuda:LOCAL_RANK (modulo the cards present)."""
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = _default_device()
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return make_mesh(device=dev)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows [r*n/W, (r+1)*n/W) of an n-row batch; raises
    unless W divides n (as JAX's NamedSharding does)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, tree, batch_axis_index: int = 0):
    """This rank's rows of every tensor leaf of `tree` with more than
    `batch_axis_index` dims, along that axis (1 for k-stacked chunks);
    other leaves pass through."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, batch_axis_index)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, batch_axis_index)
                          for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > batch_axis_index:
        rows = local_rows(mesh, tree.shape[batch_axis_index])
        return tree.narrow(batch_axis_index, rows.start,
                           rows.stop - rows.start)
    return tree


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its backward sums the cotangents over ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over ranks, on every rank (differentiable)."""
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_max(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of `x` over ranks, on every rank."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group)
    return y


def all_gather_batch(mesh: Mesh, x: torch.Tensor, dim: int = 0
                     ) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order, on every
    rank: the batch axis rebuilt (differentiable; see the module note on
    gradients)."""
    n = x.shape[dim]
    pad = lambda k: x.new_zeros(*x.shape[:dim], k * n, *x.shape[dim + 1:])
    parts = [x]
    if mesh.rank:
        parts.insert(0, pad(mesh.rank))
    if mesh.size - 1 - mesh.rank:
        parts.append(pad(mesh.size - 1 - mesh.rank))
    return all_reduce_sum(mesh, torch.cat(parts, dim=dim))


def all_reduce_grad_mean(mesh: Mesh, grads: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """The mean over ranks of each gradient, in one all-reduce of their
    concatenation."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = flat / mesh.size
    out, o = [], 0
    for g in grads:
        out.append(flat[o:o + g.numel()].view_as(g))
        o += g.numel()
    return out
