"""The process group in place of the device mesh (counterpart of
`tak_tpu/parallel/mesh.py`).

The JAX package lays a `dp` mesh over every addressable device and lets
XLA place the rows; the PyTorch idiom is one process per card.  A `Mesh`
here is one rank of a `torch.distributed` process group, with its device:

  * `dp` — data/game parallelism: self-play game slots and learner batch
    rows are split into contiguous equal blocks, one per rank, in rank
    order (`shard_rows`, `gather_rows`); parameters are replicated
    (`replicate`) and gradients summed over the ranks.
  * `mp` stays 1, as in every caller of the JAX package.

Launch: `torchrun --nproc_per_node=G -m <entry> ...` sets `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`; `make_mesh`
reads them (or takes a group that already exists).  The backend is an
explicit choice: "nccl" for CUDA devices and "gloo" for the CPU by
default.  Nothing switches backend or device when one fails.

Gloo is a CPU backend (its CUDA support covers a few collectives): under
gloo every collective here runs on a host copy of the tensor, so that
gloo ranks may hold CUDA tensors, several ranks on one card included.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..types import GameState
from ..utils.device import resolve_device
from ..utils.profiling import span


@dataclass(frozen=True)
class Mesh:
    group: object          # torch.distributed ProcessGroup
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives run: the device under NCCL, the host
        under gloo."""
        return torch.device("cpu") if self.backend == "gloo" else self.device


def make_mesh(backend: str | None = None, device=None) -> Mesh:
    """This rank's `Mesh`: the default process group if one exists, else a
    new one from the torchrun environment (`env://`).

    `device` defaults to `cuda:LOCAL_RANK` (and raises without a card);
    `backend` defaults to "nccl" on CUDA and "gloo" on the CPU, and NCCL
    with a CPU device raises.  On CUDA the local rank 0 (the rank itself
    outside torchrun) builds the kernels first while the others wait at a
    barrier, so that cold ranks do not all run nvcc."""
    local_rank = os.environ.get("LOCAL_RANK")
    device = resolve_device(f"cuda:{local_rank or 0}" if device is None
                            else device)
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"backend {backend!r} requested but the process "
                             f"group runs {dist.get_backend()!r}")
        backend = dist.get_backend()
    else:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not "
                         f"{str(device)!r}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            if var not in os.environ:
                raise RuntimeError(
                    f"{var} is not set: launch with torchrun, or call "
                    "torch.distributed.init_process_group first")
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    mesh = Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                world=dist.get_world_size(), device=device, backend=backend)
    if device.type == "cuda":
        from ..kernels import build as kb

        if int(local_rank or mesh.rank) == 0:
            kb.build()
        barrier(mesh)
    return mesh


def barrier(mesh: Mesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def row_range(mesh: Mesh | None, rows: int) -> slice:
    """This rank's contiguous rows [rank*rows/W, (rank+1)*rows/W) of a
    batch of `rows`; all of them without a mesh.  Raises when W does not
    divide `rows`."""
    if mesh is None:
        return slice(0, rows)
    if rows % mesh.world:
        raise ValueError(f"{rows} rows do not split over {mesh.world} ranks "
                         "(workers and chunk rows must divide the world size)")
    per = rows // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_rows(mesh: Mesh | None, x):
    """This rank's rows of `x` (a tensor, numpy array or `GameState`, rows
    on the leading axis); `x` itself without a mesh."""
    if mesh is None:
        return x
    rows = x.heights.shape[0] if isinstance(x, GameState) else x.shape[0]
    return x[row_range(mesh, rows)]


def gather_rows(mesh: Mesh | None, x):
    """The inverse of `shard_rows`: every rank's rows of `x` (a tensor or
    `GameState`), concatenated in rank order, on every rank, on `x`'s
    device (`all_gather`); `x` itself without a mesh."""
    if mesh is None:
        return x
    if isinstance(x, GameState):
        return x.map(lambda t: gather_rows(mesh, t))
    kind = x.dtype
    t = x.to(mesh.comm_device)
    if kind == torch.bool:
        t = t.to(torch.uint8)
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts).to(device=x.device, dtype=kind)


def _all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the ranks (a new tensor on `t`'s device), inside a
    `mesh.all_reduce` span."""
    with span("mesh.all_reduce"):
        out = t.to(mesh.comm_device, copy=True).contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: each rank's gradient of a
    summed quantity is the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return _all_reduce(mesh, t)

    @staticmethod
    def backward(ctx, grad):
        return None, _all_reduce(ctx.mesh, grad)


def all_reduce_sum(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the ranks, with gradients; `t` without a mesh."""
    if mesh is None:
        return t
    return _AllReduceSum.apply(mesh, t)


def all_reduce_grads(mesh: Mesh | None, params) -> None:
    """Sum the `.grad` of `params` over the ranks in place, one collective
    for all of them (flattened)."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = _all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def replicate(mesh: Mesh | None, obj):
    """Rank 0's values on every rank, in place: a tensor, a dict of tensors
    (a state_dict) or a module's parameters and buffers.  Returns `obj`."""
    if mesh is None:
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = list(obj.state_dict().values())
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = [obj]
    for t in tensors:
        buf = t.to(mesh.comm_device, copy=True).contiguous()
        dist.broadcast(buf, src=0, group=mesh.group)
        with torch.no_grad():
            t.copy_(buf.to(t.device))
    return obj


def broadcast_flag(mesh: Mesh | None, flag: bool) -> bool:
    """Rank 0's `flag` on every rank."""
    if mesh is None:
        return flag
    return bool(replicate(mesh, torch.tensor([int(flag)]))[0])



def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, backend, timeout_s, args):
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn, world: int, args=(), backend: str = "gloo",
                timeout_s: float = 600.0) -> None:
    """Run fn(rank, *args) in `world` new processes (start method
    "spawn"), each a rank of a `backend` process group over a free port of
    127.0.0.1; `fn` calls `make_mesh` with its device.  Raises the first
    rank's failure, and TimeoutError (killing every rank) after
    `timeout_s`.  `fn` must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                   args=(fn, world, _free_port(), backend, timeout_s, args))
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
