"""Process groups for data and sequence parallelism over ``torch.distributed``:
the counterpart of ``animate3d_tpu/parallel/mesh.py``.

The JAX package builds one device mesh with axes ``dp`` (data parallel over
the (B·N) batch / view·frame axis) and ``sp`` (the token axis of attention
sharded for ring attention), and XLA inserts the collectives. Here every
rank is one process on one device, started by ``torchrun`` (or
``python -m torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK`` (the reference's ``train.py:55-84`` bootstrap): NCCL on
``cuda``, gloo on ``cpu``. Ranks form a (dp, sp) grid, rank = d·sp + s, as
the JAX mesh lays out its devices; each axis has its own process group.

  * :func:`shard_batch` — this rank's contiguous slice of a leading axis
    (the JAX ``P("dp")`` layout);
  * :func:`replicate` — a broadcast from the group's first rank;
  * :func:`all_reduce_` — in-place sum or mean over an axis, flattened into
    one buffer;
  * :func:`shard_leading_where_divisible` — the ZeRO-1 layout: each rank's
    slice of every leaf whose leading axis divides by dp, the leaf itself
    otherwise (``mesh.py:54-70``).

At world size 1 every collective is a no-op. Nothing here starts a process
group at import time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init_distributed(device: torch.device) -> Tuple[torch.device, bool]:
    """Join the process group that ``torchrun``'s environment describes
    (NCCL on ``cuda``, gloo on ``cpu``), unless one is already joined or
    the environment names none. Returns the device of this rank (on
    ``cuda``, the card ``LOCAL_RANK``, which becomes the current one) and
    whether this call joined the group, in which case the caller leaves it
    with :func:`leave`."""
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return device, False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return device, True


def leave(joined: bool) -> None:
    """Leave the process group that :func:`init_distributed` joined."""
    if joined:
        dist.destroy_process_group()


def world() -> "tuple[int, int]":
    """(rank, world size) of the joined process group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """This rank's place in the (dp, sp) grid and the groups of its axes
    (None where an axis has size 1)."""

    dp: int
    sp: int
    rank: int
    dp_rank: int
    sp_rank: int
    dp_group: Any = None
    sp_group: Any = None
    backend: Optional[str] = None  # the process group's, None without one

    @property
    def is_main(self) -> bool:
        """The rank that writes files (checkpoints, logs, images)."""
        return self.rank == 0

    def group(self, axis: str):
        return self.dp_group if axis == "dp" else self.sp_group

    def size(self, axis: str) -> int:
        return self.dp if axis == "dp" else self.sp

    def axis_rank(self, axis: str) -> int:
        return self.dp_rank if axis == "dp" else self.sp_rank


def make_mesh(dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """The (dp, sp) grid over the joined process group (or the one process),
    with ``dp * sp`` = the world size; ``dp`` defaults to world / sp. Every
    rank must call it, in the same order as its other group creations."""
    rank, size = world()
    if dp is None:
        dp = size // sp
    if dp * sp != size:
        raise ValueError(f"mesh dp={dp} x sp={sp} needs {dp * sp} processes, "
                         f"the process group has {size}")
    grid = [[d * sp + s for s in range(sp)] for d in range(dp)]
    dp_group = sp_group = None
    # new_group is collective: every rank creates every group, in one order
    if dp > 1:
        for s in range(sp):
            g = dist.new_group([grid[d][s] for d in range(dp)])
            if rank % sp == s:
                dp_group = g
    if sp > 1:
        for d in range(dp):
            g = dist.new_group(grid[d])
            if rank // sp == d:
                sp_group = g
    return Mesh(dp=dp, sp=sp, rank=rank, dp_rank=rank // sp, sp_rank=rank % sp,
                dp_group=dp_group, sp_group=sp_group,
                backend=dist.get_backend() if dist.is_initialized() else None)


def shard_rows(mesh: Mesh, n: int, axis: str = "dp") -> slice:
    """This rank's contiguous slice of ``n`` rows split over ``axis``."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"{n} rows do not split over {axis}={size}")
    k = n // size
    r = mesh.axis_rank(axis)
    return slice(r * k, (r + 1) * k)


def shard_batch(mesh: Mesh, tree, axis: str = "dp"):
    """Each tensor / array of a dict, list, tuple or NamedTuple, cut to this
    rank's slice of its leading axis."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(mesh, v, axis) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    return tree[shard_rows(mesh, tree.shape[0], axis)]


def _group_src(group) -> int:
    return dist.get_global_rank(group, 0) if group is not None else 0


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str = "dp") -> None:
    """Broadcast ``tensors`` in place from the first rank of ``axis``."""
    group = mesh.group(axis)
    if group is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, _group_src(group), group=group)


def all_reduce_(mesh: Mesh, tensors: Sequence[torch.Tensor], op: str = "mean",
                axis: str = "dp") -> None:
    """Sum or mean ``tensors`` in place over ``axis``, one collective over a
    flat buffer of each dtype (gloo has no mean: the sum is divided)."""
    group = mesh.group(axis)
    if group is None or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if op == "mean":
            flat /= mesh.size(axis)
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def all_gather_rows(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Concatenate every rank's ``x`` (equal shapes) along the leading axis,
    in rank order."""
    group = mesh.group(axis)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def shard_leading_where_divisible(mesh: Mesh, tensors: Sequence[torch.Tensor],
                                  axis: str = "dp") -> List[Optional[slice]]:
    """The ZeRO-1 layout of ``tensors``: for each, this rank's slice of its
    leading axis when that divides by the axis size, else None (kept
    whole)."""
    size = mesh.size(axis)
    out = []
    for t in tensors:
        n = t.shape[0] if t.dim() else 0
        out.append(shard_rows(mesh, n, axis) if size > 1 and n > 0 and n % size == 0
                   else None)
    return out


def gather_shards_(mesh: Mesh, tensors: Sequence[torch.Tensor],
                   shards: Sequence[Optional[slice]], axis: str = "dp") -> None:
    """Fill each sharded tensor in place from every rank's slice of it (the
    all-gather after a ZeRO-1 update)."""
    group = mesh.group(axis)
    if group is None:
        return
    size = mesh.size(axis)
    with torch.no_grad():
        for t, sl in zip(tensors, shards):
            if sl is not None:
                dist.all_gather(list(t.data.chunk(size)), t.data[sl].clone(), group=group)
