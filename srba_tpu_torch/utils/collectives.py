"""All-reduce over one axis of a device mesh: the port's ``lax.psum`` and
``lax.pmax``.

A mesh (:mod:`srba_tpu_torch.parallel.sharding`) is a 1-D
``torch.distributed`` ``DeviceMesh``: one rank per device, every rank
running the same program on its own shard.  The solvers reduce their
per-shard sums with :func:`psum`; several tensors reduced at the same point
go in ONE round (:func:`all_reduce_packed`, the JAX package's
``_psum_packed``: flatten, concatenate, one ``dist.all_reduce``, split),
since a collective costs its latency whatever its size.  Every rank gets
the same reduced values, so control flow read from them takes the same
decisions on every rank.

Without an axis (``group`` None) every function returns its input: the
single-device solvers call them unconditionally.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def axis_group(axis_name: Optional[str], mesh=None):
    """The process group that reduces over ``axis_name``: the mesh's group
    of that dimension, or the default (whole-world) group when no mesh is
    given.  None when ``axis_name`` is None (a single-device solve)."""
    if axis_name is None:
        return None
    if mesh is not None:
        return mesh.get_group(axis_name)
    if not dist.is_initialized():
        raise RuntimeError(
            f"axis_name={axis_name!r} needs a process group: call "
            "srba_tpu_torch.parallel.multihost.initialize() or pass a mesh")
    return dist.group.WORLD


def all_reduce_packed(tensors: Sequence[torch.Tensor], group,
                      op=dist.ReduceOp.SUM) -> Tuple[torch.Tensor, ...]:
    """One all-reduce round for several tensors of one dtype and device:
    returns them reduced over ``group`` with ``op`` (fresh tensors, the
    inputs untouched), or the inputs themselves when ``group`` is None."""
    if group is None:
        return tuple(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off: off + t.numel()].view(t.shape))
        off += t.numel()
    return tuple(out)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (``x`` itself when ``group`` is None)."""
    return all_reduce_packed((x,), group)[0]
