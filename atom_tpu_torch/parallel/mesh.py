"""The rank mesh and the collectives of multi-card serving
(``atom_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over devices and its serving
code calls ``jax.lax`` collectives inside ``shard_map``.  The port's ranks
are processes (``parallel/launch.py``): ``make_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
whose named axes (``mesh.get_group(axis)``) carry the collectives below.

Axes: ``dp`` (data parallel, requests), ``tp`` (tensor parallel, heads and
columns), and in the serving modules ``ep`` (experts and heads) and ``sp``
(the tokens of a prefill).  By default all ranks are on ``tp``.

Backends: NCCL on several cards; gloo on the CPU and where ranks share one
card.  A mesh over a gloo group has device type ``cpu`` (a gloo group moves
host tensors), and the collectives here copy a CUDA tensor through host
memory and back explicitly: that is the transport, the kernels stay on the
card.  Every collective is synchronous; a rank that fails or times out
raises (``launch.run_ranks`` then stops the others).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("dp", "tp"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over every rank of the default process group.  ``shape``
    defaults to all ranks on the last axis (``(1, world)`` for the default
    names); ``device_type`` to ``cuda`` under NCCL and ``cpu`` under gloo."""
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"make_mesh: shape {shape} does not match axes {tuple(axis_names)}")
    if int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"make_mesh: mesh shape {shape} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``jax.lax.axis_size``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _via_host(x: torch.Tensor, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """[n * x.shape[0], ...]: every rank's ``x`` stacked on dim 0, in rank order."""
    n = dist.get_world_size(group)
    host = _via_host(x, group)
    src = (x.cpu() if host else x).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device) if host else out


def all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather tiled along the last axis (``jax.lax.all_gather(x, axis,
    axis=x.ndim - 1, tiled=True)``): [..., c] -> [..., n * c], rank r's
    columns at [r * c, (r + 1) * c)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    g = _gather0(x.reshape(1, -1), group).reshape((n,) + tuple(x.shape))
    return g.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (n * x.shape[-1],))


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather tiled along the first (token) axis: [t, ...] -> [n * t, ...]."""
    if dist.get_world_size(group) == 1:
        return x
    return _gather0(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks (``jax.lax.psum``), a new tensor."""
    if dist.get_world_size(group) == 1:
        return x
    host = _via_host(x, group)
    out = x.detach().to("cpu", copy=True) if host else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if host else out


def broadcast_from(x: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """Rank ``src_index``'s ``x`` (of the group) on every rank of the group."""
    if dist.get_world_size(group) == 1:
        return x
    host = _via_host(x, group)
    out = x.detach().to("cpu", copy=True) if host else x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src_index), group=group)
    return out.to(x.device) if host else out
