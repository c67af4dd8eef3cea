"""The (chains, data) mesh of a multi-process run, and the collectives
the port routes through it (port of rainier_tpu/parallel/mesh.py).

One process drives one device, the usual ``torch.distributed`` layout:
a rank's device is ``cuda:LOCAL_RANK`` (see distributed.py), or the
CPU.  The two scaling axes of MCMC are the two dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks:

* ``chains``: each row of the mesh runs its own block of the chain batch.
  Chains meet only where pooled adaptation, synchronized EHMC or SMC's
  resampling ask for it, and where the Trace gathers every chain.
* ``data``: each column of the mesh sums its own block of every row space
  (data.py); the row part of logp and its gradient are all-reduced over
  the axis.

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather` and :func:`broadcast` over one axis.  An axis of one
rank costs nothing: the helpers return their input.  On a gloo group the
helpers move a CUDA tensor to the host and back, since gloo's CUDA
support lacks all_gather; a group's backend is never switched.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import config

CHAINS = "chains"
DATA = "data"


def _world_size() -> int:
    """The ranks of the process group; a program that started none gets a
    world of one (NCCL on the card, gloo on the CPU), so a single process
    can pass a mesh."""
    if not dist.is_initialized():
        backend = "nccl" if config.resolve_device().type == "cuda" \
            else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def make_mesh(n_chain_shards: Optional[int] = None, n_data_shards: int = 1,
              devices=None) -> DeviceMesh:
    """A (chains, data) mesh over the ranks `devices` (default every rank
    of the process group, one device each), laid out row by row.  By
    default every rank goes on `chains`."""
    world = _world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                       for r in devices]
    if n_chain_shards is None:
        n_chain_shards = len(ranks) // n_data_shards
    n = n_chain_shards * n_data_shards
    if n > len(ranks):
        raise ValueError(
            f"a mesh of {n_chain_shards} chain shards x {n_data_shards} data "
            f"shards needs {n} processes, have {len(ranks)}")
    grid = torch.as_tensor(ranks[:n]).reshape(n_chain_shards, n_data_shards)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, grid, mesh_dim_names=(CHAINS, DATA))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Ranks along `axis` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's position along `axis` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is a (chains, data) DeviceMesh holding this
    rank."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh from "
                        f"rainier_tpu_torch.parallel.make_mesh, not "
                        f"{type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) != (CHAINS, DATA):
        raise ValueError(f"mesh dimensions {mesh.mesh_dim_names}, expected "
                         f"{(CHAINS, DATA)}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")


def _group(mesh, axis):
    group = mesh.get_group(axis)
    return group, dist.get_backend(group) == "gloo"


def _staged(t: torch.Tensor, host: bool) -> torch.Tensor:
    """A buffer the collective may overwrite: on the host for gloo; a bool
    travels as uint8."""
    buf = t.detach()
    buf = buf.cpu() if host else buf
    if buf.dtype == torch.bool:
        return buf.to(torch.uint8)
    return buf.clone().contiguous()


def all_reduce(t: torch.Tensor, mesh, axis: str):
    """The sum of `t` over the ranks of `axis`, on every rank."""
    if axis_size(mesh, axis) == 1:
        return t
    group, host = _group(mesh, axis)
    buf = _staged(t, host)
    dist.all_reduce(buf, group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, mesh, axis: str):
    """Every rank's `t` of `axis`, concatenated along dim 0 in the axis's
    order, on every rank (equal shapes)."""
    k = axis_size(mesh, axis)
    if k == 1:
        return t
    group, host = _group(mesh, axis)
    buf = _staged(t, host)
    out = [torch.empty_like(buf) for _ in range(k)]
    dist.all_gather(out, buf, group=group)
    return torch.cat(out).to(device=t.device, dtype=t.dtype)


def broadcast(t: torch.Tensor, mesh, axis: str, src: int = 0):
    """The `t` of rank `src` of `axis`, on every rank of it."""
    if axis_size(mesh, axis) == 1:
        return t
    group, host = _group(mesh, axis)
    buf = _staged(t, host)
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def chain_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of `x` (C_local, ...) over every chain of the mesh."""
    k = axis_size(mesh, CHAINS)
    if k == 1:
        return x.mean(0)
    return all_reduce(x.sum(0), mesh, CHAINS) / (x.shape[0] * k)


def group_seed(seed: int, group: int) -> int:
    """The seed of chain group `group`'s generator: `seed` itself for the
    first, so a mesh of one chain group draws what no mesh draws."""
    if group == 0:
        return seed
    return int(np.random.SeedSequence([seed, group]).generate_state(1)[0])


class Sharding(NamedTuple):
    """Which contiguous block of a leading axis this rank holds: its n
    entries split in order over the ranks of the mesh axis `axis` (None:
    every rank holds all of them)."""

    mesh: DeviceMesh
    axis: Optional[str]

    def block(self, n: int) -> tuple:
        """This rank's entries [lo, hi) of n; the blocks differ in length
        by at most one where the axis does not divide n."""
        if self.axis is None:
            return 0, n
        k, r = axis_size(self.mesh, self.axis), axis_rank(self.mesh,
                                                          self.axis)
        return r * n // k, (r + 1) * n // k


def chain_sharding(mesh: DeviceMesh) -> Sharding:
    """The chain batch split over `chains`: the block of chains this rank
    runs (``Model.sample`` and ``Model.smc`` apply it to chains and
    particles)."""
    return Sharding(mesh, CHAINS)


def data_sharding(mesh: DeviceMesh) -> Sharding:
    """A row space split over `data`: the block of rows this rank sums
    (shard_columns applies it to the columns read row by row)."""
    return Sharding(mesh, DATA)


def replicated(mesh: DeviceMesh) -> Sharding:
    """Every rank holds the whole axis."""
    return Sharding(mesh, None)
