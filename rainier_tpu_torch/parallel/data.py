"""Data-parallel (row-sharded) likelihood evaluation (port of
rainier_tpu/parallel/data.py).

Each rank of the mesh's ``data`` axis sums its own contiguous block of
the rows of every row space (compute/compiler.py's ``row_split``, the
split the fused kernel relies on); the row part of logp and its gradient
are all-reduced over the axis, and the base (the prior and every term
read whole) is added once, by the axis's first rank.  Where the JAX
package lets XLA's partitioner insert the psum, this module does it by
hand.

Only columns read row by row, and nowhere whole, are cut to the rank's
block: a column that the base, a row-invariant value or a rebuilt Gather
source reads whole stays whole on every rank, and its rows are sliced
where the rank's rows read them.  A model whose rows cannot be split
(``NoRowSplit``) is evaluated whole on every rank, with a warning.
"""

from __future__ import annotations

import logging

import torch

from .. import config
from ..compute.compiler import NoRowSplit, _value_and_grad, find_columns
from . import mesh as M

log = logging.getLogger("rainier_tpu_torch")


def _shard(col, mesh, axis):
    """(this rank's block of `col`'s rows, the row it begins at); the whole
    column where the axis does not divide its length."""
    n_shards = M.axis_size(mesh, axis)
    if n_shards == 1:
        return col, 0
    if col.shape[0] % n_shards:
        log.warning("column of %d rows not divisible by %d data shards; "
                    "replicating", col.shape[0], n_shards)
        return col, 0
    lo, hi = M.Sharding(mesh, axis).block(col.shape[0])
    return col[lo:hi].contiguous(), lo


def shard_columns(col_vals: tuple, mesh, axis: str = M.DATA) -> tuple:
    """This rank's contiguous block of rows of each column; a column whose
    length the axis does not divide is kept whole (with a warning)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return col_vals
    return tuple(_shard(c, mesh, axis)[0] for c in col_vals)


def _whole_columns(compiled, split) -> set:
    """Ids of the columns something reads whole: the base terms, the
    row-invariant values of a space, a rebuilt Gather's source."""
    roots = list(split.base)
    for space in split.spaces:
        roots += list(space.frontier) + [g.source for g in space.rebuilt]
    return {c.id for c in find_columns(roots)}


class ShardedDensity:
    """The batched density of `compiled` over the `axis` ranks of `mesh`:
    ``lpg(q (C, n_vars)) -> (lp (C,), g (C, n_vars))`` and ``logp(q)``,
    the same on every rank of the axis.  At one rank (or with no mesh) it
    is ``batched_logp_and_grad_fn`` on the whole columns, bit for bit."""

    def __init__(self, compiled, mesh=None, axis: str = M.DATA, dtype=None,
                 device=None):
        self.compiled, self.mesh, self.axis = compiled, mesh, axis
        dtype = dtype or config.dtype()
        dev = config.resolve_device(device)
        cols = compiled.column_values(dtype, dev)
        self.sharded = False
        if M.axis_size(mesh, axis) > 1:
            try:
                split = compiled.row_split()
            except NoRowSplit as e:
                log.warning("the density's rows cannot be split (%s); every "
                            "data rank evaluates it whole", e)
            else:
                cols = self._shard(cols, split)
                self.sharded = True
        self.cols = cols
        if self.sharded:
            self.lpg, self.logp = self._sharded_lpg, self._sharded_logp
        else:
            lpg = compiled.batched_logp_and_grad_fn()
            lanes = compiled.logp_lanes_fn()
            self.lpg = lambda q: lpg(q, cols)
            self.logp = lambda q: lanes(q.T, cols)

    def _shard(self, cols, split):
        compiled, mesh, axis = self.compiled, self.mesh, self.axis
        whole = _whole_columns(compiled, split)
        cols, starts = list(cols), [0] * len(cols)
        for space in split.spaces:
            for j in space.columns:
                if compiled.columns[j].id not in whole:
                    cols[j], starts[j] = _shard(cols[j], mesh, axis)
        rows = [M.Sharding(mesh, axis).block(s.n_rows) for s in split.spaces]
        tiles = [max(hi - lo, 1) for lo, hi in rows]
        base_fn, rows_fn = compiled.logp_rows_fn()
        first = M.axis_rank(mesh, axis) == 0

        def local(qb, cols_):
            """This rank's rows, and the base on the axis's first rank."""
            lp = rows_fn(qb, cols_, tiles, rows, starts).to(qb.dtype)
            return lp + base_fn(qb, cols_) if first else lp

        self._local = local
        return tuple(cols)

    def _sharded_lpg(self, q):
        lp, g = _value_and_grad(self._local, q.T, self.cols)
        both = M.all_reduce(torch.cat([lp[:, None], g.T], dim=1), self.mesh,
                            self.axis)
        return both[:, 0], both[:, 1:]

    def _sharded_logp(self, q):
        with torch.no_grad():
            return M.all_reduce(self._local(q.T, self.cols), self.mesh,
                                self.axis)


def sharded_logp_fn(compiled, mesh, axis: str = M.DATA):
    """Returns (logp_and_grad(q), sharded_cols) on the process's device
    and dtype (config): q is (n_vars,) or (C, n_vars); every rank of
    `axis` gets the whole density."""
    d = ShardedDensity(compiled, mesh, axis)

    def fn(q):
        if q.dim() == 1:
            lp, g = d.lpg(q[None])
            return lp[0], g[0]
        return d.lpg(q)

    return fn, d.cols

