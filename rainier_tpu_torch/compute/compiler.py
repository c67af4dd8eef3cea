"""Lowering Real DAGs to PyTorch callables (port of rainier_tpu/compute/compiler.py).

The JAX package traces the DAG into XLA and takes ``jax.grad``.  Here the
DAG is walked eagerly with the torch backend of :mod:`.interp` and the
gradient comes from ``torch.autograd`` — the adjoint rules coincide.  The
fused CUDA kernel cannot call either, so it evaluates the same DAG
through C source generated by :mod:`.emit_cuda`.

Layout contract (same as the JAX package): the flat parameter vector
``q`` packs every latent in *creation order*; a scalar Parameter takes
one slot, a VectorParameter(k) takes k contiguous slots.  Data columns
are passed as a tuple of tensors, never baked into the function.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import config
from . import interp
from . import real as R


def find_parameters(roots: Sequence[R.Real]) -> list[R.Real]:
    """All Parameter/VectorParameter leaves reachable from roots,
    transitively through their priors, in creation order
    (cf. TargetGroup.findParameters, compute/Target.scala:82-129)."""
    found: dict[int, R.Real] = {}
    frontier = list(roots)
    seen_roots: set[int] = set()
    while frontier:
        root = frontier.pop()
        if id(root) in seen_roots:
            continue
        seen_roots.add(id(root))
        for node in R.topological([root]):
            if isinstance(node, (R.Parameter, R.VectorParameter)):
                if node.id not in found:
                    found[node.id] = node
                    if node.prior is not None:
                        frontier.append(node.prior)
    return [found[i] for i in sorted(found)]


def find_columns(roots: Sequence[R.Real]) -> list[R.Real]:
    cols: dict[int, R.Real] = {}
    for node in R.topological(list(roots)):
        if isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
            cols.setdefault(node.id, node)
    return [cols[i] for i in sorted(cols)]


@dataclass
class ParamLayout:
    parameters: list[R.Real]
    slices: list[tuple[int, int]] = field(init=False)
    n_vars: int = field(init=False)

    def __post_init__(self):
        self.slices = []
        off = 0
        for p in self.parameters:
            size = p.size if isinstance(p, R.Parameter) else p.k
            self.slices.append((off, off + size))
            off += size
        self.n_vars = off

    def env_for(self, q):
        """Bind the flat vector q (last axis) to parameter leaves."""
        env = {}
        for p, (a, b) in zip(self.parameters, self.slices):
            env[p.id] = q[..., a] if isinstance(p, R.Parameter) \
                else q[..., a:b]
        return env

    def env_for_lanes(self, qb):
        """Bind an (n_vars, C) block: (1, C) per scalar, (k, C) per
        vector parameter."""
        return {p.id: qb[a:b]
                for p, (a, b) in zip(self.parameters, self.slices)}

    def pack(self, values: dict) -> np.ndarray:
        """Inverse of env_for: build a flat q from per-parameter values."""
        q = np.zeros((self.n_vars,))
        for p, (a, b) in zip(self.parameters, self.slices):
            if p in values:
                q[a:b] = values[p]
        return q


def prior_total(parameters: Sequence[R.Real]) -> R.Real:
    """Sum of distinct prior densities (TargetGroup's dedicated "prior"
    target, compute/Target.scala:73-75)."""
    terms = []
    for p in parameters:
        if p.prior is None:
            continue
        if isinstance(p, R.VectorParameter):
            terms.append(R.VecSum(p.prior, p.k))
        else:
            terms.append(p.prior)
    return R.sum_(terms)


def bind_lane_columns(env, columns, cols) -> None:
    """Bind column values in the lanes layout: a Column as (n, 1), so it
    broadcasts over chains; IntColumn and MatColumn as they are."""
    for c, v in zip(columns, cols):
        env[c.id] = v if isinstance(c, (R.IntColumn, R.MatColumn)) \
            else v.reshape(-1, 1)


def _lane_total(vals, qb) -> torch.Tensor:
    """Sum of lanes-layout root values: (n, C) terms over rows, then all
    terms; (C,)."""
    C = qb.shape[1]
    total = torch.zeros((1, C), dtype=qb.dtype, device=qb.device)
    for v in vals:
        if v.dim() == 2 and v.shape[0] > 1:
            v = torch.sum(v, dim=0, keepdim=True)
        total = total + v
    return total.reshape(C)


class RowSpace(NamedTuple):
    """The rows of one length n that top-level RowSum likelihoods sum: a
    row of every column they read row by row at a time."""

    n_rows: int
    roots: tuple       # the per-row children of those RowSums
    columns: tuple     # indices into CompiledDensity.columns of the
                       # columns read row by row
    dep: dict          # node id -> whether its value differs by row
    frontier: tuple    # the row-invariant values the rows read, each
                       # computed once per density call over whole columns
    by_element: frozenset = frozenset()  # frontier ids some row reads by
                       # element: one of the rows' length is read at the row
    read_whole: frozenset = frozenset()  # frontier ids some row reads
                       # whole (a per-row Gather's source, a MatVec's vector)
    rebuilt: tuple = ()  # the per-row Gathers whose source varies by row:
                       # the source is taken over every row, at the index
    consts: tuple = ()   # for each root, its additive data-only summands,
                         # ((sign, node), ...) (_data_summands)
    kept: tuple = ()     # the roots without those summands, where any
                         # has some (empty: the roots as they are)


class RowSplit(NamedTuple):
    """A density as ``base`` (every other likelihood and the prior,
    columns read whole) plus the rows of each row space."""

    base: tuple
    spaces: tuple


class NoRowSplit(NotImplementedError):
    """The density's rows cannot be summed space by space."""


def _per_row_children(node) -> tuple:
    """The children whose rows are the node's rows: all, except what a
    node reads whole — the child a RowSum or VecSum sums, the source a
    Gather indexes, the vector a MatVec multiplies."""
    if isinstance(node, (R.RowSum, R.VecSum)):
        return ()
    if isinstance(node, R.Gather):
        return (node.index,)
    if isinstance(node, R.MatVec):
        return (node.mat,)
    return R.children_of(node)


# the nodes a data-only summand may hold: columns and literals, and the
# elementwise operations on them
_DATA_ONLY = (R.Constant, R.Column, R.IntColumn, R.Unary, R.Binary,
              R.NArySum, R.LogSumExp, R.Select, R.Compare, R.Lookup)


def _data_only(order, dep) -> set:
    """The ids of the nodes of `order` (a topological order) that read
    columns and literals only: a literal, or a node that varies by row
    and depends on no parameter and no row-invariant value, through
    elementwise operations alone."""
    only = set()
    for node in order:
        if isinstance(node, R.Constant) or (
                dep[node.id] and isinstance(node, _DATA_ONLY)
                and all(k.id in only for k in R.children_of(node))):
            only.add(node.id)
    return only


def _data_summands(root, only):
    """(the root without its additive data-only summands, or None where
    nothing else is left; ((sign, node), ...) of the summands): the
    maximal data-only subtrees that `root` reaches through add, sub and
    neg alone.  A data-only subtree under any other operation stays."""
    found = []

    def strip(node, sign):
        if node.id in only:
            found.append((sign, node))
            return None
        if isinstance(node, R.Unary) and node.op == "neg":
            c = strip(node.child, -sign)
            return node if c is node.child else (
                None if c is None else R.Unary(c, "neg"))
        if isinstance(node, R.Binary) and node.op in ("add", "sub"):
            a = strip(node.left, sign)
            b = strip(node.right, -sign if node.op == "sub" else sign)
            if a is node.left and b is node.right:
                return node
            if b is None:
                return a
            if a is None:
                return b if node.op == "add" else R.Unary(b, "neg")
            return R.Binary(a, b, node.op)
        if isinstance(node, R.NArySum):
            kids = [strip(k, sign) for k in node.children]
            if all(k is c for k, c in zip(kids, node.children)):
                return node
            kids = [k for k in kids if k is not None]
            return (None if not kids else kids[0] if len(kids) == 1
                    else R.NArySum(kids))
        return node

    return strip(root, 1), tuple(found)


def _row_space(roots, col_pos, hoist=True) -> Optional[RowSpace]:
    """The row space of RowSum children `roots`, or None where they read
    no column row by row.  With `hoist`, each root's additive data-only
    summands are listed (`consts`) beside the roots without them
    (`kept`), where what is kept still reads a column row by row."""
    per_row, seen, stack = {}, set(), list(roots)
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen.add(node.id)
        if isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
            per_row[node.id] = node
        stack.extend(_per_row_children(node))
    if not per_row:
        return None
    lengths = sorted({c.n_rows for c in per_row.values()})
    if len(lengths) != 1:
        raise NoRowSplit(f"a RowSum over columns of different lengths "
                         f"{lengths} row by row")
    order = R.topological(list(roots))
    dep, frontier, found = {}, [], set()
    by_element, read_whole, rebuilt = set(), set(), []
    for node in order:
        # only what the rows reach row by row (`seen`) varies by row
        dep[node.id] = node.id in seen and (node.id in per_row or any(
            dep[k.id] for k in _per_row_children(node)))
    for node in order:
        if not dep[node.id]:
            continue
        for k in R.children_of(node):
            whole = not any(k is c for c in _per_row_children(node))
            if dep[k.id] and whole:
                if isinstance(node, R.Gather) and \
                        isinstance(node.index, R.IntColumn):
                    # each row reads the source at its index
                    rebuilt.append(node)
                    continue
                # a MatVec's vector, or the source of a Gather by a
                # float index, read whole
                raise NoRowSplit(
                    f"a {type(node).__name__} whose "
                    f"{'source' if isinstance(node, R.Gather) else 'vector'}"
                    " varies by row")
            if not dep[k.id] and not isinstance(k, R.Constant):
                (read_whole if whole else by_element).add(k.id)
                if k.id not in found:
                    found.add(k.id)
                    frontier.append(k)
    space = RowSpace(lengths[0], tuple(roots),
                     tuple(sorted(col_pos[i] for i in per_row)), dep,
                     tuple(frontier), frozenset(by_element),
                     frozenset(read_whole), tuple(rebuilt))
    if not hoist:
        return space
    only = _data_only(order, dep)
    split = [_data_summands(r, only) for r in roots]
    # a root that is data-only as a whole keeps its summands, and so does
    # one whose summands are literals alone: a literal costs the row one
    # add, about what the pass once a launch and the f64 sums cost
    split = [(r, ()) if k is None or all(
        isinstance(n, R.Constant) for _, n in c) else (k, c)
        for r, (k, c) in zip(roots, split)]
    kept = tuple(k for k, _ in split)
    if not any(c for _, c in split) or \
            _row_space(kept, col_pos, hoist=False) is None:
        return space
    return space._replace(consts=tuple(c for _, c in split), kept=kept)


def kernel_rows(space, columns) -> RowSpace:
    """The rows of `space` as the fused kernel sums them in every density
    call: its roots without their additive data-only summands
    (`space.consts`), which the kernel sums once a launch."""
    if not space.kept:
        return space
    return _row_space(space.kept, {c.id: j for j, c in enumerate(columns)},
                      hoist=False)


def row_split(likelihoods, prior, columns) -> RowSplit:
    """Group the top-level RowSum likelihoods that read columns row by row
    by their length into row spaces; every other term is base.  Raises
    NoRowSplit where a RowSum reads columns of two lengths row by row, or
    reads whole a value that varies by row."""
    col_pos = {c.id: j for j, c in enumerate(columns)}
    base, groups = [], {}
    for lh in likelihoods:
        space = _row_space([lh.child], col_pos) \
            if isinstance(lh, R.RowSum) else None
        if space is None:
            base.append(lh)
        else:
            groups.setdefault(space.n_rows, []).append(lh.child)
    spaces = tuple(_row_space(roots, col_pos) for roots in groups.values())
    return RowSplit(tuple(base) + (prior,), spaces)


def _value_and_grad(f, q, *args):
    """(f(q), ∇f(q)) by autograd; a density that does not depend on q
    has a zero gradient."""
    with torch.enable_grad():
        qq = q.detach().requires_grad_(True)
        val = f(qq, *args)
        if val.requires_grad:
            (g,) = torch.autograd.grad(val.sum(), qq, allow_unused=True)
        else:
            g = None
    if g is None:
        g = torch.zeros_like(q)
    return val.detach(), g


class CompiledDensity:
    """``logp(q)`` + gradient for a set of likelihood Reals
    (Model.density() → DensityFunction, core/Model.scala:38-50):
    ``n_vars``-dim unconstrained vector in, scalar log-density and dense
    gradient out."""

    def __init__(self, likelihoods: Sequence[R.Real],
                 extra_roots: Sequence[R.Real] = ()):
        self.likelihoods = [R.to_real(l) for l in likelihoods]
        roots = self.likelihoods + [R.to_real(e) for e in extra_roots]
        self.layout = ParamLayout(find_parameters(roots))
        self._prior = prior_total(self.layout.parameters)
        self.columns = find_columns(
            self.likelihoods + [self._prior] +
            [p.prior for p in self.layout.parameters if p.prior is not None])
        self._backends: dict = {}
        self._row_split: Optional[RowSplit] = None

    @property
    def n_vars(self) -> int:
        return self.layout.n_vars

    @property
    def parameters(self) -> list[R.Real]:
        return self.layout.parameters

    @property
    def roots(self) -> list[R.Real]:
        """Every term of the density: the likelihoods, then the prior."""
        return self.likelihoods + [self._prior]

    def _backend(self, device) -> interp._TorchBackend:
        key = str(torch.device(device))
        be = self._backends.get(key)
        if be is None:
            be = self._backends[key] = interp.torch_backend(device)
        return be

    def column_values(self, dtype=None, device=None) -> tuple:
        dtype = dtype or config.dtype()
        dev = config.resolve_device(device)
        return tuple(
            torch.as_tensor(c.values, dtype=torch.int32, device=dev)
            if isinstance(c, R.IntColumn)
            else torch.as_tensor(c.values, dtype=dtype, device=dev)
            for c in self.columns)

    def logp_fn(self) -> Callable:
        """(q (n_vars,), cols) -> scalar logp."""
        layout, columns, roots = self.layout, self.columns, self.roots

        def logp(q, cols):
            env = layout.env_for(q)
            for c, v in zip(columns, cols):
                env[c.id] = v
            vals = interp.evaluate(roots, env, self._backend(q.device),
                                   q.dtype)
            total = vals[-1]
            for v in vals[:-1]:
                total = total + torch.sum(v)
            return total

        return logp

    def logp_and_grad_fn(self) -> Callable:
        """(q, cols) -> (logp, grad)."""
        logp = self.logp_fn()
        return lambda q, cols: _value_and_grad(logp, q, cols)

    def logp_lanes_fn(self) -> Callable:
        """(qb (n_vars, C), cols) -> (C,) — a whole block of chains at once
        in the chains-last layout of interp.evaluate_lanes."""
        layout, columns, roots = self.layout, self.columns, self.roots

        def logp(qb, cols):
            env = layout.env_for_lanes(qb)
            bind_lane_columns(env, columns, cols)
            vals = interp.evaluate_lanes(roots, env,
                                         self._backend(qb.device), qb.dtype)
            return _lane_total(vals, qb)

        return logp

    def logp_lanes_split_fn(self):
        """Base/row-term split of logp_lanes_fn for row-tiled evaluation
        (rainier_tpu/compute/compiler.py:223-294): ``(base_fn, tile_fn)``
        with

        * ``base_fn(qb) -> (C,)``: every column-free term, the prior total
          plus any likelihood root that is not a ``RowSum``;
        * ``tile_fn(qb, mask, cols_tile) -> (C,)``: each ``RowSum``
          likelihood's per-row child on a row slice of every column,
          times ``mask`` ((R, 1), 0 for padding rows), summed over the
          slice's rows; a row-independent child contributes
          ``child · Σmask``,

        so ``logp(qb, cols) == base_fn(qb) + Σ_tiles tile_fn(...)`` for any
        tiling of the rows.  None when the base terms reference columns
        (no clean split exists).  The JAX package's split, tiling every
        column alike; what the fused kernel computes, over several row
        spaces and with columns read whole, is :meth:`logp_rows_fn`."""
        row_roots = [r.child for r in self.likelihoods
                     if isinstance(r, R.RowSum)]
        base_roots = [r for r in self.likelihoods
                      if not isinstance(r, R.RowSum)] + [self._prior]
        if find_columns(base_roots):
            return None
        layout, columns = self.layout, self.columns

        def base_fn(qb):
            vals = interp.evaluate_lanes(base_roots,
                                         layout.env_for_lanes(qb),
                                         self._backend(qb.device), qb.dtype)
            return _lane_total(vals, qb)

        def tile_fn(qb, mask, cols_tile):
            env = layout.env_for_lanes(qb)
            bind_lane_columns(env, columns, cols_tile)
            vals = interp.evaluate_lanes(row_roots, env,
                                         self._backend(qb.device), qb.dtype)
            total = torch.zeros((1, qb.shape[1]), dtype=qb.dtype,
                                device=qb.device)
            for v in vals:
                if v.dim() == 2 and v.shape[0] > 1:
                    total = total + torch.sum(v * mask, dim=0, keepdim=True)
                else:
                    # row-independent child: each unmasked row adds it once
                    total = total + v * torch.sum(mask)
            return total.reshape(qb.shape[1])

        return base_fn, tile_fn

    def row_split(self) -> RowSplit:
        """The density's base terms and row spaces (:func:`row_split`)."""
        if self._row_split is None:
            self._row_split = row_split(self.likelihoods, self._prior,
                                        self.columns)
        return self._row_split

    def logp_rows_fn(self):
        """The density as the fused kernel sums it: ``(base_fn, rows_fn)``
        with

        * ``base_fn(qb, cols) -> (C,)``: the base terms of
          :meth:`row_split`, their columns read whole;
        * ``rows_fn(qb, cols, tile_rows) -> (C,)`` float64: each row
          space's rows in consecutive slices of ``tile_rows`` rows (an
          int, or one per space), each slice's sum added in f64; a slice
          holds only the space's own columns, and the row-invariant values
          its rows read are computed once per call over whole columns,

        so ``logp_lanes_fn(qb, cols) == base_fn + rows_fn`` for any
        tiling.  The plain version of what the kernel computes; raises
        NoRowSplit where :meth:`row_split` does.

        ``rows_fn(..., rows=, starts=)`` sums only a block of each space's
        rows, as a rank of a data-sharded density does: `rows` holds one
        (lo, hi) a space, and `starts` one row a column, the row its
        tensor begins at (0 for a column held whole, lo for one that holds
        only its block)."""
        split = self.row_split()
        layout, columns = self.layout, self.columns

        def env_of(qb, cols):
            env = layout.env_for_lanes(qb)
            bind_lane_columns(env, columns, cols)
            return env

        def base_fn(qb, cols):
            vals = interp.evaluate_lanes(split.base, env_of(qb, cols),
                                         self._backend(qb.device), qb.dtype)
            return _lane_total(vals, qb)

        def rows_fn(qb, cols, tile_rows, rows=None, starts=None):
            be = self._backend(qb.device)
            tiles = ([tile_rows] * len(split.spaces)
                     if isinstance(tile_rows, int) else list(tile_rows))
            rows = rows or [(0, s.n_rows) for s in split.spaces]
            starts = starts or [0] * len(columns)
            total = torch.zeros(qb.shape[1], dtype=torch.float64,
                                device=qb.device)
            for space, r, (lo, hi) in zip(split.spaces, tiles, rows):
                whole = env_of(qb, cols)
                inv = dict(zip((f.id for f in space.frontier),
                               interp.evaluate_lanes(
                                   space.frontier, whole, be, qb.dtype)))
                # a vector of the rows' length read by element: each
                # slice reads its own rows of it
                at_rows = {i for i, v in inv.items()
                           if i in space.by_element and v.dim() == 2
                           and v.shape[0] == space.n_rows > 1}
                if at_rows & space.read_whole:
                    raise NoRowSplit("a row-invariant vector of the rows' "
                                     "length read both by element and "
                                     "whole")
                # a source that varies by row, over every row once
                sources = dict(zip(
                    (g.id for g in space.rebuilt), interp.evaluate_lanes(
                        [g.source for g in space.rebuilt], whole, be,
                        qb.dtype)))
                own = [columns[j] for j in space.columns]
                index = {c.id: j for j, c in enumerate(columns)}
                for a in range(lo, hi, r):
                    b = min(a + r, hi)
                    env = layout.env_for_lanes(qb)
                    env.update({i: v[a:b] if i in at_rows else v
                                for i, v in inv.items()})
                    for g in space.rebuilt:
                        j = index[g.index.id]
                        idx = cols[j][a - starts[j]:b - starts[j]]
                        env[g.id] = interp._gather(be, g, {
                            g.source.id: sources[g.id], g.index.id: idx})
                    bind_lane_columns(env, own, [
                        cols[j][a - starts[j]:b - starts[j]]
                        for j in space.columns])
                    vals = interp.evaluate_lanes(space.roots, env, be,
                                                 qb.dtype)
                    total = total + _lane_total(vals, qb).double()
            return total

        return base_fn, rows_fn

    def batched_logp_and_grad_fn(self) -> Callable:
        """(q (C, n_vars), cols) -> (logp (C,), grad (C, n_vars)): the
        sampler's per-chain density with chains as the leading batch
        dimension (the port's counterpart of vmapping logp_and_grad_fn)."""
        lanes = self.logp_lanes_fn()

        def lpg(q, cols):
            lp, g = _value_and_grad(lanes, q.T, cols)
            return lp, g.T

        return lpg

    def logp(self, q, device=None) -> torch.Tensor:
        dev = config.resolve_device(device)
        q = torch.as_tensor(q, dtype=config.dtype(), device=dev)
        return self.logp_fn()(q, self.column_values(device=dev))

    def logp_and_grad(self, q, device=None):
        dev = config.resolve_device(device)
        q = torch.as_tensor(q, dtype=config.dtype(), device=dev)
        return self.logp_and_grad_fn()(q, self.column_values(device=dev))
