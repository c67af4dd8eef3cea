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
from typing import Callable, Sequence

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


def _bind_lane_columns(env, columns, cols) -> None:
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


def row_tile_sum(tile_fn, qb, cols, tile_rows: int) -> torch.Tensor:
    """Σ over consecutive slices of `tile_rows` rows of
    ``tile_fn(qb, ones mask, slice)`` (a ``logp_lanes_split_fn`` tile
    function), each slice's total added in f64: (C,) float64."""
    total = torch.zeros(qb.shape[1], dtype=torch.float64, device=qb.device)
    for a in range(0, int(cols[0].shape[0]), tile_rows):
        tile = tuple(c[a:a + tile_rows] for c in cols)
        mask = torch.ones((tile[0].shape[0], 1), dtype=qb.dtype,
                          device=qb.device)
        total = total + tile_fn(qb, mask, tile).double()
    return total


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
            _bind_lane_columns(env, columns, cols)
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
        (no clean split exists).  This is the plain version of what the
        fused kernel computes over its row tiles."""
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
            _bind_lane_columns(env, columns, cols_tile)
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
