"""Posterior-predictive generators (port of rainier_tpu/core/generator.py,
counterpart of core/Generator.scala).

A Generator is a sampling program ``fn(gen, env) -> value``: ``gen`` is a
``torch.Generator`` on the entry point's device and ``env`` an
:class:`Env` that evaluates any Real at N draws at once.  The JAX package
draws one value with a PRNG key and vmaps over draws; here a generator
draws all N at once, so every value is a tensor whose LAST axis is the
draw (the chains-last layout of ``interp.evaluate_lanes``): a scalar is
(N,), a value over the rows of a data column (rows, N), ``repeat(n)``
stacks (n, ..., N).  Broadcasting then works as it does for one draw:
a scalar parameter meets a per-row one on the draw axis.  The entry
points (``Generator.get``, ``Trace.predict``, ``Model.sample_prior``)
move the draw axis to the front: (N,), (N, rows), (N, n, ...).

Every random draw takes ``gen``, never the global RNG, so one seed gives
the same draws.  The samplers are torch's: ``torch.randn``/``rand``,
``torch.poisson``, ``torch.binomial``, ``torch._standard_gamma`` and
``torch.multinomial``.  The streams differ from ``jax.random``'s, so the
port is held to the law of its draws, not to JAX's bits.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from .. import config
from ..compute import interp
from ..compute import real as R
from ..compute.compiler import bind_lane_columns, find_columns


class Env:
    """Evaluates Reals at N draws on one device, in the lanes layout.

    ``base`` maps leaf node id -> value as ``ParamLayout.env_for_lanes``
    binds them ((1, N) a scalar parameter, (k, N) a vector); a data column
    an expression reads is bound whole from its values when first needed,
    as ``Trace.evaluate`` binds it.  ``batch`` is the shape a draw takes
    where no parameter says otherwise: (N,), or what an enclosing
    generator asks for (:meth:`at`)."""

    def __init__(self, n: int, base=None, device=None, dtype=None,
                 _cache=None, batch=None):
        self.n = int(n)
        self.device = config.resolve_device(device)
        self.dtype = dtype or config.dtype()
        self.batch = tuple(batch) if batch is not None else (self.n,)
        self._base = dict(base or {}) if _cache is None else base
        self._cache = {} if _cache is None else _cache
        self._backend = interp.torch_backend(self.device)

    def __call__(self, x) -> torch.Tensor:
        """x's value at every draw: (N,) if it is one number a draw,
        (rows, N) or (k, N) over a column or a vector."""
        x = R.to_real(x)
        val = self._cache.get(x.id)
        if val is None:
            missing = [c for c in find_columns([x]) if c.id not in self._base]
            bind_lane_columns(self._base, missing, [
                torch.as_tensor(c.values, device=self.device,
                                dtype=torch.int32 if isinstance(
                                    c, R.IntColumn) else self.dtype)
                for c in missing])
            val = interp.evaluate_lanes([x], self._base, self._backend,
                                        self.dtype)[0]
            val = torch.as_tensor(val, dtype=self.dtype, device=self.device)
            if val.dim() == 2 and val.shape[0] == 1:
                val = val[0]
            # a constant, or a column that no draw changes: one value
            # for every draw
            val = val.expand(val.shape[:-1] + (self.n,)) if val.dim() \
                else val.expand(self.n)
            self._cache[x.id] = val
        return val

    def shape(self, *reals) -> tuple:
        """The shape of one draw of a family with these parameters: the
        batch shape broadcast with every parameter's."""
        return tuple(torch.broadcast_shapes(
            self.batch, *[self(r).shape for r in reals]))

    def at(self, batch) -> "Env":
        """This env, whose draws take the shape `batch` (same values)."""
        return Env(self.n, self._base, self.device, self.dtype, self._cache,
                   batch)

    def full(self, x, shape) -> torch.Tensor:
        """x's value broadcast to `shape`, contiguous."""
        return self(x).expand(shape).contiguous()

    def to_double(self, x):
        return self(x)

    def to_int(self, x):
        return self(x).to(torch.int32)


def empty_env(n: int = 1, device=None) -> Env:
    return Env(n, device=device)


def tree_map(f, value):
    """`f` applied to every tensor of a generated value (tensors in
    tuples, lists and dicts), the structure kept."""
    if isinstance(value, torch.Tensor):
        return f(value)
    if isinstance(value, (tuple, list)):
        return type(value)(tree_map(f, v) for v in value)
    if isinstance(value, dict):
        return {k: tree_map(f, v) for k, v in value.items()}
    return value


def draws_first(value):
    """A generated value with its draw axis moved from last to first."""
    return tree_map(lambda t: t.movedim(-1, 0) if t.dim() else t, value)


class Generator:
    """Sampling monad; ``fn(gen, env) -> value`` (core/Generator.scala:
    10-159)."""

    def __init__(self, fn: Callable[[torch.Generator, Env], Any],
                 requirements: frozenset = frozenset()):
        self.fn = fn
        self.requirements = requirements

    def get(self, gen: torch.Generator, env: Env | None = None):
        """Run the generator: with the default env, N = 1 draw; the
        value's draw axis first."""
        env = env if env is not None else empty_env(device=gen.device)
        return draws_first(self.fn(gen, env))

    def map(self, f: Callable) -> "Generator":
        return Generator(lambda g, e: f(self.fn(g, e)), self.requirements)

    def flat_map(self, f: Callable[[Any], "Generator"]) -> "Generator":
        def fn(gen, env):
            return to_generator(f(self.fn(gen, env))).fn(gen, env)

        return Generator(fn, self.requirements)

    def zip(self, other: "Generator") -> "Generator":
        return Generator(lambda g, e: (self.fn(g, e), other.fn(g, e)),
                         self.requirements | other.requirements)

    def repeat(self, n) -> "Generator":
        """n independent draws a posterior draw, stacked first: (n, ...,
        N), (N, n, ...) at the entry points."""
        n = _static_count(n)
        return Generator(
            lambda g, e: _stack([self.fn(g, e) for _ in range(n)]),
            self.requirements)

    @staticmethod
    def of(t) -> "Generator":
        """Convert a Real / Distribution / Vec / tuple / list / dict,
        recursively (the ToGenerator chain, core/Generator.scala:
        161-248)."""
        return to_generator(t)

    @staticmethod
    def constant(value) -> "Generator":
        return Generator(lambda g, e: value)

    @staticmethod
    def from_fn(fn: Callable) -> "Generator":
        return Generator(fn)

    @staticmethod
    def real(x) -> "Generator":
        x = R.to_real(x)
        return Generator(lambda g, e: e(x), frozenset([x]))

    @staticmethod
    def require(reqs, fn: Callable) -> "Generator":
        return Generator(fn, frozenset(reqs))

    @staticmethod
    def categorical(pmf: dict) -> "Generator":
        """Draw a key of `pmf` with probability proportional to its value.

        Numeric keys: one ``torch.multinomial`` draw of the index.
        Generator- or distribution-valued keys (mixtures; JAX's
        ``lax.switch``): every branch is drawn, and each draw takes the
        branch its index names."""
        items = list(pmf.items())
        probs = [R.to_real(p) for _, p in items]
        keys_ = [t for t, _ in items]
        numeric = all(isinstance(t, (int, float)) for t in keys_)
        branches = None if numeric else [to_generator(t) for t in keys_]

        def fn(gen, env):
            vals = None if numeric else [b.fn(gen, env) for b in branches]
            shape = env.shape(*probs)
            if vals is not None:
                shape = tuple(torch.broadcast_shapes(
                    shape, *[v.shape for v in vals]))
            p = torch.stack([env.full(pr, shape) for pr in probs], dim=-1)
            idx = torch.multinomial(p.reshape(-1, len(probs)).clamp(min=0.0),
                                    1, generator=gen).reshape(shape)
            if numeric:
                return torch.as_tensor(keys_, dtype=env.dtype,
                                       device=env.device)[idx]
            stacked = torch.stack([v.expand(shape) for v in vals])
            return torch.gather(stacked, 0, idx[None])[0]

        return Generator(fn, frozenset(probs))

    @staticmethod
    def traverse(gens: Sequence) -> "Generator":
        gens = [to_generator(g) for g in gens]
        return Generator(lambda g, e: [x.fn(g, e) for x in gens],
                         _requirements(gens))


def _stack(vals):
    """Stack like values along a new first axis (through tuples, lists
    and dicts)."""
    first = vals[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(torch.broadcast_tensors(*vals))
    if isinstance(first, (tuple, list)):
        out = [_stack([v[i] for v in vals]) for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    if isinstance(first, dict):
        return {k: _stack([v[k] for v in vals]) for k in first}
    return torch.as_tensor(vals)


def _requirements(gens) -> frozenset:
    return frozenset().union(*[g.requirements for g in gens]) if gens \
        else frozenset()


def _static_count(n) -> int:
    if isinstance(n, R.Constant):
        return int(n.value)
    if isinstance(n, R.Real):
        raise ValueError("repeat() count must be statically known "
                         "(a Constant or python int): it sets the shape of "
                         "the draws")
    return int(n)


def to_generator(x) -> Generator:
    """ToGenerator typeclass analogue (core/Generator.scala:161-248)."""
    from ..compute.vec import Vec
    from .distribution import Distribution

    if isinstance(x, Generator):
        return x
    if isinstance(x, Distribution):
        return x.generator()
    if isinstance(x, R.Real):
        return Generator.real(x)
    if isinstance(x, (int, float)):
        return Generator(lambda g, e: torch.full((e.n,), float(x),
                                                 dtype=e.dtype,
                                                 device=e.device))
    if isinstance(x, (tuple, list)):
        gens = [to_generator(i) for i in x]
        kind = tuple if isinstance(x, tuple) else list
        return Generator(lambda g, e: kind(v.fn(g, e) for v in gens),
                         _requirements(gens))
    if isinstance(x, dict):
        ks = list(x.keys())
        gens = [to_generator(x[k]) for k in ks]
        return Generator(lambda g, e: {k: v.fn(g, e)
                                       for k, v in zip(ks, gens)},
                         _requirements(gens))
    if isinstance(x, Vec):
        # a column Vec is one element over its rows: one batched draw of
        # (rows, N); a list Vec stacks its elements' draws
        if x.is_column and not isinstance(x.element, (tuple, dict)):
            el = to_generator(x.element)
            rows = x.size

            def fn(g, e):
                v = el.fn(g, e.at((rows, e.n)))
                return v.expand((rows, e.n)) if v.dim() < 2 else v

            return Generator(fn, el.requirements)
        return to_generator(x.to_list()).map(_stack_rows)
    raise TypeError(f"cannot convert {type(x)} to Generator")


def _stack_rows(vals):
    """A list Vec's per-element draws as one (n, ..., N) tensor where they
    share a shape, else the list (a Vec of tuples)."""
    try:
        return torch.stack(vals)
    except (TypeError, RuntimeError):
        return vals
