"""Backend-parameterized DAG evaluation (port of rainier_tpu/compute/interp.py).

One evaluation core serves two backends:

* ``torch`` — used by :mod:`rainier_tpu_torch.compute.compiler`: walking
  the DAG once per call issues the PyTorch ops of the density, and
  autograd supplies the gradient.  Counterpart of the JAX package's
  ``_JaxBackend`` (rainier_tpu/compute/interp.py:70-112).
* ``numpy`` — a slow interpreted oracle, the analogue of
  compute/Evaluator.scala (rainier_tpu/compute/interp.py:29-67).

Evaluation is iterative (explicit topological order) so arbitrarily deep
user folds cannot blow Python's stack, and memoized per node id so shared
subgraphs are computed once.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Mapping

import numpy as np
import torch

from . import real as R


class _NumpyBackend:
    name = "numpy"

    def __init__(self):
        self.np = np

    def asarray(self, x, dtype):
        return np.asarray(x, dtype=dtype)

    def where(self, c, t, f):
        with np.errstate(all="ignore"):
            return np.where(c, t, f)

    def logsumexp(self, stacked):
        from scipy.special import logsumexp

        return logsumexp(stacked, axis=0)

    def sigmoid(self, x):
        from scipy.special import expit

        return expit(x)

    def softplus(self, x):
        return np.logaddexp(0.0, x)

    def lgamma(self, x):
        from scipy.special import gammaln

        return gammaln(x)

    def take(self, arr, idx):
        return np.take(arr, idx, axis=0, mode="clip")

    def take_along0(self, stacked, idx):
        idx = np.clip(idx, 0, stacked.shape[0] - 1)
        return np.take_along_axis(stacked, idx[None], axis=0)[0]

    def matvec(self, mat, vec):
        return mat @ vec

    def to_int(self, x):
        return np.asarray(x).astype(np.int32)

    def ndim(self, x):
        return np.ndim(x)

    def sum0(self, v):
        return np.sum(v, axis=0, keepdims=True)


# numpy-named elementwise ops over torch, so _unary_val/_binary_val serve
# both backends unchanged
def _abs(x):
    # jax.grad(abs)(0.) == 1: the select form gives autograd the same
    # derivative at 0 (torch.abs gives 0 there)
    return torch.where(x >= 0, x, -x)


_TORCH_NS = SimpleNamespace(
    exp=torch.exp, log=torch.log, log1p=torch.log1p, expm1=torch.expm1,
    abs=_abs, sqrt=torch.sqrt, sin=torch.sin, cos=torch.cos,
    tan=torch.tan, arcsin=torch.asin, arccos=torch.acos,
    arctan=torch.atan, sinh=torch.sinh, cosh=torch.cosh, tanh=torch.tanh,
    power=torch.pow, minimum=torch.minimum, maximum=torch.maximum,
    sign=torch.sign, sum=torch.sum)


class _TorchBackend:
    """PyTorch ops on one device.  Constants are cached per (value,
    dtype), so a density evaluated thousands of times in the sampler
    uploads each literal once."""

    name = "torch"

    def __init__(self, device):
        self.np = _TORCH_NS
        self.device = torch.device(device)
        self._consts: dict = {}

    def asarray(self, x, dtype):
        if isinstance(x, float):
            key = (x, dtype)
            t = self._consts.get(key)
            if t is None:
                t = self._consts[key] = torch.tensor(x, dtype=dtype,
                                                     device=self.device)
            return t
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def where(self, c, t, f):
        return torch.where(c, t, f)

    def logsumexp(self, stacked):
        return torch.logsumexp(stacked, dim=0)

    def sigmoid(self, x):
        return torch.sigmoid(x)

    def softplus(self, x):
        return torch.nn.functional.softplus(x)

    def lgamma(self, x):
        return torch.lgamma(x)

    def take(self, arr, idx):
        idx = torch.as_tensor(idx, device=arr.device).long()
        return arr[idx.clamp(0, arr.shape[0] - 1)]

    def take_along0(self, stacked, idx):
        idx = idx.long().clamp(0, stacked.shape[0] - 1)
        return torch.gather(stacked, 0, idx[None])[0]

    def matvec(self, mat, vec):
        # f32 products with f32 accumulation: TF32 is off process-wide
        # (rainier_tpu_torch.config), the counterpart of the JAX package's
        # precision="highest"
        return torch.matmul(mat, vec)

    def to_int(self, x):
        return torch.as_tensor(x, device=self.device).to(torch.int32)

    def ndim(self, x):
        return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)

    def sum0(self, v):
        return torch.sum(v, dim=0, keepdim=True)


NUMPY_BACKEND = _NumpyBackend()


def _gather(backend, node, memo):
    """A Gather's value: the source's rows at the index, clamped.  A
    literal index (``vec[i]``) is read on the host: as a 0-dim tensor on
    the card, indexing by it would wait for the device at every call."""
    src = memo[node.source.id]
    if isinstance(node.index, R.Constant) and np.ndim(node.index.value) == 0:
        return src[min(max(int(node.index.value), 0), src.shape[0] - 1)]
    return backend.take(src, backend.to_int(memo[node.index.id]))


def torch_backend(device) -> _TorchBackend:
    return _TorchBackend(device)


def _unary_val(be, op: str, v):
    xp = be.np
    if op == "neg":
        return -v
    if op == "exp":
        return xp.exp(v)
    if op == "log":
        return xp.log(v)
    if op == "log1p":
        return xp.log1p(v)
    if op == "expm1":
        return xp.expm1(v)
    if op == "abs":
        return xp.abs(v)
    if op == "sqrt":
        return xp.sqrt(v)
    if op == "sin":
        return xp.sin(v)
    if op == "cos":
        return xp.cos(v)
    if op == "tan":
        return xp.tan(v)
    if op == "asin":
        return xp.arcsin(v)
    if op == "acos":
        return xp.arccos(v)
    if op == "atan":
        return xp.arctan(v)
    if op == "sinh":
        return xp.sinh(v)
    if op == "cosh":
        return xp.cosh(v)
    if op == "tanh":
        return xp.tanh(v)
    if op == "logistic":
        return be.sigmoid(v)
    if op == "logit":
        return xp.log(v) - xp.log1p(-v)
    if op == "softplus":
        return be.softplus(v)
    if op == "lgamma":
        return be.lgamma(v)
    raise ValueError(op)


def _binary_val(be, op: str, a, b):
    xp = be.np
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b
    if op == "pow":
        return xp.power(a, b)
    if op == "min":
        return xp.minimum(a, b)
    if op == "max":
        return xp.maximum(a, b)
    raise ValueError(op)


def _pred_val(be, pred: str, a, b):
    if pred == "eq":
        return a == b
    if pred == "lt":
        return a < b
    if pred == "gt":
        return a > b
    if pred == "lte":
        return a <= b
    if pred == "gte":
        return a >= b
    raise ValueError(pred)


def _broadcast_all(be, vals):
    if be.name == "numpy":
        shape = np.broadcast_shapes(*[np.shape(v) for v in vals])
        return [np.broadcast_to(np.asarray(v), shape) for v in vals]
    shape = torch.broadcast_shapes(*[v.shape for v in vals])
    return [v.expand(shape) for v in vals]


def _broadcast_stack(be, vals):
    stack = np.stack if be.name == "numpy" else torch.stack
    return stack(_broadcast_all(be, vals))


def evaluate(roots, env: Mapping[int, object], backend, dtype):
    """Evaluate `roots` given `env` (node.id -> value for leaves).

    Returns a list of values aligned with roots.  Non-leaf nodes are
    computed in topological order with per-node memoization.
    """
    xp = backend.np
    memo: dict[int, object] = dict(env)
    errstate = (np.errstate(all="ignore") if backend.name == "numpy"
                else contextlib.nullcontext())
    with errstate:
        for node in R.topological(list(roots)):
            nid = node.id
            if nid in memo:
                continue
            if isinstance(node, R.Constant):
                memo[nid] = backend.asarray(node.value, dtype)
            elif isinstance(node, (R.Column, R.MatColumn)):
                memo[nid] = backend.asarray(node.values, dtype)
            elif isinstance(node, R.IntColumn):
                memo[nid] = backend.to_int(node.values)
            elif isinstance(node, R.MatVec):
                memo[nid] = backend.matvec(memo[node.mat.id],
                                           memo[node.vec.id])
            elif isinstance(node, (R.Parameter, R.VectorParameter)):
                raise KeyError(
                    f"no value bound for parameter {node!r} ({node.name})")
            elif isinstance(node, R.Unary):
                memo[nid] = _unary_val(backend, node.op, memo[node.child.id])
            elif isinstance(node, R.Binary):
                memo[nid] = _binary_val(backend, node.op, memo[node.left.id],
                                        memo[node.right.id])
            elif isinstance(node, R.NArySum):
                acc = memo[node.children[0].id]
                for c in node.children[1:]:
                    acc = acc + memo[c.id]
                memo[nid] = acc
            elif isinstance(node, R.LogSumExp):
                stacked = _broadcast_stack(
                    backend, [memo[c.id] for c in node.children])
                memo[nid] = backend.logsumexp(stacked)
            elif isinstance(node, R.Select):
                cond = _pred_val(backend, node.pred, memo[node.left.id],
                                 memo[node.right.id])
                memo[nid] = backend.where(cond, memo[node.if_true.id],
                                          memo[node.if_false.id])
            elif isinstance(node, R.Compare):
                a, b = memo[node.left.id], memo[node.right.id]
                memo[nid] = xp.sign(a - b)
            elif isinstance(node, R.Lookup):
                idx = backend.to_int(memo[node.index.id]) - node.low
                vals = [memo[t.id] for t in node.table]
                if backend.ndim(idx) == 0:
                    memo[nid] = backend.take(_broadcast_stack(backend, vals),
                                             idx)
                else:
                    *vals, idx = _broadcast_all(backend, vals + [idx])
                    stack = np.stack if backend.name == "numpy" \
                        else torch.stack
                    memo[nid] = backend.take_along0(stack(vals), idx)
            elif isinstance(node, R.Gather):
                memo[nid] = _gather(backend, node, memo)
            elif isinstance(node, (R.RowSum, R.VecSum)):
                v = memo[node.child.id]
                count = node.n_rows if isinstance(node, R.RowSum) else node.k
                if backend.ndim(v) == 0:
                    memo[nid] = v * count
                else:
                    memo[nid] = xp.sum(v)
            else:
                raise TypeError(f"unknown node {type(node)}")
    return [memo[r.id] for r in roots]


def evaluate_lanes(roots, env: Mapping[int, object], backend, dtype):
    """Batched chains-on-lanes evaluation (rainier_tpu interp.py:299-395).

    Same DAG, evaluated for a whole block of chains at once with the
    chain axis LAST and the observation axis first.  Shape conventions,
    enforced by the caller's env bindings:

    * scalar-valued node         → ()  or (1, C)
    * Parameter                  → (1, C)
    * VectorParameter (k slots)  → (k, C)
    * Column                     → (n, 1)   (data broadcasts over chains)
    * IntColumn                  → (n,) int (gather indices)
    * MatColumn                  → (n, p)
    * column-shaped intermediate → (n, C)

    `MatVec` is a direct (n,p)@(p,C) matmul.  Lookup is a masked sum over
    the table entries (branch-free, differentiable); this is also what
    the CUDA emitter generates, so the plain and kernel versions agree.
    """
    xp = backend.np
    memo: dict[int, object] = dict(env)
    # a node bound in env is a leaf here, whatever lies below it
    for node in R.topological(list(roots), stop=memo):
        nid = node.id
        if nid in memo:
            continue
        if isinstance(node, R.Constant):
            memo[nid] = backend.asarray(node.value, dtype)
        elif isinstance(node, (R.Column, R.IntColumn, R.MatColumn)):
            raise KeyError(f"no value bound for column {node!r}")
        elif isinstance(node, (R.Parameter, R.VectorParameter)):
            raise KeyError(f"no value bound for parameter {node!r}")
        elif isinstance(node, R.MatVec):
            memo[nid] = backend.matvec(memo[node.mat.id],
                                       memo[node.vec.id])
        elif isinstance(node, R.Unary):
            memo[nid] = _unary_val(backend, node.op, memo[node.child.id])
        elif isinstance(node, R.Binary):
            memo[nid] = _binary_val(backend, node.op, memo[node.left.id],
                                    memo[node.right.id])
        elif isinstance(node, R.NArySum):
            acc = memo[node.children[0].id]
            for c in node.children[1:]:
                acc = acc + memo[c.id]
            memo[nid] = acc
        elif isinstance(node, R.LogSumExp):
            # pairwise max + shifted exp sum, as the JAX lanes evaluator
            vals = [memo[c.id] for c in node.children]
            m = vals[0]
            for v in vals[1:]:
                m = xp.maximum(m, v)
            s = xp.exp(vals[0] - m)
            for v in vals[1:]:
                s = s + xp.exp(v - m)
            memo[nid] = m + xp.log(s)
        elif isinstance(node, R.Select):
            cond = _pred_val(backend, node.pred, memo[node.left.id],
                             memo[node.right.id])
            memo[nid] = backend.where(cond, memo[node.if_true.id],
                                      memo[node.if_false.id])
        elif isinstance(node, R.Compare):
            memo[nid] = xp.sign(memo[node.left.id] - memo[node.right.id])
        elif isinstance(node, R.Lookup):
            # float index → int32 (truncation), minus low, masked sum
            idx = backend.to_int(memo[node.index.id]) - node.low
            if backend.ndim(idx) == 1:            # IntColumn index → (n, 1)
                idx = idx.reshape(-1, 1)
            acc = None
            for k, t in enumerate(node.table):
                term = backend.where(idx == k, memo[t.id],
                                     backend.asarray(0.0, dtype))
                acc = term if acc is None else acc + term
            memo[nid] = acc
        elif isinstance(node, R.Gather):
            memo[nid] = _gather(backend, node, memo)    # (k, C) -> (n, C)
        elif isinstance(node, (R.RowSum, R.VecSum)):
            v = memo[node.child.id]
            count = node.n_rows if isinstance(node, R.RowSum) else node.k
            if backend.ndim(v) == 0 or v.shape[0] == 1:
                memo[nid] = v * count
            else:
                memo[nid] = backend.sum0(v)
        else:
            raise TypeError(f"unknown node {type(node)}")
    return [memo[r.id] for r in roots]
