"""Checkpoint / resume for sampler state (port of
rainier_tpu/parallel/checkpoint.py).

The adaptation product of a run (step size, mass matrix, final chain
positions) is a tree of tensors and arrays; it is saved as one ``.npz``
of its leaves, ``leaf_0`` ... in flattening order, plus a
``__treedef__`` string describing the tree (no pickle), written beside
the target and renamed over it.

The leaves are ordered as ``jax.tree.flatten`` orders them, so a file
written by either package loads in the other: a dict's values by sorted
key, a tuple's or NamedTuple's fields in order, and ``None`` has no leaf
(``torch.utils._pytree`` would keep insertion order and give ``None`` a
leaf).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _describe(tree) -> str:
    """The tree's structure with `*` for each leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _unflatten(like, leaves):
    """`like`'s tree with its leaves taken in order from the iterator
    `leaves`, each of the type of `like`'s leaf there."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        vals = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    return arr


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, tree) -> None:
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(_flatten(tree))}
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, __treedef__=json.dumps(_describe(tree)), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like_tree):
    """Restore into the structure of `like_tree` (its leaf order must be
    the file's): a tensor leaf comes back on that tensor's device and in
    its dtype, any other leaf as an array."""
    with np.load(path, allow_pickle=False) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    n = len(_flatten(like_tree))
    if n != len(leaves):
        raise ValueError(f"{path} holds {len(leaves)} leaves, the tree "
                         f"to restore has {n}")
    return _unflatten(like_tree, iter(leaves))


def resume_config(trace, base_config):
    """Build a SamplerConfig that resumes sampling with the adaptation
    product of a finished run: static step size + static mass (per-chain
    values are averaged — use per-chain resume via sampler state for exact
    continuation)."""
    from ..sampler import config as C

    step = float(np.mean(_host(trace.step_size)))
    mass = trace.mass
    if mass.diag is not None:
        m = C.StaticMassMatrix(diag=np.mean(_host(mass.diag), axis=0))
    elif mass.cov is not None:
        m = C.StaticMassMatrix(cov=np.mean(_host(mass.cov), axis=0))
    else:
        m = C.IdentityMassMatrix()
    return dataclasses.replace(base_config, warmup_iterations=0,
                               step_size=C.StaticStepSize(step),
                               mass_matrix=m)
