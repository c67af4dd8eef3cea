"""Triangular and Cholesky helpers (port of rainier_tpu/compute/cholesky.py;
counterpart of compute/Cholesky.scala:9-99 and the primitive kernels in
sampler/MassMatrix.scala:33-118).

Every function is batched over leading dimensions, so a (C, n, n) stack
of one matrix a chain goes through one call.  The factorization and the
solves are ``torch.linalg`` calls, as the JAX package's are
``jnp.linalg`` and ``jax.scipy.linalg`` calls outside any kernel.
"""

from __future__ import annotations

import math

import torch


def packed_size(n: int) -> int:
    return n * (n + 1) // 2


def matrix_size(packed_len: int) -> int:
    n = int((math.sqrt(8 * packed_len + 1) - 1) / 2)
    if packed_size(n) != packed_len:
        raise ValueError(f"{packed_len} is not a triangular number")
    return n


def pack_lower(mat):
    """Square (..., n, n) -> packed row-major lower triangle
    (..., n*(n+1)/2)."""
    n = mat.shape[-1]
    i, j = torch.tril_indices(n, n, device=mat.device)
    return mat[..., i, j]


def unpack_lower(packed, n: int):
    """Packed lower triangle -> square (..., n, n) with zeros above the
    diagonal."""
    i, j = torch.tril_indices(n, n, device=packed.device)
    out = packed.new_zeros(packed.shape[:-1] + (n, n))
    out[..., i, j] = packed
    return out


def cholesky_lower(mat):
    """Lower-triangular Cholesky factor of an SPD matrix.  A matrix that
    is not positive definite gives NaN in the lower triangle, as
    ``jnp.linalg.cholesky`` does, instead of raising (which would also
    wait for the device)."""
    L, info = torch.linalg.cholesky_ex(mat)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


def log_determinant(packed_l):
    """log|A| from the packed lower Cholesky factor of A = L Lᵀ
    (Cholesky.logDeterminant, compute/Cholesky.scala)."""
    n = matrix_size(packed_l.shape[-1])
    diag_idx = torch.tensor([packed_size(i + 1) - 1 for i in range(n)],
                            device=packed_l.device)
    return 2.0 * torch.sum(torch.log(packed_l[..., diag_idx]), dim=-1)


def lower_triangular_solve(L, b):
    """Solve L x = b for x, b (..., n)."""
    return torch.linalg.solve_triangular(L, b[..., None],
                                         upper=False)[..., 0]


def upper_triangular_solve(U, b):
    """Back substitution U x = b (DenseMassMatrix.upperTriangularSolve,
    sampler/MassMatrix.scala:55-72)."""
    return torch.linalg.solve_triangular(U, b[..., None],
                                         upper=True)[..., 0]


def inverse_multiply(packed_l, vec):
    """Solve A x = vec given the packed lower Cholesky factor of A
    (forward then back substitution; Cholesky.inverseMultiply)."""
    L = unpack_lower(packed_l, vec.shape[-1])
    y = lower_triangular_solve(L, vec)
    return upper_triangular_solve(L.transpose(-1, -2), y)
