"""Log-combinatoric functions (counterpart of core/Combinatorics.scala:9-35).

A copy of ``rainier_tpu/core/combinatorics.py``: ``gamma`` lowers to the
``lgamma`` unary, which PyTorch evaluates with ``torch.lgamma`` and the
CUDA emitter with ``lgammaf`` (its adjoint is a hand-written digamma).
"""

from __future__ import annotations

from ..compute import real as R


def gamma(z) -> R.Real:
    """log Γ(z)."""
    z = R.to_real(z)
    if isinstance(z, R.Constant):
        if z.value == 0.0:
            return R.infinity
        if z.value in (1.0, 2.0):
            return R.zero
    return z.lgamma()


def beta(a, b) -> R.Real:
    """log B(a,b)."""
    a, b = R.to_real(a), R.to_real(b)
    return gamma(a) + gamma(b) - gamma(a + b)


def factorial(k) -> R.Real:
    """log k!"""
    return gamma(R.to_real(k) + 1)


def choose(n, k) -> R.Real:
    """log C(n,k)."""
    n, k = R.to_real(n), R.to_real(k)
    return factorial(n) - factorial(k) - factorial(n - k)
