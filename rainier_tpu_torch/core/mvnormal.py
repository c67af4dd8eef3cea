"""Multivariate normal distribution (port of rainier_tpu/core/mvnormal.py).

A constant-covariance multivariate normal: a correlated latent block,
non-centered (x = μ + L z with z ~ N(0, I) unconstrained, so HMC sees
unit-scale geometry), and an observation model over (n, k) data.  The
Cholesky factor L, its inverse W = L⁻¹ and the log-determinant are
computed once in numpy f64, as the JAX package does; L enters the graph
as a (k, k) ``MatColumn``, which the fused kernel reads whole.

The covariance is a fixed numpy matrix; the mean may be any length-k
structure of Reals.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from ..compute import real as R
from ..compute.vec import Vec
from .generator import Generator


def _mean_exprs(mu, k: int) -> list:
    if isinstance(mu, Vec):
        return mu.to_list()
    if isinstance(mu, (list, tuple)):
        return [R.to_real(m) for m in mu]
    m = R.to_real(mu)
    return [m] * k


class MVNormal:
    def __init__(self, mu: Union[Sequence, Vec, float], cov):
        self.cov = np.asarray(cov, dtype=np.float64)
        if self.cov.ndim != 2 or self.cov.shape[0] != self.cov.shape[1]:
            raise ValueError("cov must be square")
        self.k = self.cov.shape[0]
        self.chol = np.linalg.cholesky(self.cov)
        self.prec_chol = np.linalg.inv(self.chol)  # W = L⁻¹
        self.log_det = 2.0 * float(np.sum(np.log(np.diag(self.chol))))
        self.mu = _mean_exprs(mu, self.k)
        if len(self.mu) != self.k:
            raise ValueError("mean length must match cov")

    # -- latent -----------------------------------------------------------
    def latent_vec(self) -> Vec:
        """k correlated latents, non-centered: x = μ + L z, z ~ N(0, I)."""
        z = R.vector_parameter(
            self.k, lambda p: -(p * p) / 2 - 0.5 * math.log(2 * math.pi))
        Lz = R.MatVec(R.MatColumn(self.chol), z)
        elems = [R.Gather(Lz, R.const(i)) + self.mu[i]
                 for i in range(self.k)]
        return Vec(elements=elems, n=self.k)

    # -- observation density ---------------------------------------------
    def log_density(self, X) -> R.Real:
        """Summed log-density of (n, k) observations."""
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        n = X.shape[0]
        if X.shape[1] != self.k:
            raise ValueError("observation width != k")
        # z_i = W x_i − W μ; per-row density −||z_i||²/2 − logdet/2 − c
        WX = X @ self.prec_chol.T                  # precomputed data
        wx_cols = [R.Column(WX[:, j]) for j in range(self.k)]
        wmu = []
        for j in range(self.k):
            wmu.append(R.sum_([
                float(self.prec_chol[j, i]) * self.mu[i]
                for i in range(self.k)
                if abs(self.prec_chol[j, i]) > 0.0]))
        per_row = R.sum_([
            (wx_cols[j] - wmu[j]) * (wx_cols[j] - wmu[j])
            for j in range(self.k)])
        const = -0.5 * self.log_det - 0.5 * self.k * math.log(2 * math.pi)
        return R.RowSum(per_row * -0.5 + const, n)

    def log_density_at(self, xs: Sequence) -> R.Real:
        """Density of one k-vector of Reals (symbolic observation)."""
        xs = [R.to_real(x) for x in xs]
        terms = []
        for j in range(self.k):
            zj = R.sum_([float(self.prec_chol[j, i]) * (xs[i] - self.mu[i])
                         for i in range(self.k)])
            terms.append(zj * zj)
        const = -0.5 * self.log_det - 0.5 * self.k * math.log(2 * math.pi)
        return R.sum_(terms) * -0.5 + const

    def generator(self) -> Generator:
        """Draws μ + L z, z ~ N(0, I): (k, ...) over the env's batch."""
        chol, mu, k = self.chol, self.mu, self.k

        def fn(gen, env):
            shape = env.shape(*mu)
            z = torch.randn((k,) + shape, generator=gen, dtype=env.dtype,
                            device=env.device)
            L = torch.as_tensor(chol, dtype=env.dtype, device=env.device)
            Lz = torch.tensordot(L, z, dims=1)
            return torch.stack([env(m).expand(shape) for m in mu]) + Lz

        return Generator(fn, frozenset(self.mu))
