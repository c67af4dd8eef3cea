"""ADVI: automatic differentiation variational inference (port of
rainier_tpu/variational.py).

Mean-field and full-rank Gaussian families over the unconstrained
parameterization (the same latent transforms HMC uses, so any model that
samples can be fit variationally).  The ELBO is the reparameterization
estimate of the JAX package exactly, its entropy without the constant
n/2·(1 + log 2π), so ELBOs compare across the two packages; ``auto_vip``
compares them across candidates.

Its gradient comes by the chain rule from the density's own gradient at
the drawn points (one batched ``logp_and_grad`` call a step, no autograd
graph through the variational parameters): with z = mu + L·eps,
∂/∂mu = −mean ∇logp(z) and ∂/∂L = −mean ∇logp(z)·epsᵀ.  Adam is
``torch.optim.Adam`` with optax's defaults (betas (0.9, 0.999), eps 1e-8,
bias-corrected), where the JAX package uses ``optax.adam``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import config as global_config


class VariationalPosterior(NamedTuple):
    """Fitted q(z): mu (n,), either log_sigma (n,) [mean-field] or
    chol (n,n) lower [full-rank]."""

    mu: torch.Tensor
    log_sigma: Optional[torch.Tensor]
    chol: Optional[torch.Tensor]
    elbo_trace: np.ndarray
    model: object
    compiled: object

    def sample(self, n_draws: int, seed: int = 0) -> np.ndarray:
        gen = torch.Generator(device=self.mu.device).manual_seed(seed)
        eps = torch.randn((n_draws, self.mu.shape[0]), generator=gen,
                          dtype=self.mu.dtype, device=self.mu.device)
        if self.chol is not None:
            draws = self.mu + eps @ self.chol.T
        else:
            draws = self.mu + eps * torch.exp(self.log_sigma)
        return draws.cpu().numpy()

    def evaluate(self, exprs, n_draws: int = 1000, seed: int = 0):
        """Real expression(s) at `n_draws` draws of q, as
        ``Trace.evaluate`` gives them: float64 on the host, draws first."""
        from .core.trace import Trace

        draws = self.sample(n_draws, seed)[None]
        return Trace(draws, self.model, self.compiled, None).evaluate(exprs)

    def mean(self, expr, n_draws: int = 1000, seed: int = 0) -> float:
        return float(np.mean(self.evaluate(expr, n_draws, seed)))


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``'s update: b1 0.9, b2 0.999, eps 1e-8
    added to the bias-corrected sqrt(v), no eps_root."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def _chol(p):
    return torch.tril(p["l_off"], -1) + torch.diag(torch.exp(p["l_diag"]))


def neg_elbo_and_grad(lpg, p: dict, eps):
    """The JAX package's ``neg_elbo(p, key)`` at the draws `eps` (S, n)
    and its gradient in `p`'s keys: ``lpg(z (S, n)) -> (logp (S,), grad
    (S, n))`` is the model's batched density.  `p` holds mu and either
    log_sigma (mean-field) or l_off and l_diag (full-rank, L =
    tril(l_off, −1) + diag(exp(l_diag)))."""
    S = eps.shape[0]
    if "l_diag" in p:
        L = _chol(p)
        z = p["mu"] + eps @ L.T
        ent = torch.sum(p["l_diag"])
    else:
        scale = torch.exp(p["log_sigma"])
        z = p["mu"] + scale * eps
        ent = torch.sum(p["log_sigma"])
    lp, g = lpg(z)
    loss = -(torch.mean(lp) + ent)
    grads = {"mu": -torch.mean(g, dim=0)}
    if "l_diag" in p:
        dL = -(g.T @ eps) / S
        grads["l_off"] = torch.tril(dL, -1)
        grads["l_diag"] = torch.diagonal(dL) * torch.exp(p["l_diag"]) - 1.0
    else:
        grads["log_sigma"] = -torch.mean(g * eps, dim=0) * scale - 1.0
    return loss, grads


def advi(model, n_steps: int = 2000, n_samples: int = 8,
         learning_rate: float = 0.05, full_rank: bool = False,
         seed: int = 0, dtype=None, device=None) -> VariationalPosterior:
    """Fit q to the model's posterior; returns a VariationalPosterior.
    The draws of each step come from a ``torch.Generator`` seeded by
    `seed`, so they differ from the JAX package's.  The loss is kept
    every 50 steps and at the last, read from the device once, at the
    end."""
    dtype = dtype or global_config.dtype()
    dev = global_config.resolve_device(device)
    cd = model.density()
    cols = cd.column_values(dtype, dev)
    raw = cd.batched_logp_and_grad_fn()
    n = cd.n_vars

    def lpg(z):
        return raw(z, cols)

    def zeros():
        return torch.zeros(n, dtype=dtype, device=dev)

    if full_rank:
        p = {"mu": zeros(),
             "l_off": torch.zeros((n, n), dtype=dtype, device=dev),
             "l_diag": torch.full((n,), -1.0, dtype=dtype, device=dev)}
    else:
        p = {"mu": zeros(),
             "log_sigma": torch.full((n,), -1.0, dtype=dtype, device=dev)}
    opt = adam(list(p.values()), learning_rate)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    for i in range(n_steps):
        eps = torch.randn((n_samples, n), generator=gen, dtype=dtype,
                          device=dev)
        loss, grads = neg_elbo_and_grad(lpg, p, eps)
        for k, v in p.items():
            v.grad = grads[k]
        opt.step()
        if i % 50 == 0 or i == n_steps - 1:
            losses.append(loss)
    trace = -torch.stack(losses).cpu().numpy()
    if full_rank:
        return VariationalPosterior(mu=p["mu"], log_sigma=None,
                                    chol=_chol(p), elbo_trace=trace,
                                    model=model, compiled=cd)
    return VariationalPosterior(mu=p["mu"], log_sigma=p["log_sigma"],
                                chol=None, elbo_trace=trace, model=model,
                                compiled=cd)
