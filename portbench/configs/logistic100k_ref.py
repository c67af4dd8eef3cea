"""Plain reference of logistic100k: its data from a seed, its log density
and gradient in the sampler's coordinates, and the work one gradient
evaluation needs.  Imports numpy and torch only.

The sampler's coordinates are z, with alpha = s·z₀ and betas = s·z₁..ₚ for
the prior scale s, each z standard normal a priori:

    lp(z) = Σⱼ (−zⱼ²/2 − log √(2π)) + Σᵣ (yᵣ·ηᵣ − softplus(ηᵣ)),
    ηᵣ = s·(z₀ + xᵣ·z₁..ₚ),
    ∂lp/∂z₀ = −z₀ + s·Σᵣ (yᵣ − σ(ηᵣ)),  ∂lp/∂zⱼ = −zⱼ + s·Σᵣ xᵣⱼ (yᵣ − σ(ηᵣ)).
"""

import math

import numpy as np
import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def make_data(sizes):
    """x (rows, features) and y (rows,) as benchmarks/models.py:145-159
    draws them, x rounded to float32 so both sides read the same values."""
    rng = np.random.default_rng(sizes["data_seed"])
    n, p = sizes["rows"], sizes["features"]
    x = rng.normal(size=(n, p)).astype(np.float32).astype(np.float64)
    b = rng.normal(size=p)
    logits = x @ b + sizes["intercept"]
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float64)
    return {"x": x, "y": y}


def dim(sizes):
    return sizes["features"] + 1


def lp_grad(q, data, sizes, low=None):
    """q (n, dim) float64 -> (lp (n,), gradient (n, dim)) float64.  With
    `low` a dtype (the control's bfloat16) the rows' inputs and arithmetic
    run in it and their sums in float32."""
    s = sizes["prior_sd"]
    dt = low or torch.float64
    acc = torch.float32 if low is not None else torch.float64
    x, y = data["x"], data["y"]
    lp = -0.5 * (q * q).sum(1) - q.shape[1] * HALF_LOG_2PI
    g = -q.clone()
    qd = q.to(dt)
    block = max(1, (1 << 24) // q.shape[0])
    for a in range(0, x.shape[0], block):
        xb, yb = x[a:a + block].to(dt), y[a:a + block].to(dt)
        eta = s * (qd[:, :1] + (qd[:, 1:].to(acc) @ xb.to(acc).T).to(dt))
        e = torch.exp(-eta.abs())
        lp += (yb * eta - (eta.clamp(min=0) + torch.log1p(e))).to(
            acc).sum(1).double()
        r1 = 1.0 / (1.0 + e)
        resid = (yb - torch.where(eta >= 0, r1, e * r1)).to(acc)
        g[:, 0] += s * resid.sum(1).double()
        g[:, 1:] += s * (resid @ xb.to(acc)).double()
    return lp, g


def hess_diag(q, data, sizes):
    """q (n, dim) float64 -> the diagonal of −∇²lp at q (n, dim) float64:
    1 + s²·Σᵣ σ(ηᵣ)(1 − σ(ηᵣ)) for the intercept, the same weighted by
    xᵣⱼ² for each feature."""
    s = sizes["prior_sd"]
    x = data["x"]
    h = torch.ones_like(q)
    block = max(1, (1 << 24) // q.shape[0])
    for a in range(0, x.shape[0], block):
        xb = x[a:a + block]
        eta = s * (q[:, :1] + q[:, 1:] @ xb.T)
        w = torch.sigmoid(eta) * torch.sigmoid(-eta)
        h[:, 0] += s * s * w.sum(1)
        h[:, 1:] += s * s * (w @ (xb * xb))
    return h


def work(sizes):
    """One gradient evaluation of one chain, by the prices of
    portbench/work.py: float32 operations and special-function results.
    A row: η (an FMA a feature, the intercept's add, the scale's
    multiply), |η|, exp(−|η|), softplus (a max, log1p, an add), y·η −
    softplus and its sum (FMA, add), σ(η) (an add, a reciprocal, a
    multiply and a select), y − σ, the gradient (an FMA a feature, the
    intercept's add).  The prior: 4 a coordinate."""
    from portbench.work import ops, sfu

    p, n = sizes["features"], sizes["rows"]
    row = (2 * p + 2 + 1 + ops("exp") + 1 + ops("log1p") + 1 + 2 + 1
           + 1 + ops("recip") + 2 + 1 + 2 * p + 1)
    row_sfu = sfu("exp") + sfu("log1p") + sfu("recip")
    return {"dim": p + 1, "ops_row": row, "sfu_row": row_sfu,
            "ops_grad": n * row + 4 * (p + 1), "sfu_grad": n * row_sfu,
            "ops_launch": 0, "sfu_launch": 0,
            "bytes_columns": 4 * n * (p + 1)}
