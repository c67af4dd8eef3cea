"""Plain reference of glmm_large: its data from a seed, its log density
and gradient in the sampler's coordinates, and the work one gradient
evaluation needs.  Imports numpy and torch only.

The sampler's coordinates are (mu, s, e₁..e_G) with sd = exp(s) and, at
VIP weight 1 (centred), the group effects eᵢ themselves:

    lp = −mu²/2 − log √(2π) + s − eˢ
         + Σᵢ (−(eᵢ − mu)²/(2 sd²) − log √(2π) − s)
         + Σᵣ (yᵣ·e_{g(r)} − exp(e_{g(r)}) − log yᵣ!),
    ∂lp/∂eᵢ = −(eᵢ − mu)/sd² + Σ_{r in group i} (yᵣ − exp(eᵢ)),
    ∂lp/∂mu = −mu + Σᵢ (eᵢ − mu)/sd²,
    ∂lp/∂s = 1 − eˢ + Σᵢ ((eᵢ − mu)²/sd² − 1).
"""

import math

import numpy as np
import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def make_data(sizes):
    """group (rows,) and y (rows,) as benchmarks/models.py:162-202 draws
    them: each group's true log rate ~ N(log 5, 0.3), its counts Poisson."""
    if sizes["lam"] != 1.0:
        raise ValueError("the reference is written for the centred "
                         "effects, lam = 1.0")
    rng = np.random.default_rng(sizes["data_seed"])
    groups, k = sizes["groups"], sizes["rows_per_group"]
    true = rng.normal(sizes["true_log_rate"], sizes["true_sd"], size=groups)
    y = rng.poisson(np.exp(np.repeat(true, k))).astype(np.float64)
    return {"group": np.repeat(np.arange(groups), k), "y": y}


def dim(sizes):
    return sizes["groups"] + 2


def lp_grad(q, data, sizes, low=None):
    """q (n, dim) float64 -> (lp (n,), gradient (n, dim)) float64.  With
    `low` a dtype (the control's bfloat16) every elementwise operation
    runs in it and the sums in float32."""
    dt = low or torch.float64
    acc = torch.float32 if low is not None else torch.float64
    idx, y = data["group"], data["y"].to(dt)
    qd = q.to(dt)
    mu, s, e = qd[:, 0], qd[:, 1], qd[:, 2:]
    inv = torch.exp(-2.0 * s)[:, None]
    d = e - mu[:, None]
    t = d * inv
    groups = e.shape[1]
    lp = (-0.5 * q[:, 0] ** 2 - HALF_LOG_2PI + q[:, 1] - torch.exp(q[:, 1])
          - groups * (HALF_LOG_2PI + q[:, 1]))
    lp = lp + (-0.5 * d * t).to(acc).sum(1).double()
    g = torch.empty_like(q)
    g[:, 0] = -q[:, 0] + t.to(acc).sum(1).double()
    g[:, 1] = 1.0 - torch.exp(q[:, 1]) - groups + (d * t).to(acc).sum(
        1).double()
    ge = (-t).to(acc)
    ee = e[:, idx]
    rate = torch.exp(ee)
    lp = lp + (y * ee - rate).to(acc).sum(1).double() - torch.lgamma(
        data["y"] + 1.0).sum()
    g[:, 2:] = ge.index_add(1, idx, (y - rate).to(acc)).double()
    return lp, g


def hess_diag(q, data, sizes):
    """q (n, dim) float64 -> the diagonal of −∇²lp at q (n, dim) float64:
    1 + G/sd² for mu, eˢ + 2·Σᵢ (eᵢ − mu)²/sd² for s, and
    1/sd² + kᵢ·exp(eᵢ) for the effect of a group of kᵢ rows."""
    mu, s, e = q[:, 0], q[:, 1], q[:, 2:]
    inv = torch.exp(-2.0 * s)
    d = e - mu[:, None]
    groups = e.shape[1]
    k = torch.bincount(data["group"], minlength=groups).to(q.dtype)
    h = torch.empty_like(q)
    h[:, 0] = 1.0 + groups * inv
    h[:, 1] = torch.exp(s) + 2.0 * (d * d).sum(1) * inv
    h[:, 2:] = inv[:, None] + k * torch.exp(e)
    return h


def work(sizes):
    """One gradient evaluation of one chain, by the prices of
    portbench/work.py: float32 operations and special-function results.
    A group: eᵢ − mu, its product with 1/sd², the prior's term and sum (a
    multiply, an FMA), the three gradients' parts (a negation, an add, an
    FMA) and exp(eᵢ), the rate all its rows read.  A row: y·e − rate and
    its sum (an FMA, an add), y − rate into the group's gradient (two
    adds).  Once a launch, the data-only log y!."""
    from portbench.work import ops, sfu

    groups = sizes["groups"]
    rows = groups * sizes["rows_per_group"]
    group = 1 + 1 + 3 + 1 + 1 + 2 + ops("exp")
    row = 3 + 2
    return {"dim": groups + 2, "ops_row": row, "ops_group": group,
            "sfu_group": sfu("exp"),
            "ops_grad": groups * group + rows * row + 10,
            "sfu_grad": groups * sfu("exp"),
            "ops_launch": rows * (ops("lgamma") + 1),
            "sfu_launch": rows * sfu("lgamma"),
            "bytes_columns": 8 * rows}
