"""glmm_large built with the port's DSL, as benchmarks/models.py:162-202
builds it: mu ~ N(0, 1), sd ~ Exponential(1), group effects ~ N(mu, sd)
at VIP weight lam, gathered by an integer column into a Poisson row."""

import numpy as np


def build(rt, data, sizes):
    """(the Model, the coordinates collected: mu, sd and every
    `collect_every_effect`-th group effect)."""
    from rainier_tpu_torch.compute import real as R

    groups = sizes["groups"]
    mu = rt.Normal(0, 1).latent()
    sd = rt.Exponential(1.0).latent()
    effects = rt.vip_latent_vec(mu, sd, groups, lam=sizes["lam"])
    log_lam = R.Gather(effects.element, R.IntColumn(data["group"]))
    lh = R.RowSum(rt.Poisson(log_lam.exp()).log_density_at(
        R.Column(data["y"])), len(data["y"]))
    collect = np.r_[0, 1, np.arange(2, 2 + groups,
                                    sizes["collect_every_effect"])]
    return rt.Model.likelihood(lh), collect
