"""logistic100k built with the port's DSL, as benchmarks/models.py:145-159
builds it: alpha, betas ~ N(0, prior_sd²); y ~ Bernoulli(logistic(alpha +
X·betas)) over one design column read row by row."""


def build(rt, data, sizes):
    """(the Model, the coordinates collected: None for every one)."""
    from rainier_tpu_torch.compute import real as R

    x, y = data["x"], data["y"]
    alpha = rt.Normal(0, sizes["prior_sd"]).latent()
    betas = rt.Normal(0, sizes["prior_sd"]).latent_vec(x.shape[1])
    lin = alpha + R.MatVec(R.MatColumn(x), betas.element)
    lh = R.RowSum(rt.Bernoulli(lin.logistic()).log_density_at(
        R.Column(y)), len(y))
    return rt.Model.likelihood(lh), None
