"""The plain references agree with the port's density on the CPU at a
small size, and the frozen Philox with the port's plain kernel's noise."""

import pytest
import torch

from portbench import philox
from portbench.run import ROOT
from portbench import manifest

SMALL = {"logistic100k": {"rows": 300}, "glmm_large": {"groups": 40}}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_matches_the_ports_density(name):
    import rainier_tpu_torch as rt

    bench = manifest.load(ROOT)
    cfg = manifest.config(ROOT, bench, name)
    sizes = dict(cfg.sizes, **SMALL[name])
    data = cfg.ref.make_data(sizes)
    model, _ = cfg.model.build(rt, data, sizes)
    cd = model.density()
    assert cd.n_vars == cfg.ref.dim(sizes)
    gen = torch.Generator().manual_seed(3)
    q = 0.3 * torch.randn(6, cd.n_vars, generator=gen, dtype=torch.float64)
    if name == "glmm_large":
        q[:, 2:] += 1.6
    lp, g = cd.batched_logp_and_grad_fn()(
        q, cd.column_values(torch.float64, "cpu"))
    lr, gr = cfg.ref.lp_grad(q, {k: torch.as_tensor(v)
                                 for k, v in data.items()}, sizes)
    assert torch.allclose(lp, lr, rtol=1e-10, atol=1e-8)
    assert torch.allclose(g, gr, rtol=1e-10, atol=1e-8)
    # the control's bfloat16 density is measurably off
    lb, gb = cfg.ref.lp_grad(q, {k: torch.as_tensor(v)
                                 for k, v in data.items()}, sizes,
                             low=torch.bfloat16)
    assert float((lb - lr).abs().max()) > 1e-3


def test_philox_matches_the_ports_plain_kernel_noise():
    from rainier_tpu_torch.ops import fused_hmc as F

    dim, n, seed = 11, 37, 2 ** 33 + 5
    for it in (0, 1, 999):
        p, u = F.philox_noise(seed, it, dim, n, "cpu")
        pr, ur = philox.noise(seed, it, dim, torch.arange(n))
        assert torch.equal(ur.float(), u)
        assert torch.allclose(pr, p.T.double(), rtol=1e-5, atol=1e-5)
    its = torch.tensor([0, 5, 5, 7])
    chains = torch.tensor([3, 0, 9, 36])
    pr, ur = philox.noise(seed, its, dim, chains)
    for j in range(4):
        p, u = F.philox_noise(seed, int(its[j]), dim, n, "cpu")
        assert torch.equal(ur[j].float(), u[chains[j]])
