"""A run on the CPU at a small size, past the harness's look for a card:
sound, `correct` comes out true; with the timed path broken underneath,
false.  The faults the cells can have: a sampling step that returns its
state unchanged, half of the chains left out (their draws the start state),
a draw altered where the kernel produces it, warmup's gradient altered (on
every chain, or on the upper half of the batch alone), and warmup's
product left unchanged (all of it, its start state or its mass).  No cell
spans chips, so no exchange between chips can be left out."""

import pytest
import torch

from portbench import faults
from portbench.run import run_cell

SMALL = {"logistic100k.short": {"rows": 1500},
         "glmm_large.long": {"groups": 200}}
#: warmup long enough to close a mass window (50 + 50 + 50 iterations)
TRAFFIC = {"chains": 48, "warmup": 150, "draws": 20}


def _run(workload, traffic=TRAFFIC):
    import rainier_tpu_torch as rt

    rt.config.set_device("cpu")
    res, _ = run_cell(workload, 2 ** 35 + 3, 0.5, False, "cpu",
                      sizes=SMALL[workload], traffic=traffic)
    return res


def _over(res, name):
    c = res["checks"][name]
    return c["value"] > c["limit"]


def _kernel_fault(monkeypatch, fault):
    from rainier_tpu_torch.ops import fused_hmc as F

    plain = F.fused_hmc_reference

    def broken(density, q0, **kw):
        qf, samples, acc, div = plain(density, q0, **kw)
        fault(q0, samples, kw)
        return qf, samples, acc, div

    monkeypatch.setattr(F, "fused_hmc_reference", broken)


def _stuck(q0, samples, kw):
    idx = kw.get("collect_idx")
    start = q0 if idx is None else q0[torch.as_tensor(idx)]
    samples[:] = start


def _half(q0, samples, kw):
    idx = kw.get("collect_idx")
    start = q0 if idx is None else q0[torch.as_tensor(idx)]
    half = q0.shape[1] // 2
    samples[..., half:] = start[:, half:]


def _altered(q0, samples, kw):
    scale = torch.sqrt(torch.as_tensor(kw["inv_mass_diag"]))
    samples[:, 0, :] += 0.25 * scale[:, 0]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", [_stuck, _half, _altered],
                         ids=["unchanged", "half", "altered"])
def test_kernel_fault_is_caught(monkeypatch, workload, fault):
    _kernel_fault(monkeypatch, fault)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_warmup_gradient_fault_is_caught(monkeypatch, workload):
    from rainier_tpu_torch.compute import compiler

    orig = compiler.CompiledDensity.batched_logp_and_grad_fn

    def broken(self):
        lpg = orig(self)

        def lp_grad(q, cols):
            lp, g = lpg(q, cols)
            return lp, g * 1.01

        return lp_grad

    monkeypatch.setattr(compiler.CompiledDensity,
                        "batched_logp_and_grad_fn", broken)
    res = _run(workload)
    assert res["correct"] is False
    assert _over(res, "warm_grad")


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_warmup_gradient_fault_on_the_upper_half_is_caught(monkeypatch,
                                                          workload):
    """Past the replayed chains' lowest indices: 128 chains, of which the
    upper 64 get a gradient 5% off."""
    from rainier_tpu_torch.compute import compiler

    orig = compiler.CompiledDensity.batched_logp_and_grad_fn

    def broken(self):
        lpg = orig(self)

        def lp_grad(q, cols):
            lp, g = lpg(q, cols)
            g = g.clone()
            g[g.shape[0] // 2:] *= 1.05
            return lp, g

        return lp_grad

    monkeypatch.setattr(compiler.CompiledDensity,
                        "batched_logp_and_grad_fn", broken)
    res = _run(workload, dict(TRAFFIC, chains=128))
    assert res["correct"] is False
    assert _over(res, "warm_grad")


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault, caught_by", [
    ("warmup_unchanged", ("warm_q0", "warm_mass", "warm_alpha")),
    ("start_unchanged", ("warm_q0",)),
    ("mass_unchanged", ("warm_mass", "warm_alpha"))])
def test_warmup_product_fault_is_caught(workload, fault, caught_by):
    """By at least one of `caught_by` that the configuration compares
    (glmm_large compares no `warm_mass`: PERF.md)."""
    with faults.FAULTS[fault]():
        res = _run(workload)
    assert res["correct"] is False
    assert any(_over(res, n) for n in caught_by if n in res["checks"])


def test_a_number_the_run_does_not_read_fails_it(monkeypatch):
    """Warmup's density evaluated past the probe: its two numbers are
    missing, and the run is not correct."""
    from portbench import run

    start = run.Probes.start
    monkeypatch.setattr(run.Probes, "start",
                        lambda self, want: start(self, ()))
    res = _run("logistic100k.short")
    assert res["correct"] is False
    assert res["checks"]["warm_lp"]["value"] is None
    assert not _over(res, "miss")
