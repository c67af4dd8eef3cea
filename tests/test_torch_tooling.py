"""The port's tooling against the JAX package's: ``rt.viz`` (summaries
equal for the same numpy input, every plot drawn under Agg),
``SBC.animate``'s terminal frames for the same repetitions,
``rt.inspection.graphviz`` for one build, ``cost`` against the emitter's
counts, ``trace`` on the CPU, and the program stages."""

import io
import json
import os
import re
import shutil

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.core import sbc as sbc_j
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.core import sbc as sbc_t
from rainier_tpu_torch.sampler import HMC, SamplerConfig

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(1.0, 2.0, 4000), "b": rng.gamma(2.0, 1.5, 4000),
            "c": rng.standard_t(3, 4000)}


# -- viz ----------------------------------------------------------------------


@pytest.mark.parametrize("prob", [0.5, 0.89, 0.999])
def test_summaries_equal_the_jax_packages(prob):
    """hdpi, precis, coeftab, standardize, mean and stddev give the JAX
    package's results on the same draws, exactly: both are the same numpy
    arithmetic."""
    d = _draws()
    for v in d.values():
        assert rtt.viz.hdpi(v, prob) == rtj.viz.hdpi(v, prob)
        np.testing.assert_array_equal(rtt.viz.standardize(v),
                                      rtj.viz.standardize(v))
        assert rtt.viz.mean(v) == rtj.viz.mean(v)
        assert rtt.viz.stddev(v) == rtj.viz.stddev(v)
    assert rtt.viz.precis(d, prob) == rtj.viz.precis(d, prob)
    models = {"m1": d, "m2": {"a": d["a"] + 1, "z": d["c"]}}
    assert rtt.viz.coeftab(models, prob) == rtj.viz.coeftab(models, prob)


def test_every_plot_draws(tmp_path):
    """Every plot draws under Agg, from arrays and from a (trace, Real)
    pair of the port, and `show` writes the png; `load_csv` reads numeric
    and text columns."""
    import matplotlib.pyplot as plt

    d = _draws(1)
    mu = rtt.Normal(0, 1).latent()
    model = rtt.Model.observe([0.3, -0.2, 0.5], rtt.Normal(mu, 1.0))
    tr = model.sample(SamplerConfig(30, 20, sampler=HMC(3)), n_chains=2,
                      device="cpu")
    xs = np.linspace(0, 1, 20)
    fig, ax = plt.subplots()
    rtt.viz.density(tr, mu, ax=ax, label="mu")
    rtt.viz.density(d["a"], bins=30, ax=ax)
    rtt.viz.scatter(d["a"], d["b"], ax=ax)
    rtt.viz.contour(d["a"], d["b"], bins=20, ax=ax)
    rtt.viz.line(xs, xs ** 2, ax=ax)
    rtt.viz.lines(xs, [xs, xs[:10] * 2], ax=ax, labels=["one"])
    rtt.viz.lines(xs, lambda x: [x, 2 * x], ax=ax)
    rtt.viz.shade(xs, xs - 0.1, xs + 0.1, ax=ax)
    rtt.viz.whiskers(d, ax=ax)
    path = rtt.viz.show("plots", str(tmp_path / "p.png"), ax=ax)
    assert os.path.getsize(path) > 0
    csv = tmp_path / "d.csv"
    csv.write_text("x,name\n1.5,a\n2,b\n")
    assert rtt.viz.load_csv(str(csv)) == rtj.viz.load_csv(str(csv)) == {
        "x": [1.5, 2.0], "name": ["a", "b"]}


# -- SBC.animate --------------------------------------------------------------


REPS = [(0, 1.002, 1, 900.0, 0.5), (3, 1.010, 2, 1100.0, 0.7),
        (1, 1.001, 1, 1024.0, 0.4), (3, 1.030, 3, 1300.0, 0.9),
        (2, 1.004, 1, 1000.0, 0.6), (3, 1.002, 1, 980.0, 0.5)]


def _frames(pkg, monkeypatch):
    """SBC.animate's text over the fixed repetitions REPS, through a
    `simulate` that yields them; the seconds left, which the wall clock
    sets, blanked."""
    reps = [pkg.Rep(rank=r, r_hat=h, thin=t, effective_sample_size=e,
                    seconds=s) for r, h, t, e, s in REPS]
    monkeypatch.setattr(pkg.SBC, "simulate",
                        lambda self, *a, **k: iter(reps))
    sbc = pkg.SBC.__new__(pkg.SBC)
    out = io.StringIO()
    got = sbc.animate(10, None, log_bins=2, reps=len(REPS), out=out)
    assert [r.rank for r in got] == [r[0] for r in REPS]
    return re.sub(r"~\d+s remaining", "~Ns remaining", out.getvalue())


def test_animate_prints_the_jax_packages_frames(monkeypatch):
    """The port's frames equal the JAX package's, character for
    character: the histogram, its 99% band and colours, r̂ and ESS/s."""
    text = _frames(sbc_t, monkeypatch)
    assert text == _frames(sbc_j, monkeypatch)
    assert text.count("Repetition ") == len(REPS)
    assert "max rHat 1.030" in text and "\033[32m" in text


# -- inspection ---------------------------------------------------------------


def _renumber(dot):
    """The DOT text with node ids (n<id>, and θ<id> in a parameter's
    label) numbered by first appearance."""
    ids = {}
    return re.sub(r"([nθ])(\d+)", lambda m: m.group(1) + str(
        ids.setdefault(m.group(2), len(ids))), dot)


def _glmm(rt):
    R = rtj.compute.real if rt is rtj else rtt.compute.real
    idx = R.IntColumn(np.arange(6) % 3)
    b = rt.Normal(0, 1).latent_vec(3)
    s = rt.Exponential(1).latent()
    return rt.Model.observe([1.0, 0.0, 2.0, 1.0, 0.5, 1.5], rt.Normal(
        R.Gather(b.element, idx) + s * R.Column(np.arange(6.0)), s))


@pytest.mark.parametrize("with_bounds", [False, True])
def test_graphviz_matches_the_jax_packages(with_bounds):
    """The same labels, bounds and edges as the JAX package's for one
    build, the ids renumbered."""
    lt = _glmm(rtt).density().likelihoods[0]
    lj = _glmm(rtj).density().likelihoods[0]
    assert _renumber(rtt.inspection.graphviz(lt, with_bounds)) == \
        _renumber(rtj.inspection.graphviz(lj, with_bounds))


def _logistic(n, p=4):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, p))
    ys = (rng.uniform(size=n) < 0.5).astype(float)
    alpha = rtt.Normal(0, 5).latent()
    betas = rtt.Normal(0, 5).latent_vec(p)
    R = rtt.compute.real
    return rtt.Model.likelihood(R.RowSum(rtt.Bernoulli(
        (alpha + R.MatVec(R.MatColumn(x), betas.element)).logistic())
        .log_density_at(R.Column(ys)), n))


def test_cost_scales_with_the_rows():
    """cost() is the emitter's count: flops density_ops(), bytes the
    columns plus q and g, and every count grows with the rows by the
    row's share (the logistic at 1000 and 3000 rows)."""
    small, large = _logistic(1000), _logistic(3000)
    c1, c3 = rtt.inspection.cost(small), rtt.inspection.cost(large)
    em = emit_cuda.emit(small.density())
    assert c1["flops"] == em.density_ops()
    assert c3["flops"] - c1["flops"] == 2000 * em.row_ops
    assert c1["bytes accessed"] == 4 * (1000 * 5 + 2 * 5 + 1)
    assert c3["bytes accessed"] - c1["bytes accessed"] == 4 * 2000 * 5
    per_row = (c3["transcendentals"] - c1["transcendentals"]) / 2000
    assert per_row == int(per_row) >= 2


def test_trace_writes_a_loadable_profile(tmp_path):
    """trace() on the CPU writes a Chrome-trace JSON under the directory it
    returns, with the sampling run's operations in it."""
    mu = rtt.Normal(0, 1).latent()
    model = rtt.Model.observe([0.1, 0.2], rtt.Normal(mu, 1.0))
    out = rtt.inspection.trace(model, SamplerConfig(10, 10), str(tmp_path),
                               n_chains=2, device="cpu")
    assert out == str(tmp_path)
    (name,) = [f for f in os.listdir(out) if f.endswith(".pt.trace.json")]
    with open(os.path.join(out, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_program_stages():
    """graph() is the aten program of logp+grad, source() the emitted
    header, and ptx() the card's program, which needs nvcc: without it,
    it raises, naming nvcc."""
    mu = rtt.Normal(0, 1).latent()
    model = rtt.Model.observe([0.1, 0.2], rtt.Normal(mu, 1.0))
    assert "torch.ops.aten" in rtt.inspection.graph(model)
    assert rtt.inspection.source(model) == emit_cuda.emit(
        model.density()).source
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            rtt.inspection.ptx(model)
    else:
        assert ".entry" in rtt.inspection.ptx(model)
