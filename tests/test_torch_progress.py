"""Progress, chunked sampling and the evaluator oracle in the port
(``sampler/progress.py``, ``sample(progress=, chunk_iters=,
sync_compile=)``, ``compute/evaluator.py``), held against the JAX
package's.

Checked here:

* ``Evaluator`` against the JAX package's on the same graphs and caches:
  equal, bit for bit (both numpy float64 over one interpreter);
* ``ConsoleProgress`` and ``HTMLProgress`` given the same stats (the
  port's as tensors, the JAX package's as arrays): the same text, the
  rates that depend on the wall clock masked;
* ``WindowedRates``: the window's accept rate, and no rate before a
  second refresh;
* ``chunk_iters=130`` on the scan path: exactly ``iterations // thin``
  draws, the same draws bit for bit as the unchunked run of the same
  seed (warmup keeps its window schedule across segments), and every
  posterior mean within 5 Monte-Carlo SE of the JAX package's chunked
  run; the progress lines name accept, E-BFMI and the window;
* ``compile_s`` on every path (scan, chunked, fused, fused with
  progress), ``compile_sync_s`` with ``sync_compile``;
* ``fused!`` with ``chunk_iters`` raises with the JAX package's words,
  ``fused`` warns and runs the scan path; ``fused!`` with a progress
  prints its three lines.
"""

import io
import math
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.compute import Evaluator as EvaluatorJ
from rainier_tpu.compute import real as Rj
from rainier_tpu.sampler import progress as progress_j
from rainier_tpu.sampler.stats import StatsState as StatsJ
from rainier_tpu_torch.compute import Evaluator as EvaluatorT
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.sampler import progress as progress_t
from rainier_tpu_torch.sampler.stats import StatsState as StatsT

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _R(rt):
    return Rj if rt is rtj else Rt


def oracle_exprs(rt):
    """Reals over a scalar and a vector parameter: a Normal and a Poisson
    log density, a LogSumExp, a Lookup and an elementwise vector
    expression."""
    R = _R(rt)
    x = R.parameter(lambda p: R.zero)
    v = R.vector_parameter(3, lambda p: R.zero)
    lam = x.exp()
    exprs = [rt.Normal(x, 2.0).log_density_at(R.const(0.3)),
             rt.Poisson(lam).log_density_at(R.const(4.0)),
             R.log_sum_exp([x, x * 2.0, R.const(-1.0)]),
             R.lookup(R.const(1.0), [x, x + 1.0, x * x]),
             v * x + 1.0,
             x.pow(3.0) / (1.0 + x.abs())]
    return x, v, exprs


@pytest.mark.parametrize("xv", [-1.3, 0.0, 0.7, 2.5])
def test_evaluator_matches_jax_exactly(xv):
    xt, vt, et = oracle_exprs(rtt)
    xj, vj, ej = oracle_exprs(rtj)
    vec = np.array([0.5, -1.0, 2.0])
    evt = EvaluatorT({xt: xv, vt: vec})
    evj = EvaluatorJ({xj: xv, vj: vec})
    for a, b in zip(et, ej):
        got, want = np.asarray(evt.value(a)), np.asarray(evj.value(b))
        np.testing.assert_array_equal(got, want)
    assert evt.to_double(et[0]) == evj.to_double(ej[0])
    assert evt.to_int(et[1]) == evj.to_int(ej[1])
    assert evt.to_long(et[2]) == evj.to_long(ej[2])


def _stats(k):
    """Two packages' StatsState from the same numbers (4 chains)."""
    rng = np.random.default_rng(k)
    f = rng.uniform(0.1, 5.0, (6, 4)).astype(np.float32)
    it = np.full(4, 50 * (k + 1), np.int32)
    fields = dict(iterations=it, divergences=np.array([0, 1, 0, 2 * k],
                                                      np.int32),
                  accept_sum=(f[0] * 10 * (k + 1)).astype(np.float32),
                  grad_evals=it * 5, prev_energy=f[1], energy_trans2=f[2],
                  e_count=f[3], e_mean=f[4], e_raw=f[5])
    return (StatsT(**{k_: torch.as_tensor(v) for k_, v in fields.items()}),
            StatsJ(**{k_: jnp.asarray(v) for k_, v in fields.items()}))


def _mask(text):
    return re.sub(r"grad evals/s [\d,]+", "grad evals/s R", text)


def _drive(p, stats, step):
    p.output_every_seconds = 0.0
    p.start(4)
    p.refresh("warmup", 50, 100, stats[0], step)
    p.refresh("sampling", 100, 100, stats[1], step)
    p.finish("complete", stats[1], step)


def test_console_progress_matches_jax():
    step = np.array([0.11, 0.2, 0.31, 0.05], np.float32)
    (s0t, s0j), (s1t, s1j) = _stats(0), _stats(1)
    bt, bj = io.StringIO(), io.StringIO()
    _drive(progress_t.ConsoleProgress(bt), (s0t, s1t), torch.as_tensor(step))
    _drive(progress_j.ConsoleProgress(bj), (s0j, s1j), jnp.asarray(step))
    got, want = _mask(bt.getvalue()), _mask(bj.getvalue())
    assert got == want, (got, want)
    assert "accept" in got and "E-BFMI" in got and "[window:" in got
    # throttled: a second refresh inside output_every_seconds prints nothing
    b = io.StringIO()
    p = progress_t.ConsoleProgress(b)
    p.start(4)
    p.refresh("warmup", 1, 2, s0t, torch.as_tensor(step))
    p.refresh("warmup", 2, 2, s1t, torch.as_tensor(step))
    assert len(b.getvalue().splitlines()) == 2


def test_html_progress_matches_jax():
    step = np.array([0.11, 0.2, 0.31, 0.05], np.float32)
    (s0t, s0j), (s1t, s1j) = _stats(0), _stats(1)
    pt, pj = progress_t.HTMLProgress(), progress_j.HTMLProgress()
    pt.MAX_ROWS = pj.MAX_ROWS = 3
    for p in (pt, pj):
        p.start(4)
    for (st, sj) in ((s0t, s0j), (s1t, s1j)):
        got = _mask(pt._render("sampling", 40, 100, st,
                               torch.as_tensor(step)))
        want = _mask(pj._render("sampling", 40, 100, sj, jnp.asarray(step)))
        assert got == want
    assert "1 more chains" in got and "window: accept" in got


def test_windowed_rates():
    (s0t, _), (s1t, _) = _stats(0), _stats(1)
    w = progress_t.WindowedRates()
    assert w.update(s0t) == (None, None)
    acc, rate = w.update(s1t)
    d_acc = float(s1t.accept_sum.sum() - s0t.accept_sum.sum())
    d_it = float(s1t.iterations.sum() - s0t.iterations.sum())
    assert acc == pytest.approx(d_acc / d_it, rel=1e-6)
    assert rate is None or rate > 0
    assert progress_t.SilentProgress.output_every_seconds > 1e99


def regression(rt, n=40):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=n)
    ys = 0.7 + 2.0 * xs + 0.3 * rng.normal(size=n)
    sigma = rt.Exponential(1).latent()
    alpha = rt.Normal(0, 1).latent()
    beta = rt.Normal(0, 1).latent()
    model = rt.Model.observe(list(ys), rt.Vec.from_(list(xs)).map(
        lambda x: rt.Normal(alpha + beta * x, sigma)))
    return model, [sigma, alpha, beta]


def _mean_se(x):
    from rainier_tpu_torch.core.trace import Trace

    ess = Trace(x[..., None], None, None, None).diagnostics(
        device=False)[0].effective_sample_size
    return float(x.mean()), float(x.std()) / math.sqrt(ess)


def test_chunked_scan_path():
    from rainier_tpu.sampler import HMC as HMCj, SamplerConfig as CfgJ

    model, exprs = regression(rtt)
    cfg = rtt.SamplerConfig(300, 203, sampler=rtt.HMC(5), thin=2)
    buf = io.StringIO()
    prog = progress_t.ConsoleProgress(buf)
    prog.output_every_seconds = 0.0
    tr = model.sample(cfg, n_chains=4, seed=3, chunk_iters=130,
                      progress=prog)
    ref = model.sample(cfg, n_chains=4, seed=3)
    assert tr.chains.shape == ref.chains.shape == (4, 101, 3)
    np.testing.assert_array_equal(tr.chains, ref.chains)
    np.testing.assert_array_equal(tr.stats.iterations, 202)
    out = buf.getvalue()
    assert "accept" in out and "E-BFMI" in out and "[window:" in out
    lines = out.splitlines()
    assert lines[0] == "sampling 4 chains"
    assert [ln.split()[1] for ln in lines[1:4]] == ["130/300", "260/300",
                                                    "300/300"]
    assert lines[-1].startswith("complete 202/202")
    assert "compile_s" in tr.timings and "compile_s" in ref.timings

    mj, exprs_j = regression(rtj)
    tj = mj.sample(CfgJ(300, 203, sampler=HMCj(5), thin=2), n_chains=4,
                   seed=3, chunk_iters=130)
    assert np.asarray(tj.chains).shape == (4, 101, 3)
    for et, ej in zip(exprs, exprs_j):
        a, se_a = _mean_se(tr.evaluate(et).reshape(4, -1))
        b, se_b = _mean_se(np.asarray(tj.evaluate(ej)).reshape(4, -1))
        assert abs(a - b) < 5 * math.hypot(se_a, se_b), (a, b)


def test_fused_paths_report_and_time():
    model, _ = regression(rtt)
    cfg = rtt.SamplerConfig(60, 40, sampler=rtt.HMC(3))
    with pytest.raises(ValueError, match="chunk_iters needs the scan path"):
        model.sample(cfg, n_chains=4, kernel="fused!", chunk_iters=20)
    with pytest.warns(UserWarning, match="falling back to the scan path"):
        tr = model.sample(cfg, n_chains=4, kernel="fused", chunk_iters=20)
    assert tr.chains.shape == (4, 40, 3) and "compile_s" in tr.timings
    buf = io.StringIO()
    tr = model.sample(cfg, n_chains=4, kernel="fused!",
                      progress=progress_t.ConsoleProgress(buf),
                      sync_compile=True)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 3 and lines[0] == "sampling 4 chains"
    assert lines[1].startswith("warmup complete 60/60")
    assert lines[2].startswith("complete 40/40")
    assert {"compile_s", "compile_sync_s"} <= set(tr.timings)
    tr = model.sample(cfg, n_chains=4, kernel="fused!")
    assert "compile_s" in tr.timings
    tr = model.sample(cfg, n_chains=4, sync_compile=True)
    assert tr.timings["compile_sync_s"] == 0.0 and "compile_s" in tr.timings
