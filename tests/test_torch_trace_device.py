"""The rest of ``Trace`` in the port (``rainier_tpu_torch/core/trace.py``):
the on-device diagnostics and summary, the rank cross-check, the
rank-pipeline plan, ``thin`` and the lazy host copy, held against the
JAX package's (``rainier_tpu/core/trace.py:46-80, 169-330, 386-410``)
and against the port's own float64 host pipeline.

* ``rank_diag_plan`` and ``rank_diag_cap`` against the JAX functions on
  a grid of shapes, exactly (raising where they raise);
* the device pipeline (here on CPU tensors) against JAX's
  ``_diagnostics_device`` on numpy-seeded f32 chains, with ties, in each
  mode: r̂ and ESS within 1e-4 relative; and against the host f64
  pipeline within 1e-4 (r̂) and 1e-3 relative (ESS);
* the two rank formulations compared as 2·rank in int32, exactly, past
  2²³ pooled draws, where f32 ranks (the JAX package's check) part;
* a trace past the pooled-draw cap (the cap monkeypatched small) thinned
  for the rank diagnostics as the JAX package thins it;
* ``thin``, the lazy ``chains`` with ``transfer_s``, and ``summary``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rainier_tpu.core import trace as trace_j
from rainier_tpu_torch.core import trace as trace_t
from rainier_tpu_torch.core.trace import Trace

torch.set_num_threads(2)


@pytest.mark.parametrize("n_chains", [1, 2, 4, 1024, 4096, 8192, 65536,
                                      1 << 23, 1 << 24])
def test_rank_diag_plan_and_cap_match_jax(n_chains):
    for n_it in (1, 2, 3, 100, 999, 1000, 4096, 10001):
        try:
            want = trace_j.rank_diag_plan(n_chains, n_it)
        except ValueError as e:
            with pytest.raises(ValueError, match="rank-normalized"):
                trace_t.rank_diag_plan(n_chains, n_it)
            assert "rank-normalized" in str(e)
            continue
        assert trace_t.rank_diag_plan(n_chains, n_it) == want
        assert trace_t.rank_diag_cap(n_chains, n_it) == \
            trace_j.rank_diag_cap(n_chains, n_it)


def _chains(seed, shape=(6, 200, 4), ties=True):
    """f32 chains: an AR(1) walk, a heavy tail, a concentrated
    coordinate (|mean|/sd ~ 1e3) and, with `ties`, one rounded to a coarse
    grid so that many draws tie."""
    rng = np.random.default_rng(seed)
    m, n, k = shape
    x = np.empty(shape)
    x[:, 0] = rng.normal(size=(m, k))
    for t in range(1, n):
        x[:, t] = 0.7 * x[:, t - 1] + rng.normal(size=(m, k))
    x[..., 1] = rng.standard_cauchy(size=(m, n))
    x[..., 2] = 1000.0 + x[..., 2]
    if ties:
        x[..., 3] = np.round(x[..., 3] * 2) / 2
    return x.astype(np.float32)


MODES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("split,rank", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_device_pipeline_matches_jax_and_host(seed, split, rank):
    x = _chains(seed)
    rj, ej, okj = trace_j._diagnostics_device(jnp.asarray(x), 100, split,
                                              rank)
    rt, et, okt = trace_t._diagnostics_device(torch.as_tensor(x), 100,
                                              split, rank)
    assert okt and bool(okj)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4)
    host = x.astype(np.float64)
    if split:
        host = trace_t._split_chains(host)
    if rank:
        host = trace_t._rank_normalize(host)
    rh, eh = trace_t._diagnostics_all(host)
    np.testing.assert_allclose(rt.numpy(), rh, rtol=1e-4)
    np.testing.assert_allclose(et.numpy(), eh, rtol=1e-3)


def test_trace_diagnostics_device_and_host_agree():
    tr = Trace(torch.as_tensor(_chains(3)), None, None, None)
    for split, rank in MODES:
        dev = tr.diagnostics(split=split, rank_normalized=rank)
        host = tr.diagnostics(split=split, rank_normalized=rank,
                              device=False)
        for a, b in zip(dev, host):
            assert abs(a.r_hat - b.r_hat) < 1e-4 * b.r_hat
            assert abs(a.effective_sample_size / b.effective_sample_size
                       - 1) < 1e-3
    with pytest.raises(ValueError, match="multiple chains"):
        Trace(torch.zeros((1, 10, 2)), None, None, None).diagnostics()


def test_twice_ranks_small_cases():
    """Average ranks with ties, 1-based, doubled: both formulations."""
    x = torch.tensor([[3.0, 1.0], [1.0, 1.0], [2.0, 1.0], [1.0, 0.0]])
    a, b = trace_t.twice_ranks(x)
    want = torch.tensor([[8, 6], [3, 6], [6, 6], [3, 2]], dtype=torch.int32)
    assert a.dtype == b.dtype == torch.int32
    assert torch.equal(a, want) and torch.equal(b, want)


def test_twice_ranks_past_two_to_the_23():
    """2²³ + 1000 pooled draws in tied pairs (a pair's average rank is a
    half-integer): the two formulations agree exactly as 2·rank in int32,
    while the f32 ranks the JAX package builds from the same integers
    (left + right and lo + hi + 1 converted to f32, then halved) part on
    rounding alone past 2²⁴ — the check the port does not copy (ROADMAP
    C2.2)."""
    s = (1 << 23) + 1000
    x = (torch.arange(s, dtype=torch.int64) // 2).flip(0).to(torch.float32)
    a, b = trace_t.twice_ranks(x[:, None])
    assert torch.equal(a, b)
    twice = a[:, 0].to(torch.int64)
    assert int(twice.min()) == 3 and int(twice.max()) == 2 * s - 1
    f32_a = (twice - 2).to(torch.float32) * 0.5 + 1.0     # left + right
    f32_b = twice.to(torch.float32) * 0.5                 # lo + hi + 1
    assert not torch.equal(f32_a, f32_b)
    small = twice < (1 << 24)
    assert torch.equal(f32_a[small], f32_b[small])


def test_rank_diagnostics_thin_past_the_cap(monkeypatch):
    """With the pooled-draw cap at 1,000, an 8 × 400 trace is diagnosed
    at every 4th iteration (rank_diag_plan), equal to the host pipeline
    on those draws."""
    monkeypatch.setattr(trace_t, "_RANK_DIAG_MAX_DRAWS", 1000)
    x = _chains(4, (8, 400, 4))
    thin, kept = trace_t.rank_diag_plan(8, 400)
    assert (thin, kept) == (4, 100)
    tr = Trace(torch.as_tensor(x), None, None, None)
    dev = tr.diagnostics(rank_normalized=True)
    host = trace_t._diagnostics_all(trace_t._rank_normalize(
        trace_t._split_chains(x[:, ::thin].astype(np.float64))))
    np.testing.assert_allclose([d.r_hat for d in dev], host[0], rtol=1e-4)
    np.testing.assert_allclose([d.effective_sample_size for d in dev],
                               host[1], rtol=1e-3)
    assert max(d.effective_sample_size for d in dev) <= \
        trace_t.rank_diag_cap(8, 400) * 1.5


def test_summary_thin_and_lazy_copy():
    """summary() where the draws are against numpy's f64 moments and
    quantiles (f32 rounding); thin keeps the draws on their device and
    the host copy happens on the first read of `chains`, timed."""
    x = _chains(5, (4, 300, 4))
    tr = Trace(torch.as_tensor(x), None, None, None)
    assert tr.transfer_s is None and tr.n_chains == 4
    s = tr.summary()
    flat = x.reshape(-1, 4).astype(np.float64)
    np.testing.assert_allclose(s.mean, flat.mean(0), rtol=1e-5,
                               atol=1e-5 * np.abs(flat).max())
    np.testing.assert_allclose(s.sd, flat.std(0, ddof=1), rtol=1e-4)
    np.testing.assert_allclose(s.quantiles, np.quantile(flat, s.probs,
                                                        axis=0),
                               rtol=1e-5, atol=1e-4)
    assert s.n_draws == 1200 and tr.transfer_s is None
    th = tr.thin(3)
    assert isinstance(th._chains_src, torch.Tensor)
    assert th.n_iterations == 100 and th.transfer_s is None
    assert np.array_equal(th.chains, x[:, ::3])
    assert th.transfer_s is not None
    assert np.array_equal(tr.flat(), x.reshape(-1, 4))
    # a host trace stays one
    host = Trace(x, None, None, None)
    assert host.chains is host._chains_src
    assert np.array_equal(host.thin(2).chains, x[:, ::2])
