"""A resident register model on its warp: a model whose chain state lies
in registers and whose rows are one tile, loaded once a launch (the
README regression's 200 rows, SBC's 100), runs each chain on the 32
lanes of a warp, as every model with rows does.  Its lanes split the
rows (lane l takes rows l, l + 32, ...) and the Philox groups, its rows
divide by σ through a reciprocal computed once a call, and its lanes'
lp and dense adjoints meet in one reduce-scatter (``rt_lane_sums``).

``csrc/fused_hmc.cu`` compiled for the host with g++ emulates the 32
lanes: each lane's rows walked in turn, its sums kept apart and added
in the butterfly's order.  Checked, with the tolerance and its reason
at each assertion, on the README regression (200 rows), a 20-row and a
100-row logistic, at 1023 and 1024 chains (a ragged last block of
copies):

* the density against autograd on the plain version and the JAX
  package's density and ``jax.grad``;
* the kernel's loop against ``fused_hmc_reference`` in both RNG modes;
* the same bits at every count of chains a block;
* the rule, for a resident register model, a streamed one, a slot model
  and a model without rows;
* the reduce-scatter the card's lanes sum in, simulated in numpy: the
  bits of the butterfly of each value, which the host build adds.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import (_host_library, _host_logp_grad, _run_host,
                                readme_regression)
from test_torch_fused_hmc import funnel
from test_torch_gather import _warmed_up, glmm_poisson
from test_torch_lanes import small_logistic

torch.set_num_threads(2)
rtt.config.set_device("cpu")

MODELS = {"readme_200": readme_regression,
          "logistic_20": small_logistic,
          "logistic_100": lambda rt: small_logistic(rt, 100)}
CHAINS = (1023, 1024)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name -> (torch model, its density, host library, emitted), each
    compiled once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            model = MODELS[name](rtt)
            cd = model.density()
            lib, em = _host_library(cd, tmp_path_factory.mktemp(name))
            cache[name] = (model, cd, lib, em)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def starts():
    """name -> (q0 (dim, 1024), ε, Σ̂): a 64-chain scan-path warmup's
    states, ε and Σ̂, each repeated to 1024 chains."""
    cache = {}

    def get(name, model):
        if name not in cache:
            q0, eps, imd = _warmed_up(model, 64)
            cache[name] = (q0.repeat(1, 16), eps.repeat(16),
                           imd.repeat(16, 1))
        return cache[name]

    return get


def _at(start, n):
    """The first n chains of a start."""
    q0, eps, imd = start
    return q0[:, :n].contiguous(), eps[:n], imd[:n]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_density_matches_autograd_and_jax(name, built):
    """rt_logp_grad_host on a warp a chain at 1023 and 1024 points
    (blocks of 8 chains: the last of 1023 holds one copy) against torch
    autograd on the port's plain version and jax.grad of the JAX
    package's lanes evaluator: the same f32 terms summed in other orders
    (32 lane sums and a butterfly against sequential or pairwise sums;
    the rows divide by σ through its reciprocal, within an ulp of the
    quotient), so lp within rtol 1e-5 / atol 1e-5·(1 + |lp|) and
    gradients within 1e-5 of max |g|, test_torch_lanes.py's bars."""
    model, cd, lib, em = built(name)
    assert "#define RT_RESIDENT 1" in em.source and not em.workspace
    assert F.threads_per_block(em, 1024) == F.WIDE_BLOCK * emit_cuda.LANES
    cdj = MODELS[name](rtj).density()
    lanes_j, cols_j = cdj.logp_lanes_fn(), cdj.column_values(jnp.float32)
    cols = cd.column_values(torch.float32, "cpu")
    for n in CHAINS:
        q = torch.as_tensor(np.random.default_rng(n).normal(
            size=(cd.n_vars, n)) * 0.3, dtype=torch.float32)
        lp, g = _host_logp_grad(lib, em, q, cols)
        lp_p, g_p = F.logp_grad_reference(cd, q)
        qj = jnp.asarray(q.numpy())
        lp_j = np.asarray(lanes_j(qj, cols_j))
        g_j = np.asarray(jax.grad(lambda x: lanes_j(x, cols_j).sum())(qj))
        for lp_ref, g_ref in ((lp_p.numpy(), g_p.numpy()), (lp_j, g_j)):
            np.testing.assert_allclose(
                lp.numpy(), lp_ref, rtol=1e-5,
                atol=1e-5 * (1 + np.abs(lp_ref).max()))
            np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                                       atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("noise", ["explicit", "philox"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_kernel_matches_plain_version(name, noise, built, starts):
    """The kernel's loop on a warp a chain against fused_hmc_reference
    from a scan-path warmup's states with its per-chain ε and Σ̂, at 1023
    chains (a last block of seven chains and a copy), 6 iterations of
    HMC(4), with explicit noise and with Philox (the host build draws
    every group, the bits the card's lanes give by splitting them).  The
    two sum rows in other orders, so ≥ 90% of chains end within 1e-3 (a
    flipped borderline accept sends a chain away), accept rates agree
    within 0.05 on average, and the copy stores nothing."""
    model, cd, lib, em = built(name)
    q0, eps, imd = _at(starts(name, model), 1023)
    n_it = 6
    kw = dict(step_size=eps, n_steps=4, n_iterations=n_it, seed=9,
              collect_every=1, inv_mass_diag=imd)
    rng = np.random.default_rng(len(name))
    nz = (torch.as_tensor(rng.normal(size=(n_it, cd.n_vars, 1023)),
                          dtype=torch.float32),
          torch.as_tensor(rng.uniform(1e-6, 1.0, (n_it, 1023)),
                          dtype=torch.float32)) \
        if noise == "explicit" else None
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05
    assert 0.0 < float(ref[2].mean())          # the chains move
    assert got[1].shape == ref[1].shape == (n_it, cd.n_vars, 1023)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_same_bits_whatever_the_chains_a_block(name, built, starts,
                                               monkeypatch):
    """A chain's arithmetic is its warp's alone: at 1, 4 and 8 chains a
    block, 1023 chains, the final q, draws, accept rates and divergences
    are the same bits; a launch that streams its tile (moot once it is
    resident) too."""
    model, cd, lib, em = built(name)
    q0, eps, imd = _at(starts(name, model), 1023)
    kw = dict(step_size=eps, n_steps=4, n_iterations=4, seed=5,
              collect_every=1, inv_mass_diag=imd)
    cols = cd.column_values(torch.float32, "cpu")
    outs = []
    for w in (1, 4, 8):
        monkeypatch.setattr(F, "chains_per_block", lambda em, n, w=w: w)
        assert F.threads_per_block(em, 1023) == w * emit_cuda.LANES
        outs.append(_run_host(lib, cd, q0, kw, None, cols))
    outs.append(_run_host(lib, cd, q0, kw, None, cols, stream=True))
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            assert torch.equal(x, y)


RULE_MODELS = {
    "resident registers": lambda: readme_regression(rtt),
    "resident registers, 100 rows": lambda: small_logistic(rtt, 100),
    "streamed": lambda: small_logistic(rtt, 5000),
    "slot": lambda: glmm_poisson(rtt, 30, 11)[0],
    "gathers in registers": lambda: glmm_poisson(rtt, 10, 6)[0],
    "no rows": lambda: funnel(rtt),
}
# (chains, lanes a chain, chains a block) the rule gives each model
_WARP = ((512, 32, 4), (1023, 32, 4), (1024, 32, 8), (4096, 32, 8),
         (16384, 32, 8), (524288, 32, 8))
RULE = {
    "resident registers": _WARP,
    "resident registers, 100 rows": _WARP,
    "streamed": _WARP,
    "slot": _WARP,
    "gathers in registers": _WARP,
    "no rows": ((1024, 16, 2), (2048, 8, 4), (4096, 4, 8), (16384, 2, 64),
                (16385, 1, 32), (524288, 1, 128)),
}


@pytest.mark.parametrize("kind", sorted(RULE_MODELS))
def test_lane_rule(kind):
    """The lanes a chain and chains a block the wrapper gives each kind
    of model: every model with rows, resident or streamed, in registers
    or in a slot, a warp a chain, 8 chains a block where 128 blocks
    remain, else 4; a model without rows LANE_STEPS' lanes, unchanged."""
    em = emit_cuda.emit(RULE_MODELS[kind]().density())
    if kind.startswith("resident"):
        assert "#define RT_RESIDENT 1" in em.source and not em.workspace
    for n, lanes, chains in RULE[kind]:
        assert (F.lanes_per_chain(em, n), F.chains_per_block(em, n)) == \
            (lanes, chains), (kind, n)
        assert F.threads_per_block(em, n) == lanes * chains


def _card_lane_sums(v):
    """The reduce-scatter of rt_lane_sums over the rows of v (L lanes, P
    values each) as the card runs it, lane by lane in numpy f64: (each
    lane's values after the stages, the index of its first total)."""
    n_lanes, p = v.shape
    v, w, o, start = v.copy(), p, n_lanes // 2, np.zeros(n_lanes, int)
    while o:
        t = v.copy()
        for lane in range(n_lanes):
            m, hi = lane ^ o, bool(lane & o)
            if w > 1:
                h = w // 2
                for j in range(h):
                    keep = v[lane, j + h] if hi else v[lane, j]
                    recv = v[m, j + h] if hi else v[m, j]
                    t[lane, j] = keep + recv
                start[lane] += h if hi else 0
            else:
                t[lane, 0] = v[lane, 0] + v[m, 0]
        w, o, v = max(w // 2, 1), o // 2, t
    return v[:, :w], start


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 64])
def test_lane_sums_have_the_butterflys_bits(p, tmp_path):
    """rt_lane_sums (csrc/rt_math.cuh), the reduce-scatter in which a
    chain's 32 lanes sum lp and its dense adjoints on the card (P values
    a lane: lp and 0, 1, 3, 7, 15 or 63 adjoints), simulated in numpy
    f64 over values of mixed magnitude: every lane that holds total k
    holds the same bits, and they are rt_lane_tree's, the butterfly's
    order that the host build adds each value in (compiled with g++):
    each total adds the lanes in the butterfly's pairs, x + y in one
    lane and y + x in its partner.  A sequential sum differs, so the
    order is what the two share."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: csrc/rt_math.cuh cannot be "
                    "compiled for the host")
    src = tmp_path / "tree.cc"
    src.write_text('#include "rt_math.cuh"\n'
                   'extern "C" double tree(double* v) {\n'
                   '  return rt_lane_tree<32>(v);\n}\n')
    so = tmp_path / "tree.so"
    res = subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                          "-shared", "-fPIC", "-I", str(F.CSRC), "-o",
                          str(so), str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    tree = ctypes.CDLL(str(so)).tree
    tree.restype = ctypes.c_double
    dp = ctypes.POINTER(ctypes.c_double)
    rng = np.random.default_rng(p)
    differs = 0
    for _ in range(20):
        v = rng.normal(size=(32, p)) * 10.0 ** rng.integers(-6, 7, (32, p))
        held, start = _card_lane_sums(v)
        w = held.shape[1]
        for k in range(p):
            lanes = [lane for lane in range(32)
                     if start[lane] <= k < start[lane] + w]
            assert len(lanes) == max(32 // p, 1)
            bits = {held[lane, k - start[lane]].tobytes() for lane in lanes}
            assert len(bits) == 1
            total = held[lanes[0], k - start[lanes[0]]]
            col = v[:, k].copy()
            assert np.float64(tree(col.ctypes.data_as(dp))).tobytes() == \
                total.tobytes()
            differs += int(sum(v[:, k].tolist()) != total)
    assert differs > 0
