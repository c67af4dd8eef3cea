"""One warp per chain in the port's fused kernel: the lanes of a chain
split the rows of each tile (and, for a model past the register layout,
each pass over its workspace), held against the plain version and the
JAX package.

``csrc/fused_hmc.cu`` compiled for the host with g++ emulates the lanes:
it walks a tile's rows lane by lane, keeps each lane's partial sums and
its own copy of the row-invariant adjoints apart, and adds the lanes' sums
in the order of the card's xor butterfly; a workspace model's passes keep
each lane's partial sums of its elements.  So the host build sums in the
card's order, and these tests cover the new code paths without a card.
Checked, with the tolerance and its reason at each assertion, on

* the 1500-row logistic (five full 256-row tiles and a ragged one);
* a GLMMPoisson2 of 10 sites × 6 years, whose year index is the same in
  ten neighbouring rows, so lanes of one warp add into one adjoint entry
  (22 parameters: every lane holds the state and its own adjoint copy);
* the same at 30 sites × 11 years (47 parameters, past
  ``emit_cuda.LANE_STATE_MAX``: the state in the workspace, and each
  step's gather adjoints added by the warp into the chain's one copy);
* glmm_large at 300 groups, past the register layout, with the workspace
  passes split over the lanes and the lanes' adjoint copies in the
  workspace;
* a 20-row logistic, a tile with fewer rows than lanes;
* the logistic observed as 600 + 400 rows (two row spaces):

the density against autograd on the plain version and ``jax.grad``, the
kernel's loop against ``fused_hmc_reference`` in both RNG modes, two
launches and streamed against synchronous bit for bit, and results that
do not depend on how many chains share a block.  The butterfly's claim,
the same bits in every lane and the host's order, is checked on its own.
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
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import (_R, _host_library, _host_logp_grad,
                                _run_host, logistic)
from test_torch_fused_hmc import funnel
from test_torch_gather import _warmed_up, glmm_poisson
from test_torch_large_models import glmm_large
from test_torch_untiled import logistic_blocks

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def small_logistic(rt, n=20):
    """The logistic's structure at 20 rows: one tile, fewer rows than the
    32 lanes of a warp, so most lanes sum no row."""
    R = _R(rt)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, 3))
    ys = (rng.uniform(size=n) < 0.5).astype(float)
    alpha = rt.Normal(0, 5).latent()
    betas = rt.Normal(0, 5).latent_vec(3)
    lin = alpha + R.MatVec(R.MatColumn(x), betas.element)
    return rt.Model.likelihood(R.RowSum(
        rt.Bernoulli(lin.logistic()).log_density_at(R.Column(ys)), n))


MODELS = {"logistic_1500": logistic,
          "glmm_10x6": lambda rt: glmm_poisson(rt, 10, 6)[0],
          "glmm_30x11": lambda rt: glmm_poisson(rt, 30, 11)[0],
          "glmm_large_300": lambda rt: glmm_large(rt, 300),
          "logistic_20": small_logistic,
          "split_600_400": logistic_blocks}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name -> (torch model, its density, host library, emitted), each
    model compiled once for the module."""
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
    """name -> (q0 (dim, 13), ε (13,), Σ̂ (13, dim)) from a short
    scan-path warmup: 13 chains, so 4-chain blocks leave a last block of
    one chain and three copies."""
    cache = {}

    def get(name, model):
        if name not in cache:
            cache[name] = _warmed_up(model, 13)
        return cache[name]

    return get


def _kernel_kw(start, noise, n_it=8, seed=9):
    """The kernel's keywords from a warmup's (q0, ε, Σ̂), and explicit
    noise or None."""
    q0, eps, imd = start
    dim, n = q0.shape
    rng = np.random.default_rng(seed)
    kw = dict(step_size=eps, n_steps=4, n_iterations=n_it, seed=seed,
              collect_every=1, inv_mass_diag=imd)
    nz = (torch.as_tensor(rng.normal(size=(n_it, dim, n)),
                          dtype=torch.float32),
          torch.as_tensor(rng.uniform(1e-6, 1.0, (n_it, n)),
                          dtype=torch.float32)) \
        if noise == "explicit" else None
    return kw, nz


def test_every_case_runs_on_lanes(built):
    """Each case is a model with rows, so its chains are warps: 8 chains
    a block of 256 threads at 1024 chains, 4 of 128 below.  The 20-row
    tile has fewer rows than lanes, the GLMM's year index repeats within
    a warp's rows, and past LANE_STATE_MAX parameters the state is in
    the workspace, where the rows hand their gather adjoints to the
    warp."""
    for name in MODELS:
        _, cd, _, em = built(name)
        assert F.lanes_per_chain(em) == emit_cuda.LANES == 32
        # 8 chains a block where 128 blocks remain, else 4
        assert F.chains_per_block(em, 1024) == F.WIDE_BLOCK == 8
        assert F.chains_per_block(em, 1023) == F.NARROW_BLOCK == 4
        assert F.threads_per_block(em, 13) == 128
    assert built("logistic_20")[3].n_rows < emit_cuda.LANES
    # a model with rows keeps its state in the lanes up to LANE_STATE_MAX
    assert not built("glmm_10x6")[3].workspace
    assert built("glmm_30x11")[3].workspace
    # the year index: one entry for many of a warp's rows
    assert any(len(np.unique(c.values[:emit_cuda.LANES])) < 5
               for c in built("glmm_10x6")[1].columns
               if isinstance(c, Rt.IntColumn))
    em = built("glmm_large_300")[3]
    assert em.workspace == emit_cuda.workspace_floats(302, 300, True)
    assert "#define RT_GATHERS 1" in em.source        # handed to the warp
    assert "sidx[0] = 0 + j" in em.source and "ainv[0 + j" not in em.source
    assert f"#define RT_LANES {emit_cuda.LANES}" in em.source
    # a model without rows keeps one thread a chain
    fem = emit_cuda.emit(funnel(rtt).density())
    assert F.lanes_per_chain(fem) == 1
    assert F.threads_per_block(fem, 1024) == 32
    assert "RT_LANES" not in fem.source


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_lanes_density_matches_autograd_and_jax(name, built):
    """rt_logp_grad_host, its lanes emulated, at 5 points against torch
    autograd on the port's plain version and jax.grad of the JAX
    package's lanes evaluator: the same f32 terms summed in other orders
    (32 lane sums and a butterfly, against sequential or pairwise sums),
    so lp within rtol 1e-5 / atol 1e-5·(1 + |lp|) and gradients within
    1e-5 of max |g|."""
    model, cd, lib, em = built(name)
    cdj = MODELS[name](rtj).density()
    scale = 0.05 if name.startswith("glmm_large") else 0.3
    q = torch.as_tensor(np.random.default_rng(3).normal(
        size=(cd.n_vars, 5)) * scale, dtype=torch.float32)
    if name.startswith("glmm_large"):
        q[0] += float(np.log(5.0))
        q[1] += float(np.log(0.3))
        q[2:] += float(np.log(5.0))
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, q, cols)
    lp_p, g_p = F.logp_grad_reference(cd, q)
    lanes_j, cols_j = cdj.logp_lanes_fn(), cdj.column_values(jnp.float32)
    qj = jnp.asarray(q.numpy())
    lp_j = np.asarray(lanes_j(qj, cols_j))
    g_j = np.asarray(jax.grad(lambda x: lanes_j(x, cols_j).sum())(qj))
    for lp_ref, g_ref in ((lp_p.numpy(), g_p.numpy()), (lp_j, g_j)):
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(lp_ref).max()))
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("noise", ["explicit", "philox"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_lanes_kernel_matches_plain_version(name, noise, built,
                                                 starts):
    """The kernel's loop, its lanes emulated, against fused_hmc_reference
    from a scan-path warmup's states with its per-chain ε and Σ̂, 13
    chains (a last block of one chain and three copies), 8 iterations of
    HMC(4).  The two sum rows in other orders, so ≥ 90% of chains end
    within 1e-3 (a flipped borderline accept sends a chain away), accept
    rates agree within 0.05 on average, and the copies store nothing:
    the outputs are the 13 chains' alone."""
    model, cd, lib, em = built(name)
    q0, eps, imd = starts(name, model)
    kw, nz = _kernel_kw((q0, eps, imd), noise)
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05
    assert 0.0 < float(ref[2].mean())          # the chains move
    assert got[1].shape == ref[1].shape
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_lanes_are_deterministic(name, built, starts):
    """Two launches on the same inputs give the same bits, and a launch
    that streams its tiles through two slots gives the synchronous one's
    bits: both walk the rows through the same lanes and sum the lanes'
    adjoint copies in one fixed order, with no atomics.  The density
    alone too."""
    model, cd, lib, em = built(name)
    q0, eps, imd = starts(name, model)
    kw, _ = _kernel_kw((q0, eps, imd), "philox")
    cols = cd.column_values(torch.float32, "cpu")
    a = _run_host(lib, cd, q0, kw, None, cols)
    b = _run_host(lib, cd, q0, kw, None, cols)
    s = _run_host(lib, cd, q0, kw, None, cols, stream=True)
    for x, y, z in zip(a, b, s):
        assert torch.equal(x, y) and torch.equal(x, z)
    lp, g = _host_logp_grad(lib, em, q0, cols)
    lp_s, g_s = _host_logp_grad(lib, em, q0, cols, stream=True)
    assert torch.equal(lp, lp_s) and torch.equal(g, g_s)


@pytest.mark.parametrize("name", ["glmm_10x6", "glmm_30x11",
                                  "glmm_large_300"])
def test_results_do_not_depend_on_chains_per_block(name, built, starts,
                                                   monkeypatch):
    """A chain's arithmetic is its warp's alone: at 2, 4 and 8 chains a
    block (the copies at the ragged edge change, the chains do not) the
    final q, draws, accept rates and divergences are the same bits, and
    so is the gathered adjoints' sum over the lanes, whose index repeats
    within a warp."""
    model, cd, lib, em = built(name)
    q0, eps, imd = starts(name, model)
    kw, _ = _kernel_kw((q0, eps, imd), "philox", n_it=4)
    cols = cd.column_values(torch.float32, "cpu")
    outs = []
    for w in (2, 4, 8):
        monkeypatch.setattr(F, "chains_per_block", lambda em, n, w=w: w)
        assert F.threads_per_block(em, 13) == 32 * w
        outs.append(_run_host(lib, cd, q0, kw, None, cols))
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            assert torch.equal(x, y)


def test_host_entries_refuse_threads_that_make_no_whole_chain(built):
    """A block of a model with rows holds whole warps, at most 8: the
    host entries, like the launches, return nonzero for 4 threads (the
    old workspace blocks) and for 16 warps."""
    _, cd, lib, em = built("logistic_20")
    q = torch.zeros((cd.n_vars, 3))
    lp, g = torch.empty(3), torch.empty_like(q)
    cols = cd.column_values(torch.float32, "cpu")
    ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    for threads, rc in ((4, 1), (16 * 32, 1), (32, 0), (256, 0)):
        assert lib.rt_logp_grad_host(
            3, q.data_ptr(), lp.data_ptr(), g.data_ptr(), ptrs,
            F.row_counts(em), None, threads, 0) == rc


def test_butterfly_gives_every_lane_the_host_order(tmp_path):
    """The xor butterfly of five __shfl_xor_sync stages, simulated in
    numpy f32 over 32 lanes of values of mixed magnitude: every lane ends
    with the same bits (each stage adds a pair in both of its lanes, and
    f32 addition commutes), and they are rt_lane_tree's, the order the
    host build adds the lanes' sums in (csrc/rt_math.cuh, compiled with
    g++).  A sequential sum of the same values differs, so the order is
    what the host build reproduces."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: csrc/rt_math.cuh cannot be "
                    "compiled for the host")
    src = tmp_path / "tree.cc"
    src.write_text('#include "rt_math.cuh"\n'
                   'extern "C" float tree32(float* v) {\n'
                   '  return rt_lane_tree<32>(v);\n}\n')
    so = tmp_path / "tree.so"
    res = subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                          "-shared", "-fPIC", "-I", str(F.CSRC), "-o",
                          str(so), str(src)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    tree32 = ctypes.CDLL(str(so)).tree32
    tree32.restype = ctypes.c_float
    rng = np.random.default_rng(0)
    differs = 0
    for _ in range(50):
        v = (rng.normal(size=32) * 10.0 ** rng.integers(-4, 5, 32)).astype(
            np.float32)
        lanes = v.copy()
        for o in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
        assert len(set(lanes.view(np.uint32).tolist())) == 1
        buf = v.copy()
        got = np.float32(tree32(buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))))
        assert got.view(np.uint32) == lanes[0].view(np.uint32)
        seq = np.float32(0.0)
        for x in v:
            seq = np.float32(seq + x)
        differs += int(seq.view(np.uint32) != got.view(np.uint32))
    assert differs > 0
