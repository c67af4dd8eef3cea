"""Models without rows in the port's fused kernel, each chain laid over
several lanes of a warp, held against the plain version and the JAX
package.

Below the chain count at which one thread a chain fills the card, a chain
of a model without rows runs on L lanes (``fused_hmc.lanes_per_chain``):
up to ``emit_cuda.LANE_STATE_MAX`` parameters every lane holds the whole
state in registers and the lanes split the Philox groups; past it the
state is in a slot (the block's shared memory, or the device workspace
past ``LOCAL_STATE_MAX``) and the lanes split every pass over it and every
emitted vector loop, their partial sums met in an xor butterfly.
``csrc/fused_hmc.cu`` compiled for the host with g++ emulates L lanes: it
keeps each lane's partial sums of its elements and adds them in the
order of the card's butterfly over L lanes, so the host build sums in
the card's order.  Checked, with the tolerance and its reason at each
assertion, on

* the funnel (10 dims) at 1, 4, 8 and 32 lanes, in registers;
* the funnel at 40 dims (past ``LANE_STATE_MAX``) at 8 and 32 lanes, its
  slot in shared memory;
* the funnel at 300 dims (past ``LOCAL_STATE_MAX``) at 32 lanes, its slot
  in the device workspace:

the host build's density against autograd on the plain version and
``jax.grad`` of the JAX package's density, the kernel's loop against
``fused_hmc_reference`` in both RNG modes, and results that do not depend
on the lanes or on how many chains share a warp or a block, with a
ragged last block.  Also: the plain version with explicit noise against
the JAX package's Pallas kernel in interpret mode at 300 dims, the
butterfly's order over L < 32 lanes, the lane rule from 64 to 524,288
chains, the emitted text of each layout, and the workspace the
1000-dim funnel needs.
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
from rainier_tpu.compute import real as Rj
from rainier_tpu.ops import fused_hmc as fused_hmc_jax
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import real as Rt
from rainier_tpu_torch.ops import fused_hmc as F
from rainier_tpu_torch.sampler import HMC, SamplerConfig
from rainier_tpu_torch.sampler.driver import _fused_unsupported_reason
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_fused_hmc import _jax_noise

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def funnel(rt, dim=10):
    """Neal's funnel of chip_smoke.py at `dim` dimensions: y and a
    (dim - 1)-vector."""
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(dim - 1)
    return rt.Model.track_({y} | set(xv.to_list()))


# (dims, lanes a chain) of each host build
CASES = {"funnel_10_L1": (10, 1), "funnel_10_L4": (10, 4),
         "funnel_10_L8": (10, 8), "funnel_10_L32": (10, 32),
         "funnel_40_L8": (40, 8), "funnel_40_L32": (40, 32),
         "funnel_300_L32": (300, 32)}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """name -> (its density, host library, emitted, lanes a chain), each
    built once for the module with ``RT_LANES`` defined as its lanes, as
    ``fused_hmc.build`` does; the 10-, 40- and 300-dim densities are one
    each, as a launch's layouts of one model are."""
    cds, cache = {}, {}

    def get(name):
        if name not in cache:
            dim, lanes = CASES[name]
            cd = cds.setdefault(dim, funnel(rtt, dim).density())
            lib, em = _host_library(cd, tmp_path_factory.mktemp(name),
                                    lanes)
            cache[name] = (cd, lib, em, lanes)
        return cache[name]

    return get


@pytest.fixture
def lanes_rule(monkeypatch):
    """Sets the wrapper's lanes a chain, as kernel_ab.py columnfree does,
    so that its block rule and workspace follow the library's layout."""
    def use(lanes):
        monkeypatch.setattr(F, "lanes_per_chain",
                            lambda em, n, lanes=lanes: lanes)
    return use


def _inputs(dim, n, noise, n_it=12, seed=4):
    """(q0, kernel keywords, explicit noise or None): per-chain ε and Σ̂,
    every draw collected."""
    rng = np.random.default_rng(seed)
    t = (lambda x: torch.as_tensor(np.asarray(x, np.float32)))
    q0 = t(rng.normal(size=(dim, n)))
    kw = dict(step_size=t(rng.uniform(0.3, 0.9, n)), n_steps=4,
              n_iterations=n_it, seed=seed, collect_every=1,
              inv_mass_diag=t(rng.uniform(0.5, 2.0, (n, dim))))
    nz = (t(rng.normal(size=(n_it, dim, n))),
          t(rng.uniform(1e-6, 1.0, (n_it, n)))) \
        if noise == "explicit" else None
    return q0, kw, nz


def test_emitted_layouts():
    """The funnel's header is its one-thread text, with no RT_LANES: the
    build defines its lanes, so one text serves every lane count.  Past
    LANE_STATE_MAX the slot's text splits every vector over the lanes
    (the 39-vector a loop from lane RT_LANE), a warp a chain unless the
    build defines fewer lanes, in shared memory up to LOCAL_STATE_MAX and
    in the device workspace past it."""
    one = emit_cuda.emit(funnel(rtt).density())
    assert (one.workspace, one.shared) == (0, False)
    assert "RT_LANES" not in one.source and "RT_LANE" not in one.source
    slot = emit_cuda.emit(funnel(rtt, 40).density())
    assert (slot.workspace, slot.shared) == (280, True)
    assert "#define RT_WS_SHARED 1" in slot.source
    assert "#ifndef RT_LANES\n#define RT_LANES 32\n#endif" in slot.source
    assert "for (int i = RT_LANE; i < 39; i += RT_LSTEP)" in slot.source
    wide = emit_cuda.emit(funnel(rtt, 300).density())
    assert (wide.workspace, wide.shared) == (2100, False)
    assert "RT_WS_SHARED" not in wide.source


def test_lane_rule_at_the_counts_users_run():
    """Lanes a chain by the measured crossovers (LANE_STEPS): 16 up to
    1024 chains, 8 up to 2048, 4 up to 4096, 2 up to 16,384 and one
    thread past it, bench.py's 524,288 chains among them; blocks of 128
    threads where the launch has 128 on each of the card's 132 SMs
    (WIDE_THREADS), else 32.  Past LANE_STATE_MAX a warp a chain at every
    count, 4 chains a block of 128 threads at 1024."""
    em = emit_cuda.emit(funnel(rtt).density())
    got = {n: (F.lanes_per_chain(em, n), F.chains_per_block(em, n),
               F.threads_per_block(em, n))
           for n in (64, 1024, 1025, 2048, 4096, 8192, 16_384, 16_385,
                     16_896, 524_288)}
    assert got == {64: (16, 2, 32), 1024: (16, 2, 32), 1025: (8, 4, 32),
                   2048: (8, 4, 32), 4096: (4, 8, 32), 8192: (2, 16, 32),
                   16_384: (2, 64, 128), 16_385: (1, 32, 32),
                   16_896: (1, 128, 128), 524_288: (1, 128, 128)}
    wide = emit_cuda.emit(funnel(rtt, 40).density())
    for n, w in ((1024, 4), (16_896, 4), (524_288, 4), (7, 1)):
        assert F.lanes_per_chain(wide, n) == emit_cuda.LANES
        assert F.chains_per_block(wide, n) == w


def test_workspace_of_the_1000_dim_funnel_is_named(monkeypatch):
    """The 1000-dim funnel at 1024 chains: a warp a chain, 7000 floats a
    slot, 1024 slots: 28,672,000 bytes, named where the device has no
    room; a slot in shared memory allocates nothing."""
    model = funnel(rtt, 1000)
    em = emit_cuda.emit(model.density())
    assert (F.lanes_per_chain(em, 1024), em.workspace, em.shared) == (
        32, 7000, False)
    assert F.workspace_bytes(em, 1024) == 28_672_000
    assert F.workspace_bytes(emit_cuda.emit(funnel(rtt, 40).density()),
                             1024) == 0
    cfg = SamplerConfig(10, 10, sampler=HMC(3))
    assert _fused_unsupported_reason(model, cfg, 1024, None, "cpu") is None
    monkeypatch.setattr(F, "free_bytes", lambda device: 1000)
    reason = _fused_unsupported_reason(model, cfg, 1024, None, "cpu")
    assert "workspace for 1024 chains is 28672000 bytes" in reason


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_density_matches_autograd_and_jax(name, built, lanes_rule):
    """rt_logp_grad_host, its lanes emulated, at 5 points against torch
    autograd on the plain version and jax.grad of the JAX package's
    density: the same f32 terms summed in other orders (L lane partials
    in f64 and a butterfly, against sequential or pairwise sums of at
    most dim terms), so lp within rtol 1e-5 / atol 1e-5·(1 + |lp|) and
    gradients within 1e-5 of max |g|."""
    cd, lib, em, lanes = built(name)
    lanes_rule(lanes)
    cdj = funnel(rtj, cd.n_vars).density()
    q = torch.as_tensor(np.random.default_rng(3).normal(
        size=(cd.n_vars, 5)), dtype=torch.float32)
    lp, g = _host_logp_grad(lib, em, q, ())
    lp_p, g_p = F.logp_grad_reference(cd, q)
    lp_j, g_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()),
                         in_axes=(0, None))(jnp.asarray(q.numpy().T), ())
    for lp_ref, g_ref in ((lp_p.numpy(), g_p.numpy()),
                          (np.asarray(lp_j), np.asarray(g_j).T)):
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(lp_ref).max()))
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("noise", ["explicit", "philox"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_host_kernel_matches_plain_version(name, noise, built, lanes_rule):
    """The kernel's loop, its lanes emulated, against fused_hmc_reference
    over 12 iterations of HMC(4), 37 chains (no lane count's chains a
    block divides it: a ragged last block of copies).  The momenta are
    the same bits, and only sums over at most dim terms are reordered, so
    every output agrees within 1e-4 (the bar of the one-thread build,
    test_torch_fused_hmc.py) and the divergences are equal."""
    cd, lib, _, lanes = built(name)
    lanes_rule(lanes)
    q0, kw, nz = _inputs(cd.n_vars, 37, noise)
    got = _run_host(lib, cd, q0, kw, nz, ())
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(got[3], ref[3])
    assert 0.0 < float(ref[2].mean())          # the chains move


@pytest.mark.parametrize("dim,names", [
    (10, ("funnel_10_L1", "funnel_10_L4", "funnel_10_L8", "funnel_10_L32")),
    (40, ("funnel_40_L8", "funnel_40_L32"))])
def test_results_do_not_depend_on_lanes_or_block(dim, names, built,
                                                 lanes_rule, monkeypatch):
    """At 37 chains (ragged for every block), each library gives the same
    bits at 1, 2 and 4 chains a warp's worth of block and at 128-thread
    blocks: a chain's lanes and its slot do not depend on its
    neighbours.  Across lane counts the register layout gives the same
    bits (every lane runs the one-thread code; the Philox groups are
    split, not changed); a slot's sums over 39 elements are L partials
    and a butterfly, so 8 and 32 lanes agree within 1e-5, f32 reordering
    of 39 terms compounded over 12 iterations."""
    outs = []
    for name in names:
        cd, lib, _, lanes = built(name)
        lanes_rule(lanes)
        q0, kw, _ = _inputs(dim, 37, "philox")
        runs = []
        for chains in (1, 2, 128 // lanes):
            monkeypatch.setattr(F, "chains_per_block",
                                lambda em, n, w=chains: w)
            runs.append(_run_host(lib, cd, q0, kw, None, ()))
        for run in runs[1:]:
            for a, b in zip(runs[0], run):
                assert torch.equal(a, b)
        outs.append(runs[0])
        monkeypatch.undo()
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            if dim <= emit_cuda.LANE_STATE_MAX:
                assert torch.equal(a, b)
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-5)


def matvec_model(rt, k=12, m=30):
    """A model without rows past LANE_STATE_MAX whose MatVec reads a
    6 x k matrix whole (a MatColumn, no row space): Normal(X·b, 1) at
    zeros, b and an m-vector z standard normal, z's squares in the
    likelihood."""
    R = Rj if rt is rtj else Rt
    x = np.random.default_rng(9).normal(size=(6, k))
    b = rt.Normal(0, 1).latent_vec(k)
    z = rt.Normal(0, 1).latent_vec(m)
    lin = R.MatVec(R.MatColumn(x), b.element)
    return rt.Model.likelihood(
        R.VecSum(rt.Normal(lin, 1.0).log_density_at(R.Column(np.zeros(6))),
                 6) + R.VecSum(z.element * z.element, m) * -0.01)


def test_matvec_without_rows_matches_autograd_and_jax(tmp_path):
    """The MatVec keeps its 12-vector unrolled in every lane, since each
    lane needs the whole vector, while the 30-vector is a loop split over
    the lanes; compiled for the host as the card runs it (a warp a
    chain, its slot in shared memory, 32 lanes emulated) against
    autograd on the port's evaluator and jax.value_and_grad at 3 points:
    f32 sums of at most 30 terms in other orders, so lp within rtol 1e-5
    / atol 1e-5·(1 + |lp|) and gradients within 1e-5 of max |g|."""
    cd, cdj = matvec_model(rtt).density(), matvec_model(rtj).density()
    lib, em = _host_library(cd, tmp_path)
    assert not em.spaces and em.shared and cd.n_vars == 42
    assert F.lanes_per_chain(em, 3) == emit_cuda.LANES
    assert "for (int i = RT_LANE; i < 30; i += RT_LSTEP)" in em.source
    assert "cols.c0[11] * q[11]" in em.source      # the MatVec unrolled
    cols_t = cd.column_values(torch.float32, "cpu")
    q = torch.as_tensor(np.random.default_rng(5).normal(size=(42, 3)),
                        dtype=torch.float32)
    lp, g = _host_logp_grad(lib, em, q, cols_t)
    lp_p, g_p = F.logp_grad_reference(cd, q, cols_t)
    lp_j, g_j = jax.vmap(jax.value_and_grad(cdj.logp_fn()),
                         in_axes=(0, None))(jnp.asarray(q.numpy().T),
                                            cdj.column_values(jnp.float32))
    for lp_ref, g_ref in ((lp_p.numpy(), g_p.numpy()),
                          (np.asarray(lp_j), np.asarray(g_j).T)):
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(lp_ref).max()))
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


def test_plain_version_matches_pallas_kernel_past_the_registers():
    """fused_hmc_reference at 300 dims with explicit noise against the
    JAX package's Pallas kernel interpreted on the CPU (host_rng=True,
    interpret=True), given the same noise (the JAX kernel's own draws):
    the two sum 299 terms in other orders, so ≥ 95% of chains end within
    1e-4 and accept rates agree within 0.02, the bar of the 10-dim
    comparison (test_torch_fused_hmc.py)."""
    n, n_it, seed, dim = 128, 20, 5, 300
    cdj, cdt = funnel(rtj, dim).density(), funnel(rtt, dim).density()
    rng = np.random.default_rng(6)
    q0 = rng.normal(size=(dim, n)).astype(np.float32)
    eps = rng.uniform(0.2, 0.4, n).astype(np.float32)
    lanes = cdj.logp_lanes_fn()
    qf_j, _, acc_j, div_j = fused_hmc_jax(
        lambda qb: lanes(qb, ()), jnp.asarray(q0), step_size=eps,
        n_steps=5, n_iterations=n_it, seed=seed, collect_every=1,
        block_chains=n, interpret=True, host_rng=True)
    qf, _, acc, div = F.fused_hmc_reference(
        cdt, torch.as_tensor(q0), step_size=torch.as_tensor(eps),
        n_steps=5, n_iterations=n_it, seed=seed, collect_every=1,
        noise=_jax_noise(seed, n_it, dim, n))
    ok = (np.abs(qf.numpy() - np.asarray(qf_j))
          <= 1e-4 * np.maximum(1.0, np.abs(np.asarray(qf_j)))).all(axis=0)
    assert ok.mean() >= 0.95, ok.mean()
    assert np.max(np.abs(acc.numpy() - np.asarray(acc_j))) < 0.02
    np.testing.assert_array_equal(div.numpy(), np.asarray(div_j))


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
def test_butterfly_over_fewer_lanes_gives_the_host_order(lanes, tmp_path):
    """The xor butterfly over an aligned group of L < 32 lanes (offsets
    L/2, ..., 1, so no value leaves its group), simulated in numpy f32
    over the 32 lanes of a warp that hold 32 / L chains: every lane of a
    group ends with the same bits, and they are rt_lane_tree<L>'s, the
    order the host build adds a chain's lane sums in (csrc/rt_math.cuh,
    compiled with g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: csrc/rt_math.cuh cannot be "
                    "compiled for the host")
    src = tmp_path / "tree.cc"
    src.write_text('#include "rt_math.cuh"\n'
                   f'extern "C" float tree(float* v) {{\n'
                   f'  return rt_lane_tree<{lanes}>(v);\n}}\n')
    so = tmp_path / "tree.so"
    res = subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                          "-shared", "-fPIC", "-I", str(F.CSRC), "-o",
                          str(so), str(src)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    tree = ctypes.CDLL(str(so)).tree
    tree.restype = ctypes.c_float
    rng = np.random.default_rng(lanes)
    for _ in range(20):
        v = (rng.normal(size=32) * 10.0 ** rng.integers(-4, 5, 32)).astype(
            np.float32)
        warp = v.copy()
        o = lanes // 2
        while o:
            warp = (warp + warp[np.arange(32) ^ o]).astype(np.float32)
            o //= 2
        for g in range(32 // lanes):
            group = warp[g * lanes:(g + 1) * lanes]
            assert len(set(group.view(np.uint32).tolist())) == 1
            buf = v[g * lanes:(g + 1) * lanes].copy()
            got = np.float32(tree(buf.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))))
            assert got.view(np.uint32) == group[0].view(np.uint32)


def test_fused_sample_runs_each_layout_on_the_cpu():
    """Model.sample(kernel="fused!") on CPU tensors runs the plain version
    whatever layout the launch would take (16 lanes at 64 chains, a warp
    at 40 dims): draws of the expected shape, finite, and standard normal
    in the sampler's coordinates (every latent is s·z with z standard)
    within 0.1 of unit spread at 6,400 draws a coordinate, and no kernel
    launched."""
    before = F.fused_hmc.launches
    for dim in (10, 40):
        model = funnel(rtt, dim)
        tr = model.sample(SamplerConfig(100, 100, sampler=HMC(5)),
                          n_chains=64, seed=0, kernel="fused!",
                          device="cpu")
        assert tr.chains.shape == (64, 100, dim)
        assert np.all(np.isfinite(tr.chains))
        assert abs(float(np.std(tr.chains)) - 1.0) < 0.1
    assert F.fused_hmc.launches == before
