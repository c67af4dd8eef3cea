"""The fused HMC kernel's plain version, its RNG, and the kernel's loop.

* ``fused_hmc_reference`` with explicit noise against the JAX package's
  Pallas kernel run as its own tests run it on the CPU
  (``host_rng=True, interpret=True``): the same noise tensors, the JAX
  warmup product carried in through ``interop``; ≥95% of chains end
  within 1e-4 and accept rates agree within 0.02 (a borderline accept
  may flip on f32 rounding and that chain walks away).
* The accept guard: where h0 = +inf the JAX kernel accepts and the port
  rejects, as the scan path does (sampler/leapfrog.py:63-76).
* Philox4x32-10: the published known-answer vectors, and the bits
  against an independent numpy uint64 implementation.
* ``csrc/fused_hmc.cu`` compiled for the host with g++ (the kernel's
  per-chain loop, run chain after chain) against the plain version in
  both noise modes, within 1e-4.
"""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.ops import fused_hmc as fused_hmc_jax
from rainier_tpu.sampler.driver import build_warmup_fn
from rainier_tpu_torch import interop
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.compute import real as R
from rainier_tpu_torch.ops import fused_hmc as F

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def funnel(rt):
    y = rt.Normal(0.0, 3.0).latent()
    xv = rt.Normal(0.0, (y / 2).exp()).latent_vec(9)
    return rt.Model.track_({y} | set(xv.to_list()))


def _jax_noise(seed, n_it, dim, n):
    """hmc_pallas.py:246-254's host_rng noise, sliced to the true dim."""
    dim_pad = (dim + 7) // 8 * 8
    kp, ku = jax.random.split(jax.random.PRNGKey(seed))
    p = jax.random.normal(kp, (n_it, dim_pad, n), jnp.float32)
    u = jax.random.uniform(ku, (n_it, 1, n), jnp.float32,
                           minval=1.1920929e-7, maxval=1.0)
    return (torch.as_tensor(np.array(p[:, :dim])),
            torch.as_tensor(np.array(u[:, 0])))


def test_plain_version_matches_pallas_kernel_on_jax_warmup():
    n, n_it, seed = 128, 40, 5
    mj, mt = funnel(rtj), funnel(rtt)
    cdj = mj.density()
    lpg = cdj.logp_and_grad_fn()
    cfg = rtj.SamplerConfig(150, 10, sampler=rtj.HMC(5))
    warm = jax.jit(jax.vmap(build_warmup_fn(lambda q: lpg(q, ()), 10, cfg,
                                            jnp.float32)))
    wp = interop.warmup_product_from_numpy(interop.warmup_product_to_numpy(
        warm(jax.random.split(jax.random.PRNGKey(0), n))), device="cpu")
    assert float(wp.mass.diag.std()) > 0.0       # a window closed
    q0 = wp.chain.q.T.contiguous()
    lanes = cdj.logp_lanes_fn()
    qf_j, s_j, acc_j, div_j = fused_hmc_jax(
        lambda qb: lanes(qb, ()), jnp.asarray(q0.numpy()),
        step_size=wp.step_size.numpy(), n_steps=5, n_iterations=n_it,
        seed=seed, inv_mass_diag=wp.mass.diag.numpy(), collect_every=1,
        block_chains=n, interpret=True, host_rng=True)
    qf, s, acc, div = F.fused_hmc_reference(
        mt.density(), q0, step_size=wp.step_size, n_steps=5,
        n_iterations=n_it, seed=seed, inv_mass_diag=wp.mass.diag,
        collect_every=1, noise=_jax_noise(seed, n_it, 10, n))
    ok = (np.abs(qf.numpy() - np.asarray(qf_j))
          <= 1e-4 * np.maximum(1.0, np.abs(np.asarray(qf_j)))).all(axis=0)
    assert ok.mean() >= 0.95, ok.mean()
    assert np.max(np.abs(acc.numpy() - np.asarray(acc_j))) < 0.02
    np.testing.assert_array_equal(div.numpy(), np.asarray(div_j))
    assert s.shape == (n_it, 10, n) and np.asarray(s_j).shape == s.shape


def test_accept_guard_differs_from_pallas_kernel_where_h0_is_inf():
    """logp = -inf at q0 (h0 = +inf): proposals that land where logp is
    finite are accepted by the JAX kernel's NaN-only rule
    (hmc_pallas.py:411-412) and rejected — as divergences — by the port."""
    def build(rt):
        p = rt.parameter()
        return rt.Model.likelihood(rt.gt(p, 0.0, p * p * -0.5,
                                          rt.neg_infinity))

    n, seed = 128, 3
    q0 = np.full((1, n), -0.5, np.float32)
    lanes = build(rtj).density().logp_lanes_fn()
    qf_j, _, acc_j, _ = fused_hmc_jax(
        lambda qb: lanes(qb, ()), jnp.asarray(q0), step_size=1.0,
        n_steps=1, n_iterations=1, seed=seed, block_chains=n,
        interpret=True, host_rng=True)
    qf, _, acc, div = F.fused_hmc_reference(
        build(rtt).density(), torch.as_tensor(q0), step_size=1.0,
        n_steps=1, n_iterations=1, seed=seed,
        noise=_jax_noise(seed, 1, 1, n))
    moved = np.asarray(qf_j)[0] > 0.0
    assert moved.any() and np.all(np.asarray(acc_j)[moved] == 1.0)
    np.testing.assert_array_equal(qf.numpy(), q0)
    assert np.all(acc.numpy() == 0.0) and np.all(div.numpy() == 1.0)


# -- Philox ------------------------------------------------------------------


KAT = [  # Random123 known-answer vectors for philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
    got = F.philox4x32(*c, key[0], torch.tensor([key[1]], dtype=torch.int64))
    assert tuple(int(x) for x in got) == want


def _philox_numpy(c, k0, k1):
    """Philox4x32-10 in numpy uint64 arithmetic (independent of the
    16-bit-limb torch version)."""
    c = [np.asarray(x, np.uint64) for x in c]
    k0, k1 = np.uint64(k0), np.asarray(k1, np.uint64)
    m = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m
            k1 = (k1 + np.uint64(0xBB67AE85)) & m
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [((p1 >> np.uint64(32)) ^ c[1] ^ k0) & m, p1 & m,
             ((p0 >> np.uint64(32)) ^ c[3] ^ k1) & m, p0 & m]
    return c


def test_philox_noise_matches_numpy_and_is_well_formed():
    dim, n, seed, it = 10, 300, 1234567, 17
    p, u = F.philox_noise(seed, it, dim, n, "cpu")
    groups = (2 * dim + 1 + 3) // 4
    words = np.stack(_philox_numpy(
        [np.full((groups, n), it), np.arange(groups)[:, None] + 0 * np.arange(n),
         np.zeros((groups, n)), np.zeros((groups, n))],
        seed, np.arange(n)[None, :]), axis=1).reshape(4 * groups, n)
    bits = ((words[:2 * dim + 1] >> np.uint64(9))
            | np.uint64(0x3F800000)).astype(np.uint32).view(np.float32)
    uni = (bits - np.float32(1.0)) + np.float32(1.1920929e-7)
    np.testing.assert_array_equal(u.numpy(), uni[2 * dim])
    want_p = np.sqrt(np.float32(-2.0) * np.log(uni[0:2 * dim:2])) * np.cos(
        np.float32(2 * np.pi) * uni[1:2 * dim:2])
    np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-6, atol=1e-6)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    big, _ = F.philox_noise(0, 0, 4, 20000, "cpu")
    assert abs(float(big.mean())) < 0.02 and abs(float(big.std()) - 1) < 0.02


# -- the kernel's loop, compiled for the host --------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: csrc/fused_hmc.cu cannot be "
                    "compiled for the host")
    cd = funnel(rtt).density()
    em = emit_cuda.emit(cd)
    d = tmp_path_factory.mktemp(
        "k" + hashlib.sha256(em.source.encode()).hexdigest()[:12])
    (d / emit_cuda.HEADER_NAME).write_text(em.source)
    so = d / "host.so"
    res = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-I", str(d), "-I", str(F.CSRC), "-o", str(so),
         str(F.CSRC / "fused_hmc.cu")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    fn = ctypes.CDLL(str(so)).rt_fused_hmc_host
    fn.argtypes = F.HMC_ARGTYPES
    return cd, fn


def _run_host(fn, q0, eps, scale, noise, n_it, n_steps, collect, seed):
    dim, n = q0.shape
    qf, acc, div = torch.empty(dim, n), torch.empty(n), torch.empty(n)
    samples = torch.empty(n_it // collect, dim, n) if collect else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    p, u = noise if noise is not None else (None, None)
    fn(n, ptr(q0), ptr(scale), int(scale is not None and scale.dim() == 2),
       ptr(eps), ptr(p), ptr(u), ptr(qf), ptr(samples), ptr(acc), ptr(div),
       n_it, n_steps, collect, None, dim, seed, (ctypes.c_void_p * 1)(), 0,
       None, 32, 0)
    return qf, samples, acc, div


@pytest.mark.parametrize("noise,mass", [("explicit", "per_chain"),
                                        ("philox", "shared"),
                                        ("philox", "identity")])
def test_host_compiled_kernel_matches_plain_version(host_kernel, noise,
                                                    mass):
    cd, fn = host_kernel
    n, n_it, n_steps, collect, seed = 37, 30, 4, 2, 9   # ragged n
    rng = np.random.default_rng(0)
    t = (lambda x: torch.as_tensor(np.asarray(x, np.float32)))
    q0 = t(rng.normal(size=(10, n)))
    eps = t(rng.uniform(0.3, 0.9, n))
    imd = {"per_chain": t(rng.uniform(0.5, 2.0, (n, 10))),
           "shared": t(rng.uniform(0.5, 2.0, 10)), "identity": None}[mass]
    nz = (t(rng.normal(size=(n_it, 10, n))),
          t(rng.uniform(1e-6, 1.0, (n_it, n)))) if noise == "explicit" \
        else None
    ref = F.fused_hmc_reference(cd, q0, step_size=eps, n_steps=n_steps,
                                n_iterations=n_it, seed=seed,
                                inv_mass_diag=imd, collect_every=collect,
                                noise=nz)
    _, _, scale, _, _ = F._prepare(cd, q0, eps, imd, n_steps, n_it,
                                   collect, nz, None)
    got = _run_host(fn, q0, eps, scale, nz, n_it, n_steps, collect, seed)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


# -- wrapper ---------------------------------------------------------------


def test_wrapper_runs_plain_version_on_cpu_tensors():
    cd = funnel(rtt).density()
    q0 = torch.zeros(10, 6)
    before = F.fused_hmc.launches
    qf, samples, acc, div = F.fused_hmc(cd, q0, step_size=0.5, n_steps=3,
                                        n_iterations=8, seed=0,
                                        collect_every=4)
    assert F.fused_hmc.launches == before      # no kernel was launched
    ref = F.fused_hmc_reference(cd, q0, step_size=0.5, n_steps=3,
                                n_iterations=8, seed=0, collect_every=4)
    for a, b in zip((qf, samples, acc, div), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert samples.shape == (2, 10, 6) and acc.shape == div.shape == (6,)


def test_wrapper_validates_its_arguments(monkeypatch):
    cd = funnel(rtt).density()
    kw = dict(step_size=0.5, n_steps=2, n_iterations=2, seed=0)
    with pytest.raises(ValueError, match="rows"):
        F.fused_hmc(cd, torch.zeros(9, 4), **kw)
    with pytest.raises(ValueError, match="float32"):
        F.fused_hmc(cd, torch.zeros(10, 4, dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="inv_mass_diag"):
        F.fused_hmc(cd, torch.zeros(10, 4), inv_mass_diag=torch.ones(3), **kw)
    with pytest.raises(ValueError, match="noise"):
        F.fused_hmc(cd, torch.zeros(10, 4),
                    noise=(torch.zeros(2, 10, 3), torch.zeros(2, 3)), **kw)
    with pytest.raises(ValueError, match="n_steps >= 1"):
        F.fused_hmc(cd, torch.zeros(10, 4), **{**kw, "n_steps": 0})
    # a model over LOCAL_STATE_MAX parameters keeps its state in the
    # workspace, one slot for every chain of the launch's blocks (the
    # ragged edge's copies included), with the 32 lanes' copies of the
    # adjoints every row reads (here none: one float each); a launch whose
    # workspace the device has no room for is refused, naming the bytes
    k = emit_cuda.LOCAL_STATE_MAX + 1
    effects = rtt.Normal(0, 1).latent_vec(k)
    data = rtt.Model.likelihood(R.RowSum(rtt.Normal(
        R.Gather(effects.element, R.IntColumn(np.arange(k))), 1.0)
        .log_density_at(R.Column(np.zeros(k))), k))
    em = emit_cuda.emit(data.density())
    assert em.workspace == emit_cuda.workspace_floats(k, k, True) == \
        9 * k + emit_cuda.LANES + 1
    assert F.workspace_bytes(em, 37) == 4 * em.workspace * 40  # 4-chain
                                                                # blocks
    assert F.workspace_bytes(emit_cuda.emit(cd), 37) == 0
    assert F.workspace_check(em, 37, "cpu") is None
    monkeypatch.setattr(F, "free_bytes", lambda device: 1000)
    with pytest.raises(ValueError, match=f"workspace for 37 chains is "
                                         f"{4 * em.workspace * 40} bytes"):
        F._launch_setup(data.density(), (), 37, "cpu")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(F.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        F._nvcc()


def test_op_count_covers_density_and_rng():
    em = emit_cuda.emit(funnel(rtt).density())
    # 5 density+gradient evaluations plus 6 Philox blocks of 98 operations
    assert em.density_ops() == em.ops and em.row_ops == 0
    assert F.op_count(em, 5) > 5 * em.ops + 6 * 98
