"""The chain slots of the port's models with rows (csrc/fused_hmc.cu): a
slot in the block's shared memory where the block's slots fit beside its
tiles (``emit_cuda.shared_slot``), the warp's scatter of its rows' gather
adjoints as a fixed tree (``rt_scatter``), and, over a slot in device
memory, several steps of rows with their gathers in flight and their
scatters merged (``emit_cuda.gather_step``, ``rt_scatter_steps``).

``csrc/fused_hmc.cu`` compiled for the host with g++ emulates a chain's
32 lanes and adds in the card's order (test_torch_lanes.py), so these run
here.  Checked, with the tolerance and its reason at each assertion:

* a GLMMPoisson2 of 20 sites × 12 years (37 parameters, past
  ``LANE_STATE_MAX``: its slot in shared memory, the year index the same
  in 20 neighbouring rows) and glmm_large at 300 groups (302 parameters:
  its slot in device memory, several steps of rows at once), the host-built
  density against autograd on the plain version and the JAX package's
  ``logp_and_grad``, the host-built kernel against the plain version and
  the JAX package's kernel (``fused_hmc(host_rng=True, interpret=True)``)
  on the same noise, two launches and streamed against synchronous bit
  for bit, at 1, 2, 4 and 8 steps at once;
* the tree's sums against numpy in its stated order, one step and
  several, for indices all equal, all distinct, in groups of 5, past the
  tile's rows and at random;
* the layout rule: shared memory where the slots fit, device memory past
  ``LOCAL_STATE_MAX`` parameters and where a wide row's tiles leave no
  room.
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
from rainier_tpu.ops import fused_hmc as fused_hmc_jax
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import (_R, _host_library, _host_logp_grad,
                                _jax_noise, _run_host)
from test_torch_columnfree import funnel
from test_torch_gather import _warmed_up, glmm_poisson
from test_torch_large_models import glmm_large

torch.set_num_threads(2)
rtt.config.set_device("cpu")

MODELS = {"glmm_20x12": lambda rt: glmm_poisson(rt, 20, 12)[0],
          "glmm_large_300": lambda rt: glmm_large(rt, 300)}
# the steps of rows glmm_large_300 runs at once in the cases that vary it
STEPS = (1, 2, 4, 8)


def wide_logistic(rt, p=100, n=300):
    """A logistic regression of p features (p + 1 ≤ LOCAL_STATE_MAX
    parameters) whose rows of p + 1 floats take 256-row tiles, 207 KB
    for two, beside which a block's slots do not fit."""
    R = _R(rt)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n, p))
    ys = (rng.uniform(size=n) < 0.5).astype(float)
    alpha = rt.Normal(0, 5).latent()
    betas = rt.Normal(0, 5).latent_vec(p)
    lin = alpha + R.MatVec(R.MatColumn(x), betas.element)
    return rt.Model.likelihood(R.RowSum(
        rt.Bernoulli(lin.logistic()).log_density_at(R.Column(ys)), n))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(name, steps) -> (torch model, its density, host library, emitted),
    emitted with `steps` steps of rows at once over a slot in device
    memory (emit_cuda.GATHER_STEP; None: the emitter's), each built
    once."""
    cache = {}

    def get(name, steps=None):
        key = (name, steps)
        if key not in cache:
            model = MODELS[name](rtt)
            cd = model.density()
            if steps is not None:
                old = emit_cuda.GATHER_STEP
                emit_cuda.GATHER_STEP = steps
                try:
                    em = emit_cuda.emit(cd, stage_budget=emit_cuda.
                                        SMEM_BYTES_MAX)
                finally:
                    emit_cuda.GATHER_STEP = old
                assert em is emit_cuda.emit(cd)
            lib, em = _host_library(cd, tmp_path_factory.mktemp(name))
            cache[key] = (model, cd, lib, em)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def starts():
    """(name, n) -> (q0 (dim, n), ε (n,), Σ̂ (n, dim)) from a short
    scan-path warmup: 13 chains by default, a last block of one chain and
    three copies."""
    cache = {}

    def get(name, model, n=13):
        if (name, n) not in cache:
            cache[name, n] = _warmed_up(model, n)
        return cache[name, n]

    return get


CASES = [("glmm_20x12", None), *[("glmm_large_300", k) for k in STEPS]]


def _case_id(case):
    name, steps = case
    return name if steps is None else f"{name}-{steps}steps"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_layout_of_each_case(case, built):
    """The GLMM's 8 slots of a block lie in shared memory beside its one
    tile, with no device workspace, its rows one step at a time;
    glmm_large's, past LOCAL_STATE_MAX parameters, in the device
    workspace, its rows `steps` steps at once (by default GATHER_STEP),
    their pairs handed back by step."""
    name, steps = case
    _, cd, _, em = built(name, steps)
    assert em.workspace
    if name == "glmm_20x12":
        assert em.shared and "#define RT_WS_SHARED 1" in em.source
        assert F.workspace_bytes(em, 1024) == 0
    else:
        assert not em.shared and "RT_WS_SHARED" not in em.source
        assert F.workspace_bytes(em, 13) == 4 * em.workspace * 16
    steps = steps or emit_cuda.gather_step(em.shared)
    if steps == 1:
        assert "rt_row_step" not in em.source
    else:
        assert f"#define RT_ROW_STEP {steps}" in em.source
        gathers = 2 if name == "glmm_20x12" else 1
        assert f"sidx[{gathers * steps - 1}] = " in em.source


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_host_density_matches_autograd_and_jax(case, built):
    """rt_logp_grad_host at 5 points against torch autograd on the
    port's plain version and the JAX package's logp_and_grad: the same
    f32 terms summed in other orders, so lp within rtol 1e-5 /
    atol 1e-5·(1 + |lp|) and gradients within 1e-5 of max |g|
    (test_torch_large_models.py's tolerances)."""
    name, steps = case
    _, cd, lib, em = built(name, steps)
    dj = MODELS[name](rtj).density()
    large = name.startswith("glmm_large")
    q = np.random.default_rng(3).normal(size=(cd.n_vars, 5)) * (
        0.05 if large else 0.3)
    if large:
        q[0] += np.log(5.0)
        q[1] += np.log(0.3)
        q[2:] += np.log(5.0)
    q = torch.as_tensor(q, dtype=torch.float32)
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, q, cols)
    lp_p, g_p = F.logp_grad_reference(cd, q)
    lpg_j = jax.vmap(dj.logp_and_grad)
    lp_j, g_j = lpg_j(jnp.asarray(q.numpy().T))
    for lp_ref, g_ref in ((lp_p.numpy(), g_p.numpy()),
                          (np.asarray(lp_j), np.asarray(g_j).T)):
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(lp_ref).max()))
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                                   atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_host_kernel_matches_plain_version_and_jax(case, built, starts):
    """The kernel's loop, its lanes emulated, on JAX's host_rng noise,
    against fused_hmc_reference on that noise (13 chains, per-chain ε
    and Σ̂ from a scan-path warmup) and, at 128 chains (a block of the
    JAX kernel's lanes, whose noise is drawn for its padded chains), the
    JAX package's kernel interpreted on the same noise (untiled, its
    logp_lanes_fn), 8 iterations of HMC(4).  Each sums rows in another
    order, so ≥ 90% of chains end within 1e-3 (a flipped borderline
    accept sends a chain away) and accept rates agree within 0.05 on
    average (test_torch_large_models.py's bar)."""
    name, steps = case
    model, cd, lib, em = built(name, steps)
    q0, eps, imd = starts(name, model)
    n, n_it, seed = q0.shape[1], 8, 5
    nz = _jax_noise(seed, n_it, cd.n_vars, n)
    kw = dict(step_size=eps, n_steps=4, n_iterations=n_it, seed=seed,
              collect_every=1, inv_mass_diag=imd)
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05
    assert 0.0 < float(ref[2].mean())          # the chains move
    assert bool(torch.isfinite(got[0]).all())
    if steps not in (None, emit_cuda.GATHER_STEP):
        return              # JAX's kernel once for each model
    m = 128
    q0, eps, imd = starts(name, model, m)
    cdj = MODELS[name](rtj).density()
    lanes = cdj.logp_lanes_fn()
    qf_j, _, acc_j, _ = fused_hmc_jax(
        lambda q, *c: lanes(q, c), jnp.asarray(q0.numpy()),
        block_chains=m, interpret=True, host_rng=True,
        columns=cdj.column_values(jnp.float32),
        **{**kw, "step_size": eps.numpy(), "inv_mass_diag": imd.numpy()})
    got_m = _run_host(lib, cd, q0, {**kw, "step_size": eps,
                                    "inv_mass_diag": imd},
                      _jax_noise(seed, n_it, cd.n_vars, m), cols)
    qf_j = torch.as_tensor(np.asarray(qf_j))
    rel = ((got_m[0] - qf_j).abs() / qf_j.abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got_m[2] - torch.as_tensor(np.asarray(acc_j))).abs()
                 .mean()) < 0.05


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_host_launches_give_the_same_bits(case, built, starts):
    """Two launches on the same inputs, and a launch that streams its
    tiles, give the same bits, and so does the density alone: the tree
    and the merged steps add in one fixed order, with no atomics."""
    name, steps = case
    model, cd, lib, em = built(name, steps)
    q0, eps, imd = starts(name, model)
    kw = dict(step_size=eps, n_steps=4, n_iterations=6, seed=9,
              collect_every=1, inv_mass_diag=imd)
    cols = cd.column_values(torch.float32, "cpu")
    a = _run_host(lib, cd, q0, kw, None, cols)
    b = _run_host(lib, cd, q0, kw, None, cols)
    s = _run_host(lib, cd, q0, kw, None, cols, stream=True)
    for x, y, z in zip(a, b, s):
        assert torch.equal(x, y) and torch.equal(x, z)
    lp, g = _host_logp_grad(lib, em, q0, cols)
    lp_b, g_b = _host_logp_grad(lib, em, q0, cols)
    lp_s, g_s = _host_logp_grad(lib, em, q0, cols, stream=True)
    assert torch.equal(lp, lp_b) and torch.equal(g, g_b)
    assert torch.equal(lp, lp_s) and torch.equal(g, g_s)


# -- the scatter's tree --------------------------------------------------------


def _tree(values):
    """The tree's sum of a group's values in rank order, in f32: ranks r
    and r + off added where r is a multiple of 2·off, off = 1, 2, 4, ..."""
    g = [np.float32(v) for v in values]
    off = 1
    while off < len(g):
        for r in range(0, len(g) - off, 2 * off):
            g[r] = np.float32(g[r] + g[r + off])
        off *= 2
    return g[0]


def _scatter(ainv, k, v):
    """One step's pairs added as rt_scatter adds them: each group of one
    entry (lanes in order) summed by _tree, added to ainv[entry]."""
    for e in dict.fromkeys(int(x) for x in k):
        if e >= 0:
            ainv[e] = np.float32(ainv[e] + _tree(v[k == e]))


def _scatter_steps(ainv, k, v):
    """Several steps' pairs (k, v: (steps, 32)) as rt_scatter_steps adds
    them: each step's group sums by _tree, those of one entry added in
    step order to its first step's, then to ainv[entry] once."""
    sums = {}
    for kj, vj in zip(k, v):
        for e in dict.fromkeys(int(x) for x in kj):
            if e >= 0:
                s = _tree(vj[kj == e])
                sums[e] = s if e not in sums else np.float32(sums[e] + s)
    for e, s in sums.items():
        ainv[e] = np.float32(ainv[e] + s)


@pytest.fixture(scope="module")
def scatter_lib(built, tmp_path_factory):
    """rt_scatter and rt_scatter_steps<4> of a host build of
    csrc/fused_hmc.cu (glmm_large_300's header), as C entry points."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: csrc/fused_hmc.cu cannot be "
                    "compiled for the host")
    d = tmp_path_factory.mktemp("scatter")
    (d / emit_cuda.HEADER_NAME).write_text(built("glmm_large_300")[3].source)
    (d / "probe.cc").write_text(
        '#include "fused_hmc.cu"\n'
        'extern "C" void probe_scatter(float* a, const int* k,\n'
        '                              const float* v) {\n'
        '  rt_scatter(a, k, v);\n}\n'
        'extern "C" void probe_scatter4(float* a, const int* k,\n'
        '                               const float* v) {\n'
        '  rt_scatter_steps<4>(a, (const int (*)[RT_LANES])k,\n'
        '                      (const float (*)[RT_LANES])v);\n}\n')
    so = d / "probe.so"
    res = subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                          "-shared", "-fPIC", "-I", str(d), "-I",
                          str(F.CSRC), "-o", str(so), str(d / "probe.cc")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


def _indices(pattern, rng, steps=1):
    """(steps, 32) int32 entries of a pattern over 40 entries."""
    lane = np.arange(32 * steps).reshape(steps, 32)
    if pattern == "all equal":
        k = np.full_like(lane, 7)
    elif pattern == "all distinct":
        k = lane % 40
    elif pattern == "groups of 5":
        k = lane // 5 % 40
    elif pattern == "past the tile":
        k = np.where(lane % 32 < 20, lane // 3 % 40, -1)
    else:
        k = rng.integers(0, 6, lane.shape)
    return k.astype(np.int32)


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("pattern", ["all equal", "all distinct",
                                     "groups of 5", "past the tile",
                                     "random"])
def test_scatter_tree_adds_in_its_stated_order(pattern, steps, scatter_lib):
    """The host's rt_scatter (one step) and rt_scatter_steps<4> give the
    bits of numpy f32 sums in the stated order: each group of one entry
    summed by the tree over its lanes in order, and, over several steps,
    an entry's step sums added in step order before the one add to ainv.
    A sequential sum of a group's values differs somewhere, so the
    order is what is checked; entries k < 0 (lanes past the tile's rows)
    add nothing."""
    rng = np.random.default_rng(5)
    differs = 0
    for _ in range(20):
        k = _indices(pattern, rng, steps)
        v = (rng.normal(size=k.shape) * 10.0 ** rng.integers(-3, 4, k.shape)
             ).astype(np.float32)
        ainv = rng.normal(size=40).astype(np.float32)
        want, got = ainv.copy(), ainv.copy()
        ptr = (lambda a, t: a.ctypes.data_as(ctypes.POINTER(t)))
        if steps == 1:
            _scatter(want, k[0], v[0])
            scatter_lib.probe_scatter(ptr(got, ctypes.c_float),
                                      ptr(k[0], ctypes.c_int),
                                      ptr(v[0], ctypes.c_float))
        else:
            _scatter_steps(want, k, v)
            scatter_lib.probe_scatter4(ptr(got, ctypes.c_float),
                                       ptr(np.ascontiguousarray(k),
                                           ctypes.c_int),
                                       ptr(v, ctypes.c_float))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        seq = ainv.copy()
        for e, x in zip(k.ravel(), v.ravel()):
            if e >= 0:
                seq[e] = np.float32(seq[e] + x)
        differs += int(not np.array_equal(seq, got))
        untouched = np.setdiff1d(np.arange(40), k[k >= 0])
        assert np.array_equal(got[untouched], ainv[untouched])
    if pattern != "all distinct" or steps > 1:
        assert differs > 0


# -- the layout rule ------------------------------------------------------------


@pytest.mark.parametrize("name", ["glmm_20x12", "glmm_large_300",
                                  "wide_logistic", "funnel_40"])
def test_layout_rule_picks_the_device_slot_where_slots_do_not_fit(name):
    """emit_cuda.shared_slot: a slot lies in the block's shared memory up
    to LOCAL_STATE_MAX parameters where the block's BLOCK_THREADS_MAX / 32
    slots fit beside two of its widest tiles in SMEM_BYTES_MAX, and the
    wrapper then allocates no workspace; else in the device workspace,
    one slot a chain: glmm_large past LOCAL_STATE_MAX parameters, and the
    101-parameter logistic whose two 256-row tiles of 101 floats leave
    no room for 8 slots of 4,141 floats."""
    model = {"wide_logistic": wide_logistic,
             "funnel_40": lambda rt: funnel(rt, 40),
             **MODELS}[name](rtt)
    em = emit_cuda.emit(model.density())
    assert em.workspace
    top = max(em.spaces, key=lambda t: t.tile_rows * t.row_width,
              default=emit_cuda.SpaceTiles(0, 0, 0, 0))
    room = emit_cuda.slots_bytes(em.workspace) + 8 * top.tile_rows * \
        top.row_width <= emit_cuda.SMEM_BYTES_MAX
    want = em.n_vars <= emit_cuda.LOCAL_STATE_MAX and room
    assert em.shared == want == (name in ("glmm_20x12", "funnel_40"))
    assert (F.workspace_bytes(em, 1024) == 0) == want
    if name == "wide_logistic":
        assert em.n_vars <= emit_cuda.LOCAL_STATE_MAX and not room
