"""The port's ``parallel/`` on ``torch.distributed`` (gloo, on the CPU),
held against the JAX package's mesh (tests/conftest.py's 8 virtual CPU
devices) and against the port without a mesh.

Two worlds of processes run at once, one device (here the CPU) a rank:
world "a" of 2 ranks, joined by ``parallel.initialize(coordinator, n,
rank)`` as tests/test_distributed.py joins the JAX package's, and world
"b" of 4, joined by ``parallel.initialize()`` from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``).  Their ranks run this file as
``python tests/test_torch_parallel.py WORLD PORT N RANK OUTDIR`` and each
writes what it saw to ``OUTDIR/WORLD_RANK.npz``; the tests read those and
run the references in the pytest process.

* the mesh: (2, 2) in a world of 4 has shape {chains: 2, data: 2};
  ``make_mesh(16, 2)`` raises naming both numbers
  (tests/test_parallel.py:31-36), and so does a chain count the chains
  axis does not divide;
* the data-sharded density at (1, 2) and q = 0.3·1, against the JAX
  package's ``lpg(q, shard_columns(cols, mesh))`` and the port's
  unsharded density (lp rtol 1e-5, g rtol 1e-4), on test_parallel.py's
  64-row regression, the same at 63 rows (its columns replicated with a
  warning), a prior over a ``Gather`` by an ``IntColumn`` (the prior
  counted once), an ``MVNormal`` prior (a ``MatVec`` of its factor read
  whole) and two row spaces;
* sampling at (2, 1), (1, 2) and (2, 2) against the port's unsharded run
  and the JAX package's sharded run (test_parallel.py:47-53's bars), the
  ranks holding the same bits; pooled adaptation (one mass and step size,
  :70-77); synchronized EHMC (one sampling-phase ``grad_evals``); the
  4096-row logistic at (1, 2) (tests/test_baseline_models.py:61-77);
  SMC on tests/test_smc.py:109-111's conjugate model at each mesh;
  tests/test_distributed.py's two-process run; a run in segments with a
  progress, the run at once bit for bit, its progress over every chain;
  ``fused`` warns and ``fused!`` raises with a mesh;
* in the pytest process, ``initialize()`` with neither does nothing, and a
  mesh of one rank (``make_mesh`` with no process group) samples and runs
  SMC bit for bit as no mesh does.
"""

import io
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import rainier_tpu_torch as rtt  # noqa: E402

rtt.config.set_device("cpu")

WORLDS = {"a": 2, "b": 4}
SAMPLE_CFG = (100, 200, 5)        # warmup, iterations, HMC steps
SAMPLE_CHAINS = 8
SMC_PARTICLES = 2048


def _R(rt):
    return sys.modules[rt.__name__ + ".compute.real"]


# -- models, built through either package -------------------------------------


def regression(rt, n=64):
    """tests/test_parallel.py:20-28 (at n rows)."""
    rng = np.random.default_rng(0)
    xs = [tuple(r) for r in rng.normal(size=(n, 3))]
    ys = [float(np.dot(x, [1.0, -2.0, 0.5]) + 0.3 * rng.normal())
          for x in xs]
    sigma = rt.Exponential(1).latent()
    betas = rt.Normal(0, 1).latent_vec(3)
    return rt.Model.observe(ys, rt.Vec.from_(xs).map(
        lambda t: rt.Normal(rt.Vec.of(*t).dot(betas), sigma)))


def prior_gather(rt, k=6):
    """Group effects under a scale with its own prior, gathered by an
    integer index column (benchmarks/models.py:111-142's structure)."""
    R = _R(rt)
    sd = rt.Exponential(1).latent()
    effects = rt.Normal(0, sd).latent_vec(k)
    idx = R.IntColumn(np.repeat(np.arange(k), 3))
    y = np.random.default_rng(8).normal(size=3 * k)
    return rt.Model.likelihood(R.RowSum(rt.Normal(
        R.Gather(effects.element, idx), 1.0).log_density_at(R.Column(y)),
        3 * k))


def mvnormal_prior(rt, n=64, p=3):
    """A logistic regression under an ``MVNormal`` prior, whose Cholesky
    factor a ``MatVec`` reads whole."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, p))
    ys = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ rng.normal(size=p))))
    i = np.arange(p)
    cov = 25.0 * 0.5 ** np.abs(i[:, None] - i[None, :])
    alpha = rt.Normal(0, 5).latent()
    betas = rt.MVNormal([0.0] * p, cov).latent_vec()
    return rt.Model.observe(list(ys.astype(float)), rt.Vec.from_(
        [tuple(r) for r in x]).map(lambda t: rt.Bernoulli(
            (alpha + rt.Vec.of(*t).dot(betas)).logistic())))


def two_spaces(rt):
    """Two observe blocks of 30 and 50 rows: two row spaces."""
    rng = np.random.default_rng(2)
    mu = rt.Normal(0, 1).latent()
    s = rt.Exponential(1).latent()
    a = rt.Model.observe(list(rng.normal(1, 2, 30)), rt.Normal(mu, s))
    b = rt.Model.observe(list(rng.normal(1, 2, 50)), rt.Normal(mu + 0.5, s))
    return a.merge(b)


DENSITIES = {"regression": regression,
             "uneven": lambda rt: regression(rt, 63),
             "prior_gather": prior_gather,
             "mvnormal_prior": mvnormal_prior,
             "two_spaces": two_spaces}


def logistic(rt, n=4096, p=4):
    """tests/test_baseline_models.py:61-77: (model, betas, true betas)."""
    R = _R(rt)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, p))
    true_b = np.array([1.0, -0.5, 0.25, 0.0])
    ys = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ true_b)))).astype(
        float)
    betas = rt.Normal(0, 5).latent_vec(p)
    lh = R.RowSum(rt.Bernoulli(R.MatVec(R.MatColumn(x), betas.element)
                               .logistic()).log_density_at(R.Column(ys)), n)
    return rt.Model.likelihood(lh), betas, true_b


def conjugate(rt):
    """tests/test_smc.py:53-67: (model, posterior mean, log Z)."""
    rng = np.random.default_rng(3)
    ys = (1.5 + rng.normal(size=20)).tolist()
    mu = rt.Normal(0, 1).latent()
    model = rt.Model.observe(ys, rt.Normal(mu, 1))
    n = len(ys)
    y = np.array(ys)
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    log_z = float(-0.5 * (y @ np.linalg.solve(cov, y)) - 0.5 * logdet
                  - 0.5 * n * np.log(2 * np.pi))
    return model, float(np.sum(ys) / (1.0 + n)), log_z


def ehmc_model(rt):
    """tests/test_torch_ehmc.py's model for synchronized EHMC."""
    data = np.random.default_rng(3).normal(1.5, 2.0, size=128)
    mu = rt.Normal(0, 10).latent()
    sigma = rt.Exponential(0.5).latent()
    return rt.Model.observe(list(data), rt.Normal(mu, sigma))


# -- the ranks -----------------------------------------------------------------


def _sample_cfg(sampler_cfg):
    w, it, steps = SAMPLE_CFG
    return sampler_cfg.SamplerConfig(w, it, sampler=sampler_cfg.HMC(steps))


def _world_a(out, mesh_of):
    """World "a": 2 ranks."""
    from rainier_tpu_torch import sampler as S
    from rainier_tpu_torch.parallel import make_mesh, sharded_logp_fn
    from rainier_tpu_torch.sampler.smc import SMCConfig

    m21, m12 = mesh_of(2, 1), mesh_of(1, 2)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger("rainier_tpu_torch").addHandler(Keep())
    for name, build in DENSITIES.items():
        records.clear()
        cd = build(rtt).density()
        fn, _ = sharded_logp_fn(cd, m12)
        lp, g = fn(torch.full((cd.n_vars,), 0.3))
        out[f"density_{name}_lp"] = lp.numpy()
        out[f"density_{name}_g"] = g.numpy()
        out[f"density_{name}_log"] = np.array(" | ".join(records))

    model = regression(rtt)
    for tag, mesh in (("21", m21), ("12", m12)):
        tr = model.sample(_sample_cfg(S), n_chains=SAMPLE_CHAINS, seed=0,
                          mesh=mesh)
        out[f"sample_{tag}"] = tr.chains
    pooled = S.SamplerConfig(150, 100, sampler=S.HMC(5),
                             pooled_adaptation=True)
    tr = model.sample(pooled, n_chains=SAMPLE_CHAINS, seed=0, mesh=m21)
    out["pooled_diag"] = tr.mass.diag
    out["pooled_step"] = tr.step_size

    tr = ehmc_model(rtt).sample(
        S.SamplerConfig(100, 100, sampler=S.EHMC(max_steps=64,
                                                 synchronized=True)),
        n_chains=SAMPLE_CHAINS, seed=0, mesh=m21)
    out["ehmc_grad_evals"] = tr.stats.grad_evals

    lmodel, betas, _ = logistic(rtt)
    tr = lmodel.sample(S.SamplerConfig(400, 600, sampler=S.HMC(8)),
                       n_chains=4, seed=0, mesh=m12)
    out["logistic_betas"] = np.array([tr.mean(betas[i]) for i in range(4)])

    cmodel, _, _ = conjugate(rtt)
    for tag, mesh in (("21", m21), ("12", m12)):
        trace, res = cmodel.smc(SMCConfig(n_particles=SMC_PARTICLES,
                                          mutation_steps=2), seed=5,
                                mesh=mesh)
        out[f"smc_{tag}"] = np.array([trace.flat()[:, 0].mean(),
                                      float(res.log_evidence),
                                      trace.n_chains * trace.n_iterations])

    # segments with a progress: the run at once, bit for bit, and the
    # progress reads every chain
    short = S.SamplerConfig(30, 20, sampler=S.HMC(3))
    buf = io.StringIO()
    progress = S.ConsoleProgress(buf)
    progress.output_every_seconds = 0.0
    chunked = model.sample(short, n_chains=SAMPLE_CHAINS, seed=0, mesh=m21,
                           chunk_iters=7, progress=progress)
    whole = model.sample(short, n_chains=SAMPLE_CHAINS, seed=0, mesh=m21)
    out["chunked_same"] = np.array(np.array_equal(chunked.chains,
                                                  whole.chains))
    out["progress"] = np.array(buf.getvalue())

    tiny = S.SamplerConfig(10, 10, sampler=S.HMC(3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = model.sample(tiny, n_chains=4, kernel="fused", mesh=m21)
    out["fused_warning"] = np.array(" | ".join(str(w.message)
                                               for w in caught))
    out["fused_shape"] = np.array(tr.chains.shape)
    try:
        model.sample(tiny, n_chains=4, kernel="fused!", mesh=m21)
        out["fused_bang"] = np.array("no error")
    except ValueError as e:
        out["fused_bang"] = np.array(str(e))

    # tests/test_distributed.py's two-process run, every rank on chains
    data = np.random.default_rng(0).normal(2.0, 1.0, size=128)
    mu = rtt.Normal(0, 10).latent()
    mmodel = rtt.Model.observe(list(data), rtt.Normal(mu, 1.0))
    cfg = S.SamplerConfig(200, 300, sampler=S.HMC(5), pooled_adaptation=True)
    import torch.distributed as dist

    world = dist.get_world_size()
    trace = mmodel.sample(cfg, n_chains=world * 8, seed=0, mesh=make_mesh())
    out["two_process"] = np.array([world, trace.n_chains,
                                   float(trace.mean(mu))])


def _world_b(out, mesh_of):
    """World "b": 4 ranks."""
    from rainier_tpu_torch import sampler as S
    from rainier_tpu_torch.parallel import make_mesh
    from rainier_tpu_torch.sampler.smc import SMCConfig

    m22 = mesh_of(2, 2)
    out["mesh_shape"] = np.array(json.dumps(
        dict(zip(m22.mesh_dim_names, m22.shape))))
    try:
        make_mesh(16, 2)
        out["mesh_too_big"] = np.array("no error")
    except ValueError as e:
        out["mesh_too_big"] = np.array(str(e))
    try:
        regression(rtt).sample(_sample_cfg(S), n_chains=5, mesh=m22)
        out["chains_uneven"] = np.array("no error")
    except ValueError as e:
        out["chains_uneven"] = np.array(str(e))
    tr = regression(rtt).sample(_sample_cfg(S), n_chains=SAMPLE_CHAINS,
                                seed=0, mesh=m22)
    out["sample_22"] = tr.chains
    cmodel, _, _ = conjugate(rtt)
    trace, res = cmodel.smc(SMCConfig(n_particles=SMC_PARTICLES,
                                      mutation_steps=2), seed=5, mesh=m22)
    out["smc_22"] = np.array([trace.flat()[:, 0].mean(),
                              float(res.log_evidence),
                              trace.n_chains * trace.n_iterations])


def _rank(world, port, n, rank, outdir):
    torch.set_num_threads(1)
    from rainier_tpu_torch.parallel import initialize, make_mesh

    if world == "a":
        initialize(f"127.0.0.1:{port}", int(n), int(rank))
    else:
        initialize()
    meshes = {}

    def mesh_of(c, d):
        # every rank builds every mesh, in the same order
        if (c, d) not in meshes:
            meshes[c, d] = make_mesh(c, d)
        return meshes[c, d]

    out = {}
    {"a": _world_a, "b": _world_b}[world](out, mesh_of)
    np.savez(os.path.join(outdir, f"{world}_{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


# -- the tests -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds():
    """Both worlds, started together; {world: [each rank's results]}."""
    outdir = tempfile.mkdtemp(prefix="rt_parallel_")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = []
    for world, n in WORLDS.items():
        port = _free_port()
        for r in range(n):
            # world "b" joins through torchrun's variables
            renv = env if world == "a" else dict(
                env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r))
            procs.append((world, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), world, str(port),
                 str(n), str(r), outdir], env=renv, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
    failed = []
    for world, p in procs:
        text, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            failed.append(f"world {world}: {text.decode()[-3000:]}")
    assert not failed, "\n".join(failed)
    return {world: [dict(np.load(os.path.join(outdir, f"{world}_{r}.npz")))
                    for r in range(n)] for world, n in WORLDS.items()}


@pytest.fixture(scope="module")
def local_regression():
    """The port's run without a mesh, and the JAX package's on a
    (4, 2) mesh (tests/test_parallel.py:39-53), of the same model."""
    import rainier_tpu as rtj
    from rainier_tpu.parallel import make_mesh as make_mesh_j
    from rainier_tpu_torch import sampler as S

    w, it, steps = SAMPLE_CFG
    port = regression(rtt).sample(_sample_cfg(S), n_chains=SAMPLE_CHAINS,
                                  seed=0).chains
    jax_run = regression(rtj).sample(
        rtj.sampler.SamplerConfig(w, it, sampler=rtj.sampler.HMC(steps)),
        n_chains=SAMPLE_CHAINS, seed=0,
        mesh=make_mesh_j(n_chain_shards=4, n_data_shards=2)).chains
    return port, np.asarray(jax_run)


def test_mesh_shape_and_too_many_ranks(worlds):
    for rank in worlds["b"]:
        assert json.loads(str(rank["mesh_shape"])) == {"chains": 2,
                                                       "data": 2}
        msg = str(rank["mesh_too_big"])
        assert "16 chain shards x 2 data shards" in msg and "have 4" in msg
        assert str(rank["chains_uneven"]) == ("5 chains do not split over 2 "
                                              "chain shards")


@pytest.mark.parametrize("name", list(DENSITIES))
def test_data_sharded_density(worlds, name):
    import jax
    import jax.numpy as jnp

    import rainier_tpu as rtj
    from rainier_tpu.parallel import make_mesh as make_mesh_j
    from rainier_tpu.parallel import shard_columns as shard_columns_j

    cdj = DENSITIES[name](rtj).density()
    cols = cdj.column_values()
    mesh = make_mesh_j(n_chain_shards=1, n_data_shards=2)
    q = jnp.ones((cdj.n_vars,)) * 0.3
    lpg = cdj.logp_and_grad_fn()
    lp_j, g_j = jax.jit(lambda q: lpg(q, shard_columns_j(cols, mesh)))(q)
    cdt = DENSITIES[name](rtt).density()
    lp_t, g_t = cdt.logp_and_grad(np.full(cdt.n_vars, 0.3), device="cpu")
    a, b = worlds["a"]
    # the two ranks of the data group hold the same bits
    np.testing.assert_array_equal(a[f"density_{name}_lp"],
                                  b[f"density_{name}_lp"])
    np.testing.assert_array_equal(a[f"density_{name}_g"],
                                  b[f"density_{name}_g"])
    lp, g = float(a[f"density_{name}_lp"]), a[f"density_{name}_g"]
    for lp_ref, g_ref in ((float(lp_j), np.asarray(g_j)),
                          (float(lp_t), g_t.numpy())):
        np.testing.assert_allclose(lp, lp_ref, rtol=1e-5)
        np.testing.assert_allclose(g, g_ref, rtol=1e-4)
    log = str(a[f"density_{name}_log"])
    if name == "uneven":
        assert "column of 63 rows not divisible by 2 data shards; " \
               "replicating" in log
    else:
        assert "replicating" not in log


def _moments_agree(draws, ref):
    m1, m2 = draws.reshape(-1, draws.shape[-1]).mean(0), \
        ref.reshape(-1, ref.shape[-1]).mean(0)
    s1, s2 = draws.reshape(-1, draws.shape[-1]).std(0), \
        ref.reshape(-1, ref.shape[-1]).std(0)
    np.testing.assert_allclose(m1, m2, atol=4 * np.max(s1) / np.sqrt(100))
    np.testing.assert_allclose(s1, s2, rtol=0.5)


@pytest.mark.parametrize("mesh", ["21", "12", "22"])
def test_sampling_on_a_mesh(worlds, local_regression, mesh):
    ranks = worlds["b" if mesh == "22" else "a"]
    draws = ranks[0][f"sample_{mesh}"]
    assert draws.shape == (SAMPLE_CHAINS, SAMPLE_CFG[1], 4)
    assert np.all(np.isfinite(draws))
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"sample_{mesh}"], draws)
    port, jax_run = local_regression
    _moments_agree(draws, port)
    _moments_agree(draws, jax_run)


def test_pooled_adaptation_on_a_mesh(worlds):
    """One mass diagonal for every chain of both ranks; every chain's step
    size the same on both ranks.  Pooling shares the acceptance statistic
    and the Welford state, not the initial step size, which the heuristic
    finds per chain (as the JAX package's vmapped init does), so the
    chains' step sizes differ by that heuristic's powers of two only."""
    diag = [r["pooled_diag"] for r in worlds["a"]]
    step = [r["pooled_step"] for r in worlds["a"]]
    assert diag[0].shape == (SAMPLE_CHAINS, 4)
    for d, s in zip(diag, step):
        assert np.allclose(d, diag[0][0], rtol=1e-4)
        np.testing.assert_allclose(s, step[0], rtol=1e-4)
    ratio = step[0] / step[0][0]
    np.testing.assert_allclose(ratio, 2.0 ** np.round(np.log2(ratio)),
                               rtol=1e-4)


def test_synchronized_ehmc_on_a_mesh(worlds):
    evals = np.concatenate([r["ehmc_grad_evals"] for r in worlds["a"]])
    assert evals.shape == (2 * SAMPLE_CHAINS,)
    assert np.all(evals == evals[0]) and evals[0] > 0


def test_logistic_data_sharded(worlds):
    _, _, true_b = logistic(rtt)
    for rank in worlds["a"]:
        est = rank["logistic_betas"]
        assert np.all(np.abs(est - true_b) < 0.2), est


@pytest.mark.parametrize("mesh", ["21", "12", "22"])
def test_smc_on_a_mesh(worlds, mesh):
    _, post_mean, log_z = conjugate(rtt)
    ranks = worlds["b" if mesh == "22" else "a"]
    for rank in ranks:
        mean, log_ev, n = rank[f"smc_{mesh}"]
        assert n == SMC_PARTICLES
        assert abs(mean - post_mean) < 0.06
        assert abs(log_ev - log_z) < 0.6
    for rank in ranks[1:]:
        np.testing.assert_array_equal(rank[f"smc_{mesh}"],
                                      ranks[0][f"smc_{mesh}"])


def test_two_processes_through_initialize(worlds):
    for rank in worlds["a"]:
        count, n_chains, mu = rank["two_process"]
        assert count == 2 and n_chains == 16
        assert abs(mu - 2.0) < 0.3


def test_segments_and_progress_on_a_mesh(worlds):
    for rank in worlds["a"]:
        assert bool(rank["chunked_same"])
        text = str(rank["progress"])
        assert text.startswith(f"sampling {SAMPLE_CHAINS} chains")
        assert "warmup 7/30" in text and "complete 20/20" in text


def test_fused_with_a_mesh(worlds):
    for rank in worlds["a"]:
        assert "falling back to the scan path" in str(rank["fused_warning"])
        assert "single-device" in str(rank["fused_warning"])
        assert tuple(rank["fused_shape"]) == (4, 10, 4)
        assert str(rank["fused_bang"]).startswith("kernel='fused!'")
        assert "single-device" in str(rank["fused_bang"])


def test_mesh_of_one_rank_is_no_mesh():
    """initialize() with no coordinator and no torchrun variables does
    nothing; make_mesh with no process group makes a world of one, and
    sampling and SMC on it are the runs without a mesh, bit for bit."""
    import torch.distributed as dist

    from rainier_tpu_torch import sampler as S
    from rainier_tpu_torch.parallel import initialize, is_primary, make_mesh
    from rainier_tpu_torch.sampler.smc import SMCConfig

    assert not dist.is_initialized()
    initialize()
    assert not dist.is_initialized() and is_primary()
    try:
        mesh = make_mesh()
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"chains": 1,
                                                              "data": 1}
        model = regression(rtt)
        cfg = S.SamplerConfig(30, 20, sampler=S.HMC(4))
        a = model.sample(cfg, n_chains=4, seed=3, mesh=mesh)
        b = model.sample(cfg, n_chains=4, seed=3)
        np.testing.assert_array_equal(a.chains, b.chains)
        np.testing.assert_array_equal(a.mass.diag, b.mass.diag)
        cmodel, _, _ = conjugate(rtt)
        smc_cfg = SMCConfig(n_particles=256, mutation_steps=1)
        (ta, ra), (tb, rb) = (cmodel.smc(smc_cfg, seed=1, mesh=m)
                              for m in (mesh, None))
        np.testing.assert_array_equal(ta.chains, tb.chains)
        assert float(ra.log_evidence) == float(rb.log_evidence)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_rank(*sys.argv[1:]))
