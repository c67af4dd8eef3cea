"""EHMC in the PyTorch port against the JAX package.

Deterministic pieces from the same seeded inputs: ``ring_add_many``,
including a batch larger than the ring; the unified trajectory
``_ehmc_trajectory`` at 256 lanes against ``jax.vmap`` of the JAX
function from the same momenta (counting and replay lanes, lanes that
reach ``max_steps`` and lanes that U-turn before ``min_steps``): step
counts equal on at least 99% of lanes and states within 1e-4 relative
where they are; a few vmapped JAX ``_ehmc_step``s leave every lane's ring
identical, which is why synchronized mode may replay lane 0's draw; and
the one place the port departs on purpose (ROADMAP C5.3: an empty ring
replays ``min_steps``, where the JAX package replays 1).  Posteriors
(the RNG streams differ) as tests/test_sampler.py:241-269 holds them.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.sampler import samplers as samplers_j
from rainier_tpu.sampler.leapfrog import ChainState as ChainState_j
from rainier_tpu.sampler.mass import MassState as MassState_j
from rainier_tpu_torch.sampler import EHMC, SamplerConfig
from rainier_tpu_torch.sampler import samplers as samplers_t
from rainier_tpu_torch.sampler.leapfrog import ChainState, _select
from rainier_tpu_torch.sampler.mass import MassState, identity_mass, kinetic
from rainier_tpu_torch.sampler.stats import COUNTS

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def eight_schools(rt):
    """benchmarks/models.py:49-60, non-centred, 10 parameters: (model, mu,
    tau, theta_1)."""
    y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    s = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
    mu = rt.Normal(0, 5).latent()
    tau = rt.Cauchy(0, 5).latent().abs()
    thetas = rt.Normal(mu, tau).latent_vec(8)
    model = rt.Model.empty()
    for i in range(8):
        model = model.merge(rt.Model.observe([y[i]], rt.Normal(thetas[i],
                                                               s[i])))
    return model, mu, tau, thetas[0]


def densities():
    """The same model's per-chain JAX density and batched port density."""
    cdj = eight_schools(rtj)[0].density()
    cdt = eight_schools(rtt)[0].density()
    lpg_j, cols_j = cdj.logp_and_grad_fn(), cdj.column_values()
    raw, cols_t = (cdt.batched_logp_and_grad_fn(),
                   cdt.column_values(torch.float32, torch.device("cpu")))
    return (lambda q: lpg_j(q, cols_j)), (lambda q: raw(q, cols_t))


def rel_ok(a, b, tol=1e-4):
    """Per lane: every entry within tol relative (to max(1, |b|)), or the
    same non-finite value (a lane whose trajectory diverged)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(invalid="ignore"):
        ok = (np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))) | (a == b) \
            | (np.isnan(a) & np.isnan(b))
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def test_ring_add_many_matches_jax():
    rng = np.random.default_rng(0)
    size = 100
    rb = samplers_t.ring_init(size, 3, torch.float32, "cpu")
    # three rings at different cursors and fills
    for k, n in enumerate((0, 37, 140)):
        for v in rng.integers(1, 50, size=n):
            one = samplers_t.ring_add(rb, torch.full((3,), float(v)))
            rb = _select(torch.arange(3) == k, one, rb)
    for n_vals in (7, 250):          # fewer values than slots, and more
        vals = rng.integers(1, 1000, size=n_vals).astype(np.float32)
        valid = rng.uniform(size=n_vals) < 0.6
        got = samplers_t.ring_add_many(rb, torch.as_tensor(vals),
                                       torch.as_tensor(valid))
        for k in range(3):
            one = samplers_j.RingBuffer(jnp.asarray(rb.buf[k].numpy()),
                                        jnp.asarray(rb.idx[k].numpy()),
                                        jnp.asarray(rb.count[k].numpy()))
            want = samplers_j.ring_add_many(one, jnp.asarray(vals),
                                            jnp.asarray(valid))
            np.testing.assert_array_equal(got.buf[k].numpy(),
                                          np.asarray(want.buf))
            assert int(got.idx[k]) == int(want.idx)
            assert int(got.count[k]) == int(want.count)
        assert got.idx.dtype == torch.int32 and got.count.dtype == torch.int32
        rb = got


def test_trajectory_matches_vmapped_jax():
    lpg_j, lpg_t = densities()
    rng = np.random.default_rng(1)
    c, n = 256, 10
    cfg_j = rtj.sampler.EHMC(max_steps=60, min_steps=8)
    cfg_t = EHMC(max_steps=60, min_steps=8)
    q = (0.5 * rng.normal(size=(c, n))).astype(np.float32)
    p0 = rng.normal(size=(c, n)).astype(np.float32)
    eps = np.exp(rng.uniform(np.log(0.01), np.log(0.5), size=c)).astype(
        np.float32)
    diag = rng.uniform(0.5, 2.0, size=(c, n)).astype(np.float32)
    counting = rng.uniform(size=c) < 0.5
    n_target = rng.integers(1, 40, size=c).astype(np.int32)

    lp_t, g_t = lpg_t(torch.as_tensor(q))
    chain_t = ChainState(torch.as_tensor(q), -lp_t, g_t)
    prop_t, p1_t, lc_t, ng_t = samplers_t._ehmc_trajectory(
        chain_t, torch.as_tensor(p0), torch.as_tensor(eps),
        MassState(diag=torch.as_tensor(diag)), lpg_t,
        torch.as_tensor(counting), torch.as_tensor(n_target), cfg_t)

    def one(q, p0, eps, diag, counting, n_target):
        lp, g = lpg_j(q)
        return samplers_j._ehmc_trajectory(
            ChainState_j(q, -lp, g), p0, eps, MassState_j(diag=diag), lpg_j,
            counting, n_target, cfg_j)

    prop_j, p1_j, lc_j, ng_j = jax.jit(jax.vmap(one))(
        q, p0, eps, diag, counting, n_target)
    lc_j, ng_j = np.asarray(lc_j), np.asarray(ng_j)
    same = (lc_t.numpy() == lc_j) & (ng_t.numpy() == ng_j)
    assert same.mean() >= 0.99, same.mean()
    # the lanes cover every way a trajectory ends
    assert np.any(counting & (lc_j == 60))               # max_steps
    assert np.any(counting & (lc_j < 8))                 # U-turn early
    assert np.any(counting & (lc_j >= 8) & (lc_j < 60))  # U-turn
    assert np.all(ng_j[~counting] == n_target[~counting])
    assert np.all(ng_j[counting] == np.maximum(lc_j, 8)[counting])
    for got, want in ((prop_t.q, prop_j.q), (p1_t, p1_j),
                      (prop_t.potential, prop_j.potential),
                      (prop_t.grad, prop_j.grad)):
        ok = rel_ok(got.numpy(), want)
        assert ok[same].all(), np.flatnonzero(same & ~ok)


def test_vmapped_jax_steps_leave_every_ring_identical():
    """Synchronized mode pools every counting lane's length into every
    lane's ring, so the rings stay identical and lane 0's draw is a draw
    from each of them; the port's batched rings behave the same."""
    lpg_j, lpg_t = densities()
    c, n = 16, 10
    cfg_j = rtj.sampler.EHMC(max_steps=32)
    cfg_t = EHMC(max_steps=32)
    rng = np.random.default_rng(2)
    q = (0.5 * rng.normal(size=(c, n))).astype(np.float32)
    eps = jnp.float32(0.2)

    def step(key, q, rb):
        lp, g = lpg_j(q)
        res, rb, n_grads = samplers_j._ehmc_step(
            cfg_j, key, ChainState_j(q, -lp, g), eps, MassState_j(), rb,
            lpg_j, True)
        return res.state.q, rb, n_grads

    vstep = jax.jit(jax.vmap(step, axis_name="chains"))
    rb = jax.vmap(lambda _: samplers_j.ring_init(100, jnp.float32))(
        jnp.arange(c))
    key = jax.random.PRNGKey(0)
    qj = jnp.asarray(q)
    for _ in range(4):
        key, k = jax.random.split(key)
        qj, rb, _ = vstep(jax.random.split(k, c), qj, rb)
    buf = np.asarray(rb.buf)
    assert int(rb.count[0]) > 0
    assert (buf == buf[:1]).all() and (np.asarray(rb.count)
                                       == int(rb.count[0])).all()

    gen = torch.Generator().manual_seed(0)
    lp, g = lpg_t(torch.as_tensor(q))
    chain = ChainState(torch.as_tensor(q), -lp, g)
    rb_t = samplers_t.init_extra(cfg_t, c, torch.float32, "cpu")
    eps_t = torch.full((c,), 0.2)
    for _ in range(4):
        res, rb_t, _ = samplers_t.step(cfg_t, gen, chain, eps_t,
                                       identity_mass(), rb_t, lpg_t, True)
        chain = res.state
    assert int(rb_t.count[0]) > 0
    assert (rb_t.buf == rb_t.buf[:1]).all()
    assert (rb_t.count == rb_t.count[0]).all()


def test_empty_ring_replays_min_steps_where_jax_replays_one():
    """ROADMAP C5.3: the JAX package's ring_init fills with 1.0 whatever
    min_steps is, so a replay from an empty ring takes one step; the
    port's fills with min_steps, as the reference's comment intends."""
    lpg_j, lpg_t = densities()
    c, n = 8, 10
    q = (0.5 * np.random.default_rng(3).normal(size=(c, n))).astype(
        np.float32)
    cfg_t = EHMC(min_steps=4)
    rb_t = samplers_t.init_extra(cfg_t, c, torch.float32, "cpu")
    assert (rb_t.buf == 4.0).all() and (rb_t.count == 0).all()
    lp, g = lpg_t(torch.as_tensor(q))
    _, _, n_grads = samplers_t.step(
        cfg_t, torch.Generator().manual_seed(0),
        ChainState(torch.as_tensor(q), -lp, g), torch.full((c,), 0.1),
        identity_mass(), rb_t, lpg_t, False)
    assert (n_grads == 4).all()

    cfg_j = rtj.sampler.EHMC(min_steps=4)
    rb_j = samplers_j.init_extra(cfg_j, n, jnp.float32)
    assert (np.asarray(rb_j.buf) == 1.0).all()

    def step(key, q):
        lp, g = lpg_j(q)
        return samplers_j._ehmc_step(cfg_j, key, ChainState_j(q, -lp, g),
                                     jnp.float32(0.1), MassState_j(), rb_j,
                                     lpg_j, False)[2]

    n_grads_j = jax.vmap(step, axis_name="chains")(
        jax.random.split(jax.random.PRNGKey(0), c), jnp.asarray(q))
    assert (np.asarray(n_grads_j) == 1).all()
    # at min_steps=1, the parity tests' setting, the two fills agree
    assert (samplers_t.init_extra(EHMC(), c, torch.float32, "cpu").buf
            == 1.0).all()


def test_replay_outside_warmup_runs_its_steps():
    """Outside warmup (no counting lane) every lane runs its n_target
    steps, and at a small step the trajectory nearly conserves H."""
    _, lpg_t = densities()
    c, n = 32, 10
    rng = np.random.default_rng(4)
    q = torch.as_tensor((0.3 * rng.normal(size=(c, n))).astype(np.float32))
    lp, g = lpg_t(q)
    chain = ChainState(q, -lp, g)
    p0 = torch.as_tensor(rng.normal(size=(c, n)).astype(np.float32))
    eps = torch.full((c,), 0.05)
    cfg = EHMC()
    prop, p1, _, n_grads = samplers_t._ehmc_trajectory(
        chain, p0, eps, identity_mass(), lpg_t, None,
        torch.full((c,), 7, dtype=torch.int32), cfg)
    assert (n_grads == 7).all()
    h0 = chain.potential + kinetic(identity_mass(), p0)
    h1 = prop.potential + kinetic(identity_mass(), p1)
    # a short trajectory at a small step nearly conserves H
    assert torch.all(torch.abs(h1 - h0) < 0.05 * torch.clamp(h0.abs(),
                                                            min=1.0))


def test_synchronized_and_per_chain_agree_on_the_posterior():
    """tests/test_sampler.py:241-269 on the port: moments agree between
    synchronized and per-chain EHMC, r̂ < 1.05; synchronized, every chain
    integrates the same number of steps, per chain they differ."""
    rng = np.random.default_rng(3)
    data = rng.normal(1.5, 2.0, size=128)
    res = {}
    for sync in (True, False):
        mu = rtt.Normal(0, 10).latent()
        sigma = rtt.Exponential(0.5).latent()
        model = rtt.Model.observe(list(data), rtt.Normal(mu, sigma))
        cfg = SamplerConfig(300, 400,
                            sampler=EHMC(max_steps=64, synchronized=sync))
        COUNTS.reset()
        tr = model.sample(cfg, n_chains=8, seed=0)
        assert COUNTS.iterations == 700
        res[sync] = (tr.mean(mu), tr.mean(sigma),
                     np.asarray(tr.stats.grad_evals))
        assert max(d.r_hat for d in tr.diagnostics()) < 1.05
    assert abs(res[True][0] - res[False][0]) < 0.15
    assert abs(res[True][1] - res[False][1]) < 0.2
    sync_evals = res[True][2]
    assert np.all(sync_evals == sync_evals[0])
    assert len(set(res[False][2].tolist())) > 1
