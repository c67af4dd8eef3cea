"""Checkpoints of the port (``rainier_tpu_torch/parallel/checkpoint.py``)
held against the JAX package's (``rainier_tpu/parallel/checkpoint.py``).

* a round trip keeps the bits, each tensor leaf back on its device in
  its dtype, each array an array;
* a file the JAX package writes of tests/test_parallel.py:80-90's state
  ``{"chains", "mass", "step_size", "final"}`` (a ``MassState`` with no
  dense parts) loads into the port's equivalent tree, and a file the port
  writes loads in the JAX package: both order the leaves by sorted key and
  give ``None`` no leaf;
* ``resume_config`` on a port Trace equals the JAX package's given the
  same ``step_size`` and ``mass`` arrays, for a diagonal, a dense and an
  identity mass, and the resumed run (tests/test_parallel.py:93-101) has
  shape (2, 100, n_vars) and finite draws;
* ``rt.parallel.__all__`` is the reference's.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.sampler.mass import MassState as MassState_j
from rainier_tpu_torch.parallel import (load_checkpoint, resume_config,
                                        save_checkpoint)
from rainier_tpu_torch.sampler import HMC, SamplerConfig
from rainier_tpu_torch.sampler.mass import MassState

# the modules (each package's parallel/__init__ exports the functions)
ck_j = importlib.import_module("rainier_tpu.parallel.checkpoint")

torch.set_num_threads(2)
rtt.config.set_device("cpu")


def _state(rng):
    return {"chains": rng.normal(size=(2, 5, 4)).astype(np.float32),
            "mass": rng.uniform(0.5, 2.0, size=(2, 4)).astype(np.float32),
            "step_size": rng.uniform(0.1, 0.5, size=2).astype(np.float32),
            "final": np.zeros(3)}


def test_round_trip_keeps_the_bits(tmp_path):
    rng = np.random.default_rng(0)
    s = _state(rng)
    tree = {"step_size": torch.as_tensor(s["step_size"]),
            "mass": MassState(diag=torch.as_tensor(s["mass"]).double()),
            "chains": torch.as_tensor(s["chains"]),
            "final": s["final"], "nested": (np.arange(3), None, [2.5])}
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, tree)
    back = load_checkpoint(p, tree)
    assert list(back) == list(tree)
    assert isinstance(back["mass"], MassState) and back["mass"].cov is None
    for got, want in ((back["chains"], tree["chains"]),
                      (back["step_size"], tree["step_size"]),
                      (back["mass"].diag, tree["mass"].diag)):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.device == want.device
        assert torch.equal(got, want)
    assert isinstance(back["final"], np.ndarray)
    np.testing.assert_array_equal(back["final"], tree["final"])
    np.testing.assert_array_equal(back["nested"][0], np.arange(3))
    assert back["nested"][1] is None
    assert float(back["nested"][2][0]) == 2.5
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    with pytest.raises(ValueError, match="holds 6 leaves"):
        load_checkpoint(p, {"chains": tree["chains"]})


def test_checkpoints_cross_between_the_packages(tmp_path):
    s = _state(np.random.default_rng(1))
    jax_tree = {"chains": jnp.asarray(s["chains"]),
                "mass": MassState_j(diag=jnp.asarray(s["mass"])),
                "step_size": jnp.asarray(s["step_size"]),
                "final": s["final"]}
    port_tree = {"chains": torch.as_tensor(s["chains"]),
                 "mass": MassState(diag=torch.as_tensor(s["mass"])),
                 "step_size": torch.as_tensor(s["step_size"]),
                 "final": s["final"]}
    from_jax = str(tmp_path / "jax.npz")
    ck_j.save_checkpoint(from_jax, jax_tree)
    got = load_checkpoint(from_jax, port_tree)
    for k in ("chains", "step_size"):
        assert torch.equal(got[k], port_tree[k])
    assert torch.equal(got["mass"].diag, port_tree["mass"].diag)
    assert got["mass"].cov is None and got["mass"].chol is None
    np.testing.assert_array_equal(got["final"], s["final"])

    from_port = str(tmp_path / "port.npz")
    save_checkpoint(from_port, port_tree)
    back = ck_j.load_checkpoint(from_port, jax_tree)
    for k in ("chains", "step_size", "final"):
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(jax_tree[k]))
    np.testing.assert_array_equal(np.asarray(back["mass"].diag), s["mass"])
    assert back["mass"].cov is None


def _regression(rt):
    """tests/test_parallel.py:20-28."""
    rng = np.random.default_rng(0)
    xs = [tuple(r) for r in rng.normal(size=(64, 3))]
    ys = [float(np.dot(x, [1.0, -2.0, 0.5]) + 0.3 * rng.normal())
          for x in xs]
    sigma = rt.Exponential(1).latent()
    betas = rt.Normal(0, 1).latent_vec(3)
    return rt.Model.observe(ys, rt.Vec.from_(xs).map(
        lambda t: rt.Normal(rt.Vec.of(*t).dot(betas), sigma)))


MASSES = {"diagonal": rtt.sampler.config.DiagonalMassMatrixTuner(),
          "dense": rtt.sampler.config.DenseMassMatrixTuner(),
          "identity": rtt.sampler.config.IdentityMassMatrix()}


@pytest.mark.parametrize("kind", list(MASSES))
def test_resume_config_matches_jax_and_continues(kind):
    model = _regression(rtt)
    cfg = SamplerConfig(warmup_iterations=200, iterations=100,
                        sampler=HMC(5), mass_matrix=MASSES[kind])
    tr = model.sample(cfg, n_chains=2, seed=0)
    got = resume_config(tr, cfg)
    # the JAX function reads only these two attributes
    like = types.SimpleNamespace(
        step_size=np.asarray(tr.step_size),
        mass=MassState_j(*[None if x is None else np.asarray(x)
                           for x in tr.mass]))
    want = ck_j.resume_config(like, rtj.sampler.SamplerConfig(
        warmup_iterations=200, iterations=100, sampler=rtj.sampler.HMC(5)))
    assert got.warmup_iterations == want.warmup_iterations == 0
    assert got.step_size.step_size == pytest.approx(
        want.step_size.step_size, rel=1e-12)
    assert type(got.mass_matrix).__name__ == type(want.mass_matrix).__name__
    for f in dataclasses.fields(want.mass_matrix):
        a, b = (getattr(m, f.name) for m in (got.mass_matrix,
                                             want.mass_matrix))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12)
    tr2 = model.sample(got, n_chains=2, seed=1)
    assert tr2.chains.shape == (2, 100, model.n_vars)
    assert np.all(np.isfinite(tr2.chains))


def test_parallel_exports_the_references_names():
    import rainier_tpu.parallel as pj

    assert rtt.parallel.__all__ == pj.__all__
    for name in pj.__all__:
        assert hasattr(rtt.parallel, name)
