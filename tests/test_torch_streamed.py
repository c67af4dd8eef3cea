"""Streamed column tiles in the port: the fused kernel's ``stream_columns``
branch, held against its synchronous tile loop and the JAX package.

A streamed launch keeps two tile slots in shared memory and issues tile
t + 1's copies before it computes tile t's rows
(``rainier_tpu/ops/hmc_pallas.py:186-191, 305-351``).  Checked here:

* ``csrc/fused_hmc.cu`` compiled for the host with g++, streamed against
  synchronous: the kernel's loop and the density alone, bit for bit
  (``torch.equal``), on the 1500-row logistic (five full 256-row tiles
  and a ragged one) at 37 chains (a ragged block) in both noise modes,
  and on a 330-row GLMMPoisson2, whose int32 index columns stream too;
* the JAX package's streamed branch (``stream_columns=True``, interpret
  mode, the same noise) against the port's plain version;
* ``stream_columns``: the automatic rule, True without columns, CPU
  tensors;
* the tile of every model of ``benchmarks/models.py``, built through the
  port, which leaves room for two slots.
"""

import types
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu.ops import fused_hmc as fused_hmc_jax
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from test_torch_columns import (_host_library, _host_logp_grad, _jax_noise,
                                _laplace_start, _run_host, logistic)
from test_torch_fused_hmc import funnel
from test_torch_gather import _warmed_up, small_glmm

torch.set_num_threads(2)
rtt.config.set_device("cpu")

ROOT = Path(__file__).resolve().parents[1]


def _kernel_inputs(model, cd, n, n_it, noise):
    """q0 (dim, n), the kernel's keywords with per-chain ε and Σ̂, and
    explicit noise or None: for the logistic, around the Newton mode; for
    the GLMM, from a short scan-path warmup."""
    rng = np.random.default_rng(2)
    dim = cd.n_vars
    if model == "logistic":
        q0, var = _laplace_start(n, 1)
        q0 = torch.as_tensor(q0)
        eps = torch.as_tensor(rng.uniform(0.3, 0.9, n), dtype=torch.float32)
        imd = torch.as_tensor(var * rng.uniform(0.5, 2.0, (n, dim)),
                              dtype=torch.float32)
    else:
        q0, eps, imd = _warmed_up(small_glmm(rtt), n)
    kw = dict(step_size=eps, n_steps=4, n_iterations=n_it, seed=9,
              collect_every=1, inv_mass_diag=imd)
    nz = (torch.as_tensor(rng.normal(size=(n_it, dim, n)),
                          dtype=torch.float32),
          torch.as_tensor(rng.uniform(1e-6, 1.0, (n_it, n)),
                          dtype=torch.float32)) \
        if noise == "explicit" else None
    return q0, kw, nz


@pytest.mark.parametrize("model,noise", [("logistic", "explicit"),
                                         ("logistic", "philox"),
                                         ("glmm", "explicit"),
                                         ("glmm", "philox")])
def test_host_streamed_kernel_is_bit_identical(model, noise, tmp_path):
    """The kernel's loop with its tiles streamed through two slots gives
    the synchronous loop's final q, draws, accept rates and divergences
    exactly: both read the same rows from a slot in the same order.
    37 chains in blocks of 4 leave a ragged block; both models end
    on a ragged tile, and the GLMM's index columns are int32."""
    cd = (logistic if model == "logistic" else small_glmm)(rtt).density()
    lib, em = _host_library(cd, tmp_path)
    assert em.n_rows % em.tile_rows != 0
    q0, kw, nz = _kernel_inputs(model, cd, 37, 15, noise)
    cols = cd.column_values(torch.float32, "cpu")
    sync = _run_host(lib, cd, q0, kw, nz, cols)
    streamed = _run_host(lib, cd, q0, kw, nz, cols, stream=True)
    for a, b in zip(streamed, sync):
        assert torch.equal(a, b)
    assert 0.0 < float(sync[2].mean())        # some proposals accepted


@pytest.mark.parametrize("model", ["logistic", "glmm"])
def test_host_streamed_density_is_bit_identical(model, tmp_path):
    """rt_logp_grad_host streamed and synchronous: the same lp and
    gradient bit for bit, and the plain version's within f32 rounding of
    sums in other orders (rtol 1e-5, gradients within 1e-5 of max |g|)."""
    cd = (logistic if model == "logistic" else small_glmm)(rtt).density()
    lib, em = _host_library(cd, tmp_path)
    q = _kernel_inputs(model, cd, 37, 1, "philox")[0]
    cols = cd.column_values(torch.float32, "cpu")
    lp, g = _host_logp_grad(lib, em, q, cols)
    lp_s, g_s = _host_logp_grad(lib, em, q, cols, stream=True)
    assert torch.equal(lp_s, lp) and torch.equal(g_s, g)
    lp_p, g_p = F.logp_grad_reference(cd, q)
    torch.testing.assert_close(lp_s, lp_p, rtol=1e-5,
                               atol=1e-5 * float(lp_p.abs().max()))
    torch.testing.assert_close(g_s, g_p, rtol=0,
                               atol=1e-5 * float(g_p.abs().max()))


def test_plain_version_matches_streamed_pallas_kernel():
    """fused_hmc_reference against the JAX package's streamed branch
    (stream_columns=True: columns in HBM, each 1024-row tile DMAed into
    one of two VMEM slots), interpreted with the same noise: ≥ 90% of
    chains end within 1e-3 and accept rates agree within 0.05, the JAX
    package's bar for tiled sums (test_pallas.py:148-151), since the two
    sum the 1500 row terms in other orders."""
    n, n_it, seed = 128, 40, 5
    cdj, cdt = logistic(rtj).density(), logistic(rtt).density()
    base_fn, tile_fn = cdj.logp_lanes_split_fn()
    q0, var = _laplace_start(n, 0)
    kw = dict(step_size=0.5, n_steps=5, n_iterations=n_it, seed=seed,
              inv_mass_diag=var, collect_every=1)
    qf_j, _, acc_j, div_j = fused_hmc_jax(
        lambda q, mask, *cols: tile_fn(q, mask, cols), jnp.asarray(q0),
        block_chains=n, interpret=True, host_rng=True,
        columns=cdj.column_values(jnp.float32), row_tile=1024,
        prior_fn=base_fn, stream_columns=True, **kw)
    qf, _, acc, div = F.fused_hmc_reference(
        cdt, torch.as_tensor(q0), noise=_jax_noise(seed, n_it, 4, n),
        **{**kw, "inv_mass_diag": torch.as_tensor(var)})
    per_chain = np.max(np.abs(qf.numpy() - np.asarray(qf_j)), axis=0)
    assert np.mean(per_chain < 1e-3) >= 0.90, per_chain
    assert np.max(np.abs(acc.numpy() - np.asarray(acc_j))) < 0.05
    assert float(np.sum(div.numpy())) == float(np.sum(np.asarray(div_j)))


# -- stream_columns -----------------------------------------------------------


@pytest.mark.parametrize("device,arg,want", [
    ("cuda", None, True),                 # a model with rows streams
    ("cuda", False, False),
    ("cuda", True, True),
    ("cpu", False, False),
    ("cpu", True, True)])
def test_stream_columns_rule(device, arg, want):
    """None streams on a CUDA device wherever the model has row tiles,
    whatever its columns' bytes (the 1500-row logistic's 24,000 lie far
    inside the card's L2); True and False force it.  The rule asks
    nothing of the device but its type, so it is checked here without
    one."""
    cd = logistic(rtt).density()
    cols = cd.column_values(torch.float32, "cpu")
    assert sum(c.numel() * 4 for c in cols) == 24000
    assert F.streams(cd, arg, device) is want


def test_nothing_streams_off_the_card():
    """Off a CUDA device the plain version runs, so the rule never
    streams; there is no L2 to read there either."""
    cd = logistic(rtt).density()
    assert F.l2_bytes("cpu") is None
    assert not F.streams(cd, None, "cpu")


def test_stream_columns_true_without_columns_raises():
    cd = funnel(rtt).density()
    q = torch.zeros(cd.n_vars, 4)
    with pytest.raises(ValueError, match="stream_columns=True needs data"):
        F.fused_hmc(cd, q, step_size=0.1, n_steps=1, n_iterations=1,
                    seed=0, stream_columns=True)
    with pytest.raises(ValueError, match="stream_columns=True needs data"):
        F.logp_grad(cd, q, stream_columns=True)
    with pytest.raises(ValueError, match="stream_columns=True needs data"):
        F._launch_setup(cd, (), 4, "cpu", True)
    # False and None are no request to stream
    for arg in (None, False):
        F.fused_hmc(cd, q, step_size=0.1, n_steps=1, n_iterations=1, seed=0,
                    stream_columns=arg)


@pytest.mark.parametrize("arg", [None, True, False])
def test_stream_columns_on_cpu_tensors_runs_the_plain_version(arg):
    """On CPU tensors the flag is checked and the plain version runs,
    with no launch counted."""
    cd = logistic(rtt).density()
    q0 = torch.as_tensor(_laplace_start(6, 2)[0])
    kw = dict(step_size=0.4, n_steps=3, n_iterations=4, seed=1,
              collect_every=2)
    before = (F.fused_hmc.launches, F.fused_hmc.streamed,
              F.logp_grad.launches, F.logp_grad.streamed)
    out = F.fused_hmc(cd, q0, stream_columns=arg, **kw)
    for a, b in zip(out, F.fused_hmc_reference(cd, q0, **kw)):
        assert torch.equal(a, b)
    lp, g = F.logp_grad(cd, q0, stream_columns=arg)
    lp_p, g_p = F.logp_grad_reference(cd, q0)
    assert torch.equal(lp, lp_p) and torch.equal(g, g_p)
    assert (F.fused_hmc.launches, F.fused_hmc.streamed, F.logp_grad.launches,
            F.logp_grad.streamed) == before


# -- the tile leaves room for two slots ---------------------------------------


def _port_models():
    """benchmarks/models.py, its models built through the port: the same
    source with the port's package in place of the JAX one."""
    src = (ROOT / "benchmarks" / "models.py").read_text()
    src = src.replace("import rainier_tpu as rt",
                      "import rainier_tpu_torch as rt")
    src = src.replace("from rainier_tpu.", "from rainier_tpu_torch.")
    mod = types.ModuleType("benchmarks_models_port")
    exec(compile(src, "benchmarks/models.py", "exec"), mod.__dict__)
    return mod


# (row width in floats, rows per tile): the power of two that holds the
# model's rows, at most 4096 and at least 32, halved until two fit
BENCHMARK_TILES = {"funnel": (0, 0), "readme_regression": (4, 256),
                   "eight_schools": (8, 32), "ark": (6, 1024),
                   "kid_iq": (3, 512), "low_dim_gauss_mix": (1, 1024),
                   "glmm_poisson": (4, 4096),
                   "logistic_regression": (11, 2048),
                   "glmm_large": (2, 4096)}


def test_every_benchmark_model_keeps_its_tile():
    """Every model of benchmarks/models.py takes the tile of the size
    rule (emit_cuda.tile_rows), and two of its tiles fit a block's shared
    memory."""
    models = _port_models()
    got = {}
    for name in BENCHMARK_TILES:
        em = emit_cuda.emit(getattr(models, name)().density())
        got[name] = (em.row_width, em.tile_rows)
        assert 2 * em.tile_rows * em.row_width * 4 <= \
            emit_cuda.SMEM_BYTES_MAX
    assert got == BENCHMARK_TILES
