"""Scalar terms of one shape as a loop over a chain's lanes.

The latent GP's likelihood is one scalar term a input, Normal(f_i, σ) at
y_i, f = L·z held in the density's scratch.  Over a slot the CUDA emitter
writes the terms of one NArySum that have one shape and read distinct
entries of one held vector as a loop that the chain's lanes split, their
literals that differ (the y_i) a table bound after the columns, where
every lane ran every term as straight-line code (``emit_cuda.
_term_groups``, ``GROUP_MIN`` terms at least).  Each term keeps its
arithmetic, so each gradient entry keeps its bits; only lp's sum is in
another order (each lane's f64 sum, then the butterfly).  Checked, for
the GP at 40 and 64 inputs (L staged in shared memory) and at 256 (L read
in tiles):

* the header holds one loop over the terms in each pass, and no term's
  own line;
* the host build's gradient has the bits of the ungrouped emission's
  (``GROUP_MIN`` raised for it, as ``tools/kernel_ab.py``'s ``_emit_as``
  replaces the emitter's constants), its lp within the density bars;
* lp and g against the JAX package's density and ``jax.grad``, with the
  bars of ``tests/test_torch_forms_tiles.py``;
* the host kernel against its plain version;
* a model with fewer than ``GROUP_MIN`` such terms emits the text it did
  without groups, and one with ``GROUP_MIN`` groups them.
"""

import re

import numpy as np
import pytest

import torch

import rainier_tpu as rtj
import rainier_tpu_torch as rtt
from rainier_tpu_torch.compute import emit_cuda
from rainier_tpu_torch.ops import fused_hmc as F
from rainier_tpu_torch.tools.kernel_ab import _emit_as
from test_torch_columns import _host_library, _host_logp_grad, _run_host
from test_torch_forms import gp_data, latent_gp
from test_torch_untiled import _density_bars, _inputs, _jax_lp_grad, _points

torch.set_num_threads(2)
rtt.config.set_device("cpu")

SIZES = (40, 64, 256)
# the emitter's constants that emit the terms one by one
UNGROUPED = {"GROUP_MIN": 1 << 30}


def _gp(n, grouped=True):
    """(model, density, emitted) of the port's GP at n inputs, emitted
    with its terms grouped or one by one."""
    model = latent_gp(rtt, n)
    cd = model.density()
    if not grouped:
        _emit_as(cd, UNGROUPED)
    return model, cd, emit_cuda.emit(cd)


_HOST = {}


def _host(n, grouped, tmp_path_factory):
    """The g++ host build of the GP at n inputs, once per form."""
    if (n, grouped) not in _HOST:
        model, cd, _ = _gp(n, grouped)
        lib, em = _host_library(cd, tmp_path_factory.mktemp("terms"))
        _HOST[n, grouped] = (model, cd, lib, em)
    return _HOST[n, grouped]


@pytest.mark.parametrize("n", SIZES)
def test_terms_are_one_lane_loop(n):
    """Both passes hold one loop over the n terms, split over the lanes,
    reading y from the table (cols.l0) and f at its entry; no line reads
    an entry of f at a literal index; the table is y in f32 and the
    wrapper binds it after the columns."""
    _, cd, em = _gp(n)
    src = em.source
    head = src.index("RT_HD float rt_logp_grad(")
    body = src[head:src.index("\n}\n", head)]
    assert body.count(f"// the scalar terms of ") == 2
    assert body.count(f"{n} of one shape, a loop over the lanes") == 2
    assert body.count(f"for (int i = RT_LANE; i < {n}; i += RT_LSTEP)") \
        >= 2
    assert body.count("cols.l0[0 + i]") == 2
    assert not re.findall(r"scr\[\d+ \+ \d+\]", body)
    # a term's division in the forward loop, and in the reverse loop the
    # forward's again and its adjoint's: no term's own line
    assert body.count("/ 0.30000001192092896f") == 3
    (table,) = em.tables
    _, _, y = gp_data(n, 0, 0.3)
    assert np.array_equal(np.float32(table), y.astype(np.float32))
    _, held = F.column_pointers(em, cd.column_values(torch.float32, "cpu"))
    assert len(held) == len(cd.columns) + 1
    assert torch.equal(held[-1], torch.as_tensor(y, dtype=torch.float32))
    assert "const float* l0;" in src and "RT_WHOLE_COLS" in src


@pytest.mark.parametrize("n", SIZES)
def test_grouped_gradient_keeps_the_ungrouped_bits(n, tmp_path_factory):
    """At the same q the host builds of the grouped and the ungrouped
    emission give the same gradient bit for bit; lp, summed in another
    order, within the density bars."""
    q = torch.as_tensor(_points(n, 4, 5), dtype=torch.float32)
    out = []
    for grouped in (True, False):
        _, cd, lib, em = _host(n, grouped, tmp_path_factory)
        assert bool(em.tables) == grouped
        out.append(_host_logp_grad(lib, em, q, cd.column_values(
            torch.float32, "cpu")))
    (lp, g), (lp_u, g_u) = out
    assert torch.isfinite(g).all() and torch.equal(g, g_u)
    _density_bars(lp.numpy(), g.numpy(), lp_u.numpy(), g_u.numpy())


@pytest.mark.parametrize("n", SIZES)
def test_grouped_density_matches_jax(n, tmp_path_factory):
    """The grouped emission's host build and the plain version against
    JAX's logp_lanes_fn and jax.grad at the same q, with the density
    bars."""
    _, cd, lib, em = _host(n, True, tmp_path_factory)
    cdj = latent_gp(rtj, n).density()
    q = _points(n, 3, 6).astype(np.float32)
    lp_ref, g_ref = _jax_lp_grad(cdj, q)
    qt = torch.as_tensor(q)
    lp, g = _host_logp_grad(lib, em, qt, cd.column_values(torch.float32,
                                                          "cpu"))
    _density_bars(lp.numpy(), g.numpy(), lp_ref, g_ref)
    lp_p, g_p = F.logp_grad_reference(cd, qt)
    _density_bars(lp_p.numpy(), g_p.numpy(), lp_ref, g_ref)


@pytest.mark.parametrize("n", SIZES[:2])
def test_grouped_host_kernel_matches_plain_version(n, tmp_path_factory):
    """The kernel's loop with the grouped terms (g++ host build, 37
    chains: a ragged last block) against the plain version with explicit
    noise: ≥ 90% of chains within 1e-3 and accept rates within 0.05 on
    average, test_torch_forms.py's bar."""
    model, cd, lib, _ = _host(n, True, tmp_path_factory)
    q0, kw, nz = _inputs(cd, model, 37, 25, "explicit")
    cols = cd.column_values(torch.float32, "cpu")
    got = _run_host(lib, cd, q0, kw, nz, cols)
    ref = F.fused_hmc_reference(cd, q0, noise=nz, **kw)
    rel = ((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).amax(0)
    assert float((rel <= 1e-3).float().mean()) >= 0.9, rel
    assert float((got[2] - ref[2]).abs().mean()) < 0.05


def _partial_gp(rt, k, n=40):
    """The GP at n inputs with only its first k inputs observed: k terms
    over a slot."""
    _, K, y = gp_data(n, 0, 0.3)
    f = rt.MVNormal([0.0] * n, K).latent_vec()
    return rt.Model.observe(list(y[:k]), f.take(k).map(
        lambda fi: rt.Normal(fi, 0.3)))


@pytest.mark.parametrize("k", [emit_cuda.GROUP_MIN - 1, emit_cuda.GROUP_MIN])
def test_fewer_terms_keep_their_text(k):
    """k terms of one shape over a slot: below GROUP_MIN the header is the
    one emitted without groups, byte for byte, and binds no table; at
    GROUP_MIN they are one loop."""
    cd = _partial_gp(rtt, k).density()
    em = emit_cuda.emit(cd)
    assert em.workspace
    del emit_cuda._EMITTED[cd]
    _emit_as(cd, UNGROUPED)
    plain = emit_cuda.emit(cd)
    assert plain.tables == ()
    if k < emit_cuda.GROUP_MIN:
        assert em.source == plain.source and em.tables == ()
    else:
        assert em.source != plain.source and len(em.tables[0]) == k
        assert f"{k} of one shape, a loop over the lanes" in em.source
