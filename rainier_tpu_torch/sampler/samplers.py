"""Transition kernels for each sampler kind behind one interface used by
the driver (port of rainier_tpu/sampler/samplers.py):

    init_extra(cfg, n_chains, dtype, device)   -> extra state
    step(cfg, gen, chain, eps, mass, extra,
         lpg, warmup)                          -> (TransitionResult, extra,
                                                   n_grad_evals)

HMC: sampler/HMC.scala.  EHMC: sampler/EHMC.scala (U-turn step counting
into an empirical length distribution).  NUTS: see nuts.py.

Chains are the leading batch dimension.  Where the JAX package vmaps a
per-chain ``while_loop``, the loops here run while any chain still needs
a step, each chain's carry held by a mask once it is done; the cross-chain
exchanges of synchronized EHMC, an ``all_gather`` over the ``chains`` axis
there, are plain reads of the batch, and collectives over a mesh's
``chains`` axis where the batch is split over ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel import mesh as M
from . import config as C
from .leapfrog import (ChainState, TransitionResult, _select,
                       hmc_transition, is_uturn, kdk_step, log_accept_prob)
from .mass import kinetic, sample_momentum
from .nuts import nuts_step
from .stats import COUNTS


# ---------------------------------------------------------------------------
# ring buffer of empirical trajectory lengths (sampler/Stats.scala
# RingBuffer), one a chain
# ---------------------------------------------------------------------------


class RingBuffer(NamedTuple):
    buf: torch.Tensor    # (C, size) float
    idx: torch.Tensor    # (C,) int32 next write position
    count: torch.Tensor  # (C,) int32 filled slots (≤ size)


def ring_init(size: int, n_chains: int, dtype, device,
              fill: float = 1.0) -> RingBuffer:
    zi = torch.zeros(n_chains, dtype=torch.int32, device=device)
    return RingBuffer(buf=torch.full((n_chains, size), float(fill),
                                     dtype=dtype, device=device),
                      idx=zi, count=zi)


def ring_add(rb: RingBuffer, value) -> RingBuffer:
    """Append each chain's ``value`` (C,) to its ring."""
    size = rb.buf.shape[1]
    buf = rb.buf.scatter(1, rb.idx.long()[:, None],
                         value.to(rb.buf.dtype)[:, None])
    return RingBuffer(buf=buf, idx=(rb.idx + 1) % size,
                      count=torch.clamp(rb.count + 1, max=size))


def ring_sample(rb: RingBuffer, gen):
    """One uniform draw from each chain's filled slots (all of them while
    the ring is empty, where they hold the fill)."""
    n = torch.clamp(rb.count, min=1)
    u = torch.rand(n.shape, generator=gen, dtype=torch.float32,
                   device=n.device)
    i = torch.minimum((u * n).long(), n.long() - 1)
    return rb.buf.gather(1, i[:, None])[:, 0]


def ring_add_many(rb: RingBuffer, values, valid) -> RingBuffer:
    """Append ``values[i]`` (L,) where ``valid[i]`` to every chain's ring
    (a masked bulk ring_add: the counted lengths of a batch shared across
    chains).  Valid entries keep their order; when more than `size` arrive
    at once only the last `size` are kept, which is what a sequential
    ring_add leaves behind (rainier_tpu/sampler/samplers.py:62-75)."""
    n_chains, size = rb.buf.shape
    v = valid.to(torch.int32)
    offs = torch.cumsum(v, 0, dtype=torch.int32) - v
    n_new = v.sum(dtype=torch.int32)
    keep = valid & (offs >= n_new - size)
    pos = (rb.idx[:, None] + offs[None, :]) % size
    # dropped entries land in a spare column that is cut off
    pos = torch.where(keep[None, :], pos, size).long()
    ext = torch.cat([rb.buf, rb.buf.new_zeros(n_chains, 1)], dim=1)
    ext = ext.scatter(1, pos, values.to(rb.buf.dtype)[None, :]
                      .expand(n_chains, -1))
    return RingBuffer(buf=ext[:, :size], idx=(rb.idx + n_new) % size,
                      count=torch.clamp(rb.count + n_new, max=size))


# ---------------------------------------------------------------------------
# EHMC
# ---------------------------------------------------------------------------


def _ehmc_trajectory(chain: ChainState, p0, eps, mass, lpg, counting,
                     n_target, cfg: C.EHMC):
    """The JAX package's unified trajectory (samplers.py:84-155), batched.
    A counting lane runs until a U-turn or `max_steps` and proposes its
    state at `min_steps`, topping up to `min_steps` when the U-turn came
    first (EHMC.countSteps, EHMC.scala:32-50); a replay lane runs exactly
    its `n_target` steps.  `counting` is None outside warmup (no lane
    counts).  Returns (proposal, its momentum, the counted length (a
    replay lane's: its steps), the gradient evaluations).

    The reference's two loops are one here: a counting lane that stops
    counting below `min_steps` keeps stepping to `min_steps`, so its
    proposal is always its state at `min_steps` (the snapshot).  The loop
    runs while any lane runs; a finished lane's carry does not move.
    Every lane surely runs to the longest replay, so the device is asked
    whether to go on only past that."""
    q0 = chain.q
    n_chains = q0.shape[0]
    may_count = counting is not None
    if counting is None:
        counting = torch.zeros(n_chains, dtype=torch.bool, device=q0.device)
    # (q, p, logp, grad)
    state = (chain.q, p0, -chain.potential, chain.grad)
    snap = state
    zi = torch.zeros(n_chains, dtype=torch.int32, device=q0.device)
    l, l_counted, still = zi, zi, counting
    n_free = int(torch.where(counting, 0, n_target).max())
    COUNTS.syncs += 1
    steps = 0
    while True:
        q, p, _, grad = state
        more = still & (l < cfg.max_steps) & ~is_uturn(q0, q, p)
        l_counted = torch.where(still & ~more, l, l_counted)
        still = more
        run = torch.where(counting, more | (l < cfg.min_steps),
                          l < n_target)
        if steps >= n_free:
            if not may_count:
                break
            COUNTS.syncs += 1
            if not bool(run.any()):
                break
        state = _select(run, kdk_step(q, p, grad, eps, mass, lpg), state)
        l = l + run.to(torch.int32)
        snap = _select(run & (l == cfg.min_steps), state, snap)
        steps += 1
    COUNTS.steps += steps
    q, p, lp, grad = _select(counting, snap, state)
    prop = ChainState(q=q, potential=-lp, grad=grad)
    return prop, p, torch.where(counting, l_counted, l), l


def _ehmc_step(cfg: C.EHMC, gen, chain, eps, mass, rb: RingBuffer, lpg,
               warmup: bool, mesh=None):
    q = chain.q
    n_chains = q.shape[0]
    COUNTS.iterations += 1
    p0 = sample_momentum(mass, gen, q.shape, q.dtype, q.device)
    h0 = chain.potential + kinetic(mass, p0)
    counting = None
    if warmup:
        u = torch.rand(n_chains, generator=gen, dtype=q.dtype,
                       device=q.device)
        if cfg.synchronized:
            # pooled counting (rainier_tpu/sampler/samplers.py:164-197):
            # each counting lane's length lands in every lane's ring, so
            # the batch contributes p_count·buf_size lengths an iteration,
            # floored at the per-lane rate for small batches; an empty
            # ring replays its fill instead of forcing every lane to count
            n_all = n_chains * M.axis_size(mesh, M.CHAINS)
            pooled_p = min(cfg.p_count, cfg.p_count * cfg.buf_size / n_all)
            counting = u < pooled_p
        else:
            counting = (rb.count < rb.buf.shape[1]) | (u < cfg.p_count)
        COUNTS.counting = COUNTS.counting + counting.sum()
    n_target = torch.clamp(ring_sample(rb, gen), min=1).to(torch.int32)
    if cfg.synchronized:
        # one empirical draw, lane 0's, for the whole batch: the loop's
        # trip count is that draw and not the batch's maximum, and L stays
        # independent of every chain's state (samplers.py:200-213); on a
        # mesh, the first chain group's first chain's
        n_target = M.broadcast(n_target[:1], mesh, M.CHAINS).expand(
            n_chains)
    prop, p1, l_counted, n_grads = _ehmc_trajectory(
        chain, p0, eps, mass, lpg, counting, n_target, cfg)
    h1 = prop.potential + kinetic(mass, p1)
    la = log_accept_prob(h0, h1)
    u = torch.rand(n_chains, generator=gen, dtype=q.dtype, device=q.device)
    accept = torch.log(u) < la
    out = _select(accept, prop, chain)
    divergent = torch.isinf(la) | torch.isnan(la)
    energy = torch.where(accept, h1, h0)
    if warmup:
        if cfg.synchronized:
            # every counting lane's length lands in every lane's ring
            # (samplers.py:224-242), so the rings stay identical
            rb = ring_add_many(rb, M.all_gather(l_counted, mesh, M.CHAINS),
                               M.all_gather(counting, mesh, M.CHAINS))
        else:
            rb = _select(counting, ring_add(rb, l_counted), rb)
    return TransitionResult(out, la, accept, divergent, energy), rb, n_grads


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def init_extra(cfg, n_chains: int, dtype, device):
    if isinstance(cfg, (C.HMC, C.NUTS)):
        return ()
    if isinstance(cfg, C.EHMC):
        # an empty ring replays its fill: min_steps, as the reference's
        # comment intends (samplers.py:186-195), where the JAX package
        # fills with 1.0 whatever min_steps is (ROADMAP C5.3)
        return ring_init(cfg.buf_size, n_chains, dtype, device,
                         fill=max(cfg.min_steps, 1))
    raise TypeError(cfg)


def step(cfg, gen, chain, eps, mass, extra, lpg, warmup: bool, mesh=None):
    """One transition of every chain; `mesh` is read by synchronized EHMC,
    whose chains meet across the ranks of its ``chains`` axis."""
    if isinstance(cfg, C.HMC):
        res = hmc_transition(gen, chain, eps, cfg.n_steps, mass, lpg)
        return res, extra, cfg.n_steps
    if isinstance(cfg, C.EHMC):
        return _ehmc_step(cfg, gen, chain, eps, mass, extra, lpg, warmup,
                          mesh)
    if isinstance(cfg, C.NUTS):
        return nuts_step(cfg, gen, chain, eps, mass, extra, lpg)
    raise TypeError(cfg)
