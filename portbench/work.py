"""The work a fit needs, counted from a configuration's shapes.

Two kinds of operations, which the H100 issues on separate pipes that run
side by side:

* float32 operations, as the card's float32 peak counts them (67 TFLOP/s
  outside the tensor cores): an add, a multiply or a compare is 1, a fused
  multiply-add 2;
* special-function results (an approximate exponential, logarithm,
  reciprocal, square root or cosine), which the special-function unit
  computes at 16 a clock an SM, against 128 float32 lanes.

A special function is priced as one special-function result plus the
float32 instructions of its usual sequence around it.  Integer work
(Philox's rounds, index arithmetic, the gathers' addresses) is not
counted.  Bytes are each input read once and each output written once a
launch, whatever the kernel reads again.

A count is a pair (float32 operations, special-function results).
"""

from __future__ import annotations

#: (float32 operations, special-function results) of each priced function
PRICE = {
    "exp": (4, 1),          # ex2.approx after a range reduction (2 FMA)
    "log": (4, 1),          # lg2.approx and a scale
    "log1p": (14, 1),       # lg2.approx and a polynomial correction
    "recip": (4, 1),        # rcp.approx and one Newton step (2 FMA)
    "sqrt": (2, 1),
    "cos": (4, 1),
    # lgammaf: ~150-190 SASS instructions, no special-function unit
    "lgamma": (170, 0),
}


def ops(name: str) -> int:
    """Float32 operations of the function `name`."""
    return PRICE[name][0]


def sfu(name: str) -> int:
    """Special-function results of the function `name`."""
    return PRICE[name][1]


#: one standard normal by Box-Muller: half of a log, a sqrt, a cos and
#: four arithmetic operations for each pair
NORMAL = ((ops("log") + ops("sqrt") + ops("cos") + 4) / 2,
          (sfu("log") + sfu("sqrt") + sfu("cos")) / 2)

#: per coordinate and leapfrog step: the kick's and the drift's FMA and the
#: gradient's scale by the mass
LEAPFROG_COORD = (2 + 2 + 1, 0)

#: per coordinate and iteration: the momentum's normal, its half square in
#: the kinetic energy at both ends, the Metropolis select
ITER_COORD = (NORMAL[0] + 2 * 2 + 1, NORMAL[1])

#: per iteration: the energies' difference, its exponential, the compare
ITER_CHAIN = (4 + ops("exp") + 1, sfu("exp"))


def iteration_work(w: dict, n_steps: int):
    """(float32 operations, special-function results) of one HMC
    iteration of one chain with `n_steps` leapfrog steps: a gradient
    evaluation a step, the leapfrog's updates, the momentum and the
    Metropolis test."""
    dim = w["dim"]
    grad = (w["ops_grad"], w["sfu_grad"])
    return tuple(n_steps * (grad[k] + LEAPFROG_COORD[k] * dim)
                 + ITER_COORD[k] * dim + ITER_CHAIN[k] for k in (0, 1))


def kernel_work(w: dict, chains: int, draws: int, n_steps: int,
                n_collect: int):
    """(float32 operations, special-function results, bytes) of the
    sampling phase: `draws` iterations of every chain, with the data-only
    work once a launch, the columns, the start state, the step sizes and
    the mass read once, the draws and the final state written once."""
    it = iteration_work(w, n_steps)
    nops = chains * draws * it[0] + w["ops_launch"]
    nsfu = chains * draws * it[1] + w["sfu_launch"]
    nbytes = (w["bytes_columns"]
              + chains * 4 * (3 * w["dim"] + 1)
              + chains * 4 * (draws * n_collect + 2))
    return nops, nsfu, nbytes


def least_time(nops: float, nsfu: float, nbytes: float, peaks: dict):
    """(seconds, what binds): the least time of that work on the card, the
    largest of its float32 operations over the float32 peak, its
    special-function results over their rate and its bytes over the
    memory's bandwidth, since the three run side by side."""
    times = {"fp32": nops / peaks["flops"], "sfu": nsfu / peaks["sfu"],
             "bytes": nbytes / peaks["bytes"]}
    binds = max(times, key=times.get)
    return times[binds], binds


def fit_ops(w: dict, chains: int, warmup: int, draws: int,
            n_steps: int) -> float:
    """Float32 operations of a whole fit: warmup's iterations and the
    sampling phase's, each an HMC iteration of every chain."""
    return (chains * (warmup + draws) * iteration_work(w, n_steps)[0]
            + w["ops_launch"])
