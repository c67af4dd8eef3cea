"""The frozen bulk ESS against a series whose ESS is known."""

import numpy as np

from portbench.ess import bulk_ess


def ar1(rng, phi, chains, draws, k):
    x = np.empty((chains, draws, k))
    x[:, 0] = rng.normal(size=(chains, k)) / np.sqrt(1 - phi ** 2)
    for t in range(1, draws):
        x[:, t] = phi * x[:, t - 1] + rng.normal(size=(chains, k))
    return x


def test_ar1_matches_its_integrated_autocorrelation():
    rng = np.random.default_rng(11)
    chains, draws = 8, 4000
    for phi in (0.0, 0.5, 0.8):
        ess = bulk_ess(ar1(rng, phi, chains, draws, 3))
        want = chains * draws * (1 - phi) / (1 + phi)
        assert np.all(np.abs(ess / want - 1) < 0.1), (phi, ess, want)


def test_a_stuck_chain_lowers_it():
    rng = np.random.default_rng(12)
    x = ar1(rng, 0.0, 8, 1000, 1)
    x[0] = 5.0
    assert bulk_ess(x)[0] < 0.2 * 8000
