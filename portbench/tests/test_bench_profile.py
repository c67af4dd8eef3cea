"""The device's busy time, idle gaps and their names from a trace."""

import pytest

from portbench.profile import Activity


def test_busy_is_the_union_and_gaps_are_named_by_the_host_call():
    device = [("k1", 0.0, 1.0), ("k2", 0.5, 1.5), ("k3", 2.0, 2.5),
              ("k1", 2.5, 3.0), ("k4", 3.00001, 3.1)]
    host = [("cudaLaunchKernel", 0.0, 0.01),
            ("cudaStreamSynchronize", 1.6, 1.9)]
    act = Activity(device, host, window_s=4.0, n_fits=2)
    busy, gaps = act.busy()
    assert busy == pytest.approx(1.5 + 0.5 + 0.5 + 0.09999)
    assert gaps == [(1.5, pytest.approx(0.5)), (3.0, pytest.approx(1e-5))]
    names = dict(act.top_gaps())
    assert names["cudaStreamSynchronize"] == pytest.approx(0.5)
    assert names["(gaps under 20 us)"] == pytest.approx(1e-5)
    assert act.device_seconds(("k1",)) == pytest.approx(1.5)
    assert act.top_ops()[0] == ("k1", pytest.approx(1.5))
