"""Each configuration's work count follows its shapes."""

import json

from portbench import work
from portbench.manifest import module
from portbench.run import BASE


def _ref(name):
    with open(BASE / "configs" / f"{name}.json") as f:
        sizes = json.load(f)
    return module(BASE / "configs" / f"{name}_ref.py"), sizes


def test_logistic_counts_a_row_per_feature_and_reads_each_input_once():
    ref, sizes = _ref("logistic100k")
    w = ref.work(sizes)
    p, n = sizes["features"], sizes["rows"]
    assert w["dim"] == p + 1
    assert w["ops_grad"] == n * w["ops_row"] + 4 * (p + 1)
    wider = ref.work(dict(sizes, features=p + 1))
    assert wider["ops_row"] - w["ops_row"] == 4     # two FMAs a feature
    assert w["bytes_columns"] == 4 * n * (p + 1)
    assert w["ops_launch"] == 0
    priced = work.ops("exp") + work.ops("log1p") + work.ops("recip")
    assert w["ops_row"] == 4 * p + priced + 13
    assert w["sfu_row"] == 3                         # exp, log1p, 1/x
    assert w["sfu_grad"] == n * 3 and w["sfu_launch"] == 0


def test_glmm_counts_groups_and_rows_and_its_data_only_terms_once():
    ref, sizes = _ref("glmm_large")
    w = ref.work(sizes)
    g, k = sizes["groups"], sizes["rows_per_group"]
    assert w["dim"] == g + 2
    assert w["ops_grad"] == g * w["ops_group"] + g * k * w["ops_row"] + 10
    assert w["ops_launch"] == g * k * (work.ops("lgamma") + 1)
    assert w["sfu_grad"] == g                        # exp(eᵢ) a group
    assert w["sfu_launch"] == 0
    assert w["bytes_columns"] == 8 * g * k


def test_fit_and_kernel_counts_agree():
    ref, sizes = _ref("logistic100k")
    w = ref.work(sizes)
    it, it_sfu = work.iteration_work(w, 5)
    assert it > 5 * w["ops_grad"] and it_sfu > 5 * w["sfu_grad"]
    ops, nsfu, nbytes = work.kernel_work(w, 1024, 200, 5, w["dim"])
    assert ops == 1024 * 200 * it and nsfu == 1024 * 200 * it_sfu
    assert work.fit_ops(w, 1024, 250, 200, 5) == 1024 * 450 * it
    assert nbytes == (w["bytes_columns"] + 1024 * 4 * (3 * w["dim"] + 1)
                      + 1024 * 4 * (200 * w["dim"] + 2))


def test_least_time_takes_the_slowest_of_three_pipes():
    peaks = {"flops": 100.0, "sfu": 10.0, "bytes": 1000.0}
    assert work.least_time(100, 5, 10, peaks) == (1.0, "fp32")
    assert work.least_time(100, 20, 10, peaks) == (2.0, "sfu")
    assert work.least_time(100, 5, 3000, peaks) == (3.0, "bytes")


def test_peaks_match_the_cards_exact_name():
    from portbench.peaks import peaks

    sxm = peaks("NVIDIA H100 80GB HBM3")
    assert sxm["flops"] == 67e12 and sxm["bytes"] == 3.35e12
    assert abs(sxm["sfu"] / sxm["flops"] - 16 / 256) < 1e-3
    assert peaks("NVIDIA H100 PCIe") is None
    assert peaks("NVIDIA H100 NVL") is None
