"""The control of `correct`: the plain reference with its density in
bfloat16, put in the program's place, fails at least one of the numbers
compared against the cell's limits, while the program passes them all.
On the CPU at a small size; on the card (marked ``chip``) at each cell's
own size on three seeds."""

import io
import json

import pytest

from portbench import manifest, readings
from portbench.run import ROOT

SMALL = {"logistic100k.short": {"rows": 3000},
         "glmm_large.long": {"groups": 300}}
SEEDS = (2 ** 31 + 11, 2 ** 32 + 12, 2 ** 33 + 13)


def _limits(workload):
    bench = manifest.load(ROOT)
    cell = manifest.workload(bench, workload)
    return manifest.config(ROOT, bench, cell["config"]).sizes["limits"]


def _fails(numbers, limits):
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


def _assert_separated(lines, limits):
    for line in lines:
        assert not _fails(line["program"], limits), line
        assert _fails(line["control"], limits), line


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_on_the_cpu(workload):
    import rainier_tpu_torch as rt

    rt.config.set_device("cpu")
    lines = list(readings.readings(
        workload, SEEDS[:2], "cpu", sizes=SMALL[workload],
        traffic={"chains": 64, "warmup": 150, "draws": 30}, out=io.StringIO()))
    _assert_separated(lines, _limits(workload))


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load(
    ROOT)["workloads"]])
def test_control_fails_on_the_card_at_the_cells_size(card, workload):
    out = io.StringIO()
    lines = list(readings.readings(workload, SEEDS, card, out=out))
    print(out.getvalue())
    _assert_separated([json.loads(s) for s in out.getvalue().splitlines()],
                      _limits(workload))
    assert len(lines) == len(SEEDS)
