"""The readings that the limits of `correct` are set from, at a cell's own
size: the numbers compared of one fit a seed, and beside them the
control's (the reference with its density in bfloat16 in the program's
place), for each seed, in one process.

    python3 portbench/readings.py WORKLOAD [--fault NAME] SEED [SEED ...]

Prints one JSON line a seed: {"seed", "fit_s", "program": {...},
"control": {...}}, and "fault" where --fault planted one of
portbench/faults.py in the program.  Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, Cell, Probes, _cache_dirs  # noqa: E402


def readings(workload: str, seeds, device="cuda", sizes=None, traffic=None,
             out=sys.stdout, fault=None):
    """One fit a seed on one model, with the fault named `fault` planted
    where one is; yields each seed's readings."""
    from portbench.faults import FAULTS

    cell = None
    for seed in seeds:
        if cell is None:
            cell = Cell(workload, seed, device, sizes=sizes, traffic=traffic)
        else:
            cell.reseed(seed)
        planted = FAULTS[fault]() if fault else contextlib.nullcontext()
        with planted, Probes(cell.density) as probes:
            wall, tr = cell.fit(probes, cell.traffic["warmup"],
                                cell.traffic["draws"])
            cell.record(probes, tr, tr.chains)
        del tr
        r = cell.readings(control=True)
        line = {"seed": seed, "fit_s": wall, **r}
        if fault:
            line["fault"] = fault
        print(json.dumps(line), file=out, flush=True)
        yield line


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--fault", default=None)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    _cache_dirs(ROOT)
    t0 = time.perf_counter()
    for _ in readings(args.workload, args.seeds, fault=args.fault):
        pass
    print(f"readings {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
