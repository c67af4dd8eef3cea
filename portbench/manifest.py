"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, a traffic mix
and, through the metrics that list it, the readers of its numbers:

* ``configs/<name>.json`` (the file BENCHMARK.json gives): the sizes as
  run; beside it ``<name>.py``, the model built with the program's DSL,
  and ``<name>_ref.py``, the plain reference, the data and the work count;
* ``traffic/<name>.json``: the mix's parameters, overlaid by
  ``traffic/<name>/<config>.json`` where a configuration needs its own;
* ``metrics/<name>.py``: a reader ``read(run)`` returning a number or None.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def module(path: Path):
    """The Python file at `path`, imported once a process."""
    name = "portbench_" + "_".join(Path(path).with_suffix("").parts[-2:])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


class Config:
    """A configuration: its sizes, its model builder and its reference."""

    def __init__(self, root: Path, entry: dict):
        path = Path(root) / entry["file"]
        with open(path) as f:
            self.sizes = json.load(f)
        self.name = entry["name"]
        self.path = path
        self.model = module(path.with_suffix(".py"))
        self.ref = module(path.with_name(path.stem + "_ref.py"))


def config(root: Path, bench: dict, name: str) -> Config:
    for c in bench["configs"]:
        if c["name"] == name:
            return Config(root, c)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, config_name: str, base: Path = HERE) -> dict:
    with open(base / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    own = base / "traffic" / name / f"{config_name}.json"
    if own.exists():
        with open(own) as f:
            mix.update(json.load(f))
    return mix


def metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: the end-to-end ones
    untraced, the per-layer ones traced; those with a ``workloads`` key
    only in the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str, base: Path = HERE):
    return module(base / "metrics" / f"{name}.py")
