"""BENCHMARK.json loads, meets the contract's shape, and every cell finds
its configuration, traffic mix and metric readers by name."""

import json
import re
import textwrap

from portbench import manifest
from portbench.run import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_cell_resolves():
    bench = manifest.load(ROOT)
    for w in bench["workloads"]:
        cfg = manifest.config(ROOT, bench, w["config"])
        assert callable(cfg.model.build) and callable(cfg.ref.lp_grad)
        mix = manifest.traffic(w["traffic"], w["config"])
        assert {"chains", "hmc_steps", "thin", "warmup", "draws"} <= set(mix)
        for trace in (False, True):
            for m in manifest.metrics(bench, w["name"], trace):
                assert callable(manifest.reader(m["name"]).read)


def test_contract_shape():
    bench = manifest.load(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
        ends = {m["name"] for m in manifest.metrics(bench, w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert manifest.metrics(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_found_by_name_in_another_directory(tmp_path):
    base = tmp_path / "portbench"
    (base / "configs").mkdir(parents=True)
    (base / "traffic" / "burst").mkdir(parents=True)
    (base / "configs" / "toy.json").write_text(json.dumps({"rows": 3}))
    (base / "configs" / "toy.py").write_text(textwrap.dedent("""
        def build(rt, data, sizes):
            return "model", None
        """))
    (base / "configs" / "toy_ref.py").write_text(textwrap.dedent("""
        def lp_grad(q, data, sizes, low=None):
            return q.sum(1), q
        """))
    (base / "traffic" / "burst.json").write_text(
        json.dumps({"chains": 8, "warmup": 5, "draws": 5}))
    (base / "traffic" / "burst" / "toy.json").write_text(
        json.dumps({"draws": 7}))
    bench = {"configs": [{"name": "toy", "file": "portbench/configs/toy.json"}]}
    cfg = manifest.config(tmp_path, bench, "toy")
    assert cfg.sizes == {"rows": 3}
    assert cfg.model.build(None, None, None)[0] == "model"
    mix = manifest.traffic("burst", "toy", base)
    assert mix == {"chains": 8, "warmup": 5, "draws": 7}
    assert manifest.traffic("burst", "other", base)["draws"] == 5
