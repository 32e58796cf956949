"""BENCHMARK.json keeps to the benchmark's contract, and every piece a
cell names is found by that name."""

import json
import math
import os
import re

import pytest

from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = core.Bench()
SPEC = BENCH.spec
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    path = os.path.join(BENCH.root, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(BENCH.root, p))
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1].startswith(SPEC["paths"][0] + "/")


def test_run_seconds_fit_a_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    seen = set()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[key]:
            assert NAME.match(item["name"]), item["name"]
            assert (key, item["name"]) not in seen
            seen.add((key, item["name"]))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert os.path.isfile(os.path.join(BENCH.root, c["file"]))
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in {x["name"] for x in BENCH.end_to_end(cell)}
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for cell in CELLS:
        names = {m["name"] for m in BENCH.end_to_end(cell)}
        assert "setup_s" in names and len(names) >= 2
        assert BENCH.per_layer(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_piece_found_by_name(cell):
    w = BENCH.workload(cell)
    cfg = BENCH.config(w["config"])
    assert cfg["name"] == w["config"] and cfg["chips"] == w["chips"]
    tr = BENCH.traffic(w["traffic"])
    assert callable(BENCH.entry(tr["entry"]).run)
    assert BENCH.limits(cell)["checks"]
    for m in BENCH.per_layer(cell):
        assert callable(BENCH.reader(m["name"]).read)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_files_state_their_deployment(name):
    cfg = BENCH.config(name)
    for key in ("source", "matrix", "rows", "cols", "nnz", "dtype", "k",
                "alpha", "beta", "chips", "assumed"):
        assert key in cfg, key
    assert cfg["reduced"] == []
    assert not cfg["tf32"]


def test_limits_are_finite_and_positive():
    for cell in CELLS:
        for name, lim in BENCH.limits(cell)["checks"].items():
            assert NAME.match(name) and math.isfinite(lim) and lim > 0


def test_every_file_is_json_or_python():
    for dirpath, _, names in os.walk(BENCH.dir):
        if "__pycache__" in dirpath:
            continue
        for n in names:
            path = os.path.join(dirpath, n)
            if n.endswith(".json"):
                with open(path) as fh:
                    json.load(fh)
            else:
                assert n.endswith((".py", ".md")), path
