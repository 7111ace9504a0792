"""BENCHMARK.json against the benchmark's contract: names, units, files,
every per-layer metric's moved metric reported by the cells that report
it, and the time a full check of 24 cells at run_seconds takes."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.tests.tiny import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert {"setup_s"} <= {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_files_exist(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in manifest["workloads"]:
        for folder, name in (("traffic", w["traffic"]), ("cells", w["name"]),
                             ("configs", w["config"])):
            assert os.path.exists(os.path.join(BENCH, folder,
                                               f"{name}.json"))
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))


def test_moves_reported_by_the_same_cells(manifest):
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                              manifest["workloads"]]))
           for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        got = [n for n, cells in e2e.items() if w["name"] in cells]
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m["workloads"] for m in manifest["per_layer"])
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]]
        layers.setdefault(m["layer"], m["layer"])


def test_full_check_fits(manifest):
    rs = manifest["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
