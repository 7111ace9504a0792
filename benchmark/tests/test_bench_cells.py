"""The harness on the CPU at tiny sizes: cells found by their files
alone, the program held correct, every fault the cells can have and the
control held not correct, the run refused without a card or without the
program, and no module of JAX or the JAX package loaded. The test marked
`cuda` runs a real cell on the card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.tests.tiny import BENCH, REPO, make_root, measure


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("kind", ["train", "eval", "serve"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_is_correct(root, kind, traced):
    res, checks, _ = measure(root, f"tiny.{kind}", traced=traced)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if not traced:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


def test_cell_added_as_files_alone(root, tmp_path):
    """A new traffic mix, cell and per-layer metric, added as files and
    manifest entries, are found and reported."""
    new = str(tmp_path)
    shutil.copytree(root, new, dirs_exist_ok=True)
    b = os.path.join(new, "benchmark")
    with open(os.path.join(b, "traffic", "train_tiny.json")) as f:
        traffic = json.load(f)
    traffic["prefetch"] = 4
    with open(os.path.join(b, "traffic", "train_deep.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(b, "cells", "tiny.train.json"),
                os.path.join(b, "cells", "tiny.train-deep.json"))
    with open(os.path.join(b, "metrics", "next_calls.train.py"), "w") as f:
        f.write("def read(st):\n    return len(st.spans.get('next', []))"
                " or None\n")
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"].append({"name": "tiny.train-deep", "config": "tiny",
                                  "traffic": "train_deep", "chips": 1,
                                  "why": "a deeper prefetch"})
    for m in manifest["end_to_end"]:
        if "tiny.train" in m.get("workloads", []):
            m["workloads"].append("tiny.train-deep")
    manifest["per_layer"].append({
        "name": "next_calls.train", "unit": "calls", "better": "lower",
        "source": "host_clock", "layer": "host feed",
        "moves": "train_pairs_per_s", "workloads": ["tiny.train-deep"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    res, _, _ = measure(new, "tiny.train-deep", traced=True)
    assert res["correct"]
    assert res["metrics"]["next_calls.train"]["value"] > 0


FAULTS = [(k, f) for k, fs in faults.FAULTS.items() for f in fs]


@pytest.mark.parametrize("kind,fault", FAULTS,
                         ids=[f"{k}-{f}" for k, f in FAULTS])
def test_fault_is_not_correct(root, kind, fault):
    with faults.planted(kind, fault):
        res, checks, _ = measure(root, f"tiny.{kind}")
    assert not res["correct"], checks


@pytest.mark.parametrize("kind", ["train", "eval", "serve"])
def test_control_is_not_correct(root, kind):
    """The towers in fp8 in the program's place fail a number on every
    seed."""
    from benchmark import control

    for seed in (1, 2, 3):
        got = control.control(root, f"tiny.{kind}", seed,
                              torch.device("cpu"))
        assert any(v > lim for v, lim in got.values()), got


def test_no_card_no_result(tmp_path):
    """Without a card (this machine) run.py exits non-zero and prints no
    result; without the program (only BENCHMARK.json and benchmark/) the
    run cannot start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "full.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    code = ("import sys, torch; sys.path[:0] = [sys.argv[1]]; "
            "from benchmark.tests.tiny import measure; "
            "measure(sys.argv[1], 'full.train')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "dssm_tpu_torch" in out.stderr


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.text, benchmark.reference.mlp, "
            "benchmark.reference.check, benchmark.reference.retrieval, "
            "benchmark.work.counts, benchmark.gen, benchmark.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'dssm_tpu', 'dssm_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax(root):
    code = ("import sys; sys.path.insert(0, sys.argv[2]); "
            "from benchmark.tests.tiny import measure; "
            "from benchmark import core; measure(sys.argv[1], 'tiny.eval'); "
            "print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, root, REPO],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("[]"), \
        out.stderr[-2000:]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_train_control_is_not_correct(card):
    """The training cells' control, the program's own bf16 table for the
    f32 one, fails a number at the cells' own sizes (at the tiny widths a
    bf16 table's rounding hides in the larger gradients)."""
    from benchmark import control

    for workload in ("full.train", "multihost.train"):
        got = control.control(REPO, workload, 5, torch.device("cuda", 0),
                              settings={"tower.table_dtype": "bfloat16"})
        assert any(v > lim for v, lim in got.values()), got


@pytest.mark.cuda
def test_full_train_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "full.train",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
