"""A copy of the benchmark with tiny cells beside the real ones, for the
CPU tests: the `full` configuration cut to widths and a corpus the CPU
runs in a second, and each traffic mix shrunk. A tiny cell's limits are
its own: at these widths and batches the sound program and the control
read other gaps than at the cells' sizes (PERF.md gives those), so each
limit lies between what the sound tiny cells and the fp8 control read
here on a few seeds."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
TINY = {"tower.vocab_size": 4096, "tower.embed_width": 40,
        "tower.hidden_dims": [48], "tower.semantic_dim": 32,
        "data.toy_num_pairs": 1200, "data.toy_vocab_words": 2048,
        "data.max_unique": 4096, "data.max_unique_rows": 2048,
        "train.batch_size": 64}
LIMITS = {"train": {"loss_gap": 0.01, "cached_loss_gap": 0.02, "grad_gap": 0.02,
                     "grad_elem_gap": 0.025, "update_gap": 0.05},
          "eval": {"emb_gap": 0.02, "rank_gap": 0.005},
          "serve": {"score_gap": 0.003, "topk_gap": 0.003}}
TRAFFIC = {"eval": {"pairs": 512},
           "serve": {"index_titles": 4096, "request_pool": 64,
                     "queries": 32, "query_batch": 32, "index_batch": 256,
                     "rate_per_s": 50, "check_requests": 4,
                     "trace_requests": 2}}


def make_root(tmp: str) -> str:
    """tmp holding BENCHMARK.json with the cells tiny.train, tiny.eval and
    tiny.serve added as files, and benchmark/ beside it."""
    shutil.copytree(BENCH, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(tmp, "benchmark")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(b, "configs", "full.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["settings"].update(TINY)
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for kind in ("train", "eval", "serve"):
        with open(os.path.join(b, "traffic", f"{kind}.json")) as f:
            traffic = json.load(f)
        traffic.update(TRAFFIC.get(kind, {}))
        with open(os.path.join(b, "traffic", f"{kind}_tiny.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(b, "cells", f"tiny.{kind}.json"), "w") as f:
            json.dump({"limits": LIMITS[kind]}, f)
        name = f"tiny.{kind}"
        manifest["workloads"].append({"name": name, "config": "tiny",
                                      "traffic": f"{kind}_tiny", "chips": 1,
                                      "why": "a CPU test"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if f"full.{kind}" in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return tmp


def measure(root: str, workload: str, seed: int = 7, seconds: float = 0.3,
            traced: bool = False):
    """run.py's measure on the CPU: (result dict, checks, notes)."""
    import importlib.util
    import time

    import torch

    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    line, checks, notes = run.measure(root, workload, seed, seconds, traced,
                                      device=torch.device("cpu"),
                                      t_start=time.perf_counter())
    return json.loads(line), checks, notes
