"""Time the dense tower kernel (csrc/tower.cu) beside other builds of it, on
one NVIDIA GPU.

    python -m dssm_tpu_torch.tools.tower_tiles [--source NAME=PATH ...]

Builds csrc/tower.cu as it stands and each --source file (a tower.cu of
another design with the same C entry point, e.g. an earlier commit's, or an
edited copy), all at once; holds every build to the plain version; then
times each with CUDA-graph replays (median of 11 replays of 20 calls,
L2-warm) at the shapes the main path gives the tower: the `full` preset's
eval / serving forward (1024 rows, bf16), a query batch (64 rows), its
training forward with residuals (2048 rows, both sides stacked), the `tiny`
preset's f32 forward (256 rows), and an f32 hidden layer wider than the
kernel's shared-memory tile (300 -> 2048 -> 128); each beside PyTorch's
addmm + tanh chain. Builds are timed in turns, forward then backward
through the list. Prints the card's name and power limit, one line per case
and a JSON line last. Needs one GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dssm_tpu_torch.kernels import _build, tower

CASES = (  # name, rows, dtype, widths, residuals
    ("forward, 1024 rows bf16", 1024, torch.bfloat16, (300, 300, 128), False),
    ("query batch, 64 rows bf16", 64, torch.bfloat16, (300, 300, 128), False),
    ("residuals, 2048 rows bf16", 2048, torch.bfloat16, (300, 300, 128),
     True),
    ("tiny forward, 256 rows f32", 256, torch.float32, (300, 300, 128),
     False),
    ("wide forward, 256 rows f32", 256, torch.float32, (300, 2048, 128),
     False),
)


def build(sources):
    """{name: path of its shared library}, compiled in parallel."""
    builds = {"tower": os.path.join(_build.CSRC, "tower.cu")}
    builds.update({n: os.path.abspath(p) for n, p in sources})
    out = os.path.join(_build.BUILD_DIR, "tower_tiles")
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = dict(zip(builds, ex.map(
            lambda kv: _build.compile_library(
                [kv[1]], os.path.join(out, kv[0], "libtower.so")),
            builds.items())))
    for name, lib in libs.items():
        with open(os.path.join(os.path.dirname(lib), "nvcc_" + os.path.splitext(
                os.path.basename(builds[name]))[0] + ".log")) as f:
            print(f"{name}: " + " | ".join(
                ln.strip() for ln in f if "registers" in ln or "spill" in ln))
    return libs


def graph_ms(fn, reps=20, replays=11):
    """Device ms per call: `reps` calls in a CUDA graph, median replay."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another tower.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tower_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build([s.split("=", 1) for s in args.source])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {}
    for case, rows, dtype, widths, residuals in CASES:
        x = torch.from_numpy(rng.uniform(-1, 1, (rows, widths[0])).astype(
            np.float32)).to(dev, dtype)
        layers = [(torch.from_numpy((rng.normal(size=(a, b)) / np.sqrt(a))
                                    .astype(np.float32)).to(dev, dtype),
                   torch.from_numpy(rng.normal(size=(b,)).astype(np.float32)
                                    * 0.1).to(dev, dtype))
                  for a, b in zip(widths[:-1], widths[1:])]
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        want, want_hs = tower.dense_tower_residuals_plain(x, layers, "tanh",
                                                          False)

        def kernel():
            return tower.dense_tower_residuals(x, layers, "tanh", False,
                                               impl="kernel") if residuals \
                else (tower.dense_tower(x, layers, "tanh", False,
                                        impl="kernel"), [])

        def library():
            hh, keep = x, []
            for w, b in layers:
                hh = torch.tanh(torch.addmm(b, hh, w))
                keep.append(hh.float() if residuals else hh)
            return keep

        row = {}
        order = list(libs) + list(reversed(list(libs)))
        for i, name in enumerate(order):
            _build.load(libs[name])  # the wrappers launch through this build
            try:
                y, hs = kernel()
                torch.cuda.synchronize()
            except RuntimeError as err:  # a design that does not take it
                row.setdefault(name, []).append(None)
                print(f"{name}, {case}: {err}")
                continue
            err = max([float((y - want).abs().max())]
                      + [float((h - w).abs().max())
                         for h, w in zip(hs, want_hs)])
            if err > tol:
                raise RuntimeError(f"{name}, {case}: max err {err} > {tol}")
            row.setdefault(name, []).append(graph_ms(kernel))
            if i == len(libs) - 1:
                row["library"] = [graph_ms(library)]
                row["plain"] = [graph_ms(
                    lambda: tower.dense_tower_residuals_plain(
                        x, layers, "tanh", False))]
        results[case] = {k: [None if t is None else round(t * 1e3, 3)
                             for t in v] for k, v in row.items()}
        print(f"{case} (us, each build twice): {json.dumps(results[case])}")
    _build.load(_build.build())
    print(json.dumps({"tower_tiles_us": results,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
