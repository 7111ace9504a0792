"""Run one cell of BENCHMARK.json once, on the card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets the cell up (corpus and weights made
from the seed, kernels built or loaded from the checkout's build
directory, every shape of the cell warmed), measures for --seconds, checks
what the timed path produced against the plain reference, and prints one
JSON line last on stdout: with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer metrics read from a profiled stretch. The
numbers compared, each beside its limit, come last on stderr and last in
the line. It fails, printing no result, without a card, without the
program, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")
# One thread a CPU op: the timed loops are host-paced, and an OpenMP pool
# beside the loop's thread made their rates wander (PERF.md).
os.environ.setdefault("OMP_NUM_THREADS", "1")
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT  # benchmark/'s own folders shadow no module
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def measure(root: str, workload: str, seed: int, seconds: float,
            traced: bool, device=None, t_start: float = T_START):
    """(result line, compared numbers with limits, notes) of one run.
    device: where the program runs; the card unless a test asks for the
    CPU."""
    import torch

    from benchmark import core

    cell = core.load_cell(root, workload)
    if device is None:
        device = torch.device("cuda", 0)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    cfg = core.run_config(cell)
    out = core.entry(cell).run(cell, cfg, seed, seconds, traced, device,
                               t_start)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in out.checks.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    names = ([m["name"] for m in cell.per_layer()] if traced
             else [m["name"] for m in cell.end_to_end()])
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"]
             + cell.manifest["per_layer"]}
    if traced:
        values = {n: core.reader(root, n)(out.stretch) for n in names}
    else:  # <quantity>.<cells> reads the driver's <quantity>
        values = {n: out.metrics.get(n.split(".")[0]) for n in names}
    metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items()
               if v is not None}
    if device.type == "cuda":
        dev = core.device_info(cell.chips, device)
        dev["memory_peak_bytes"] = out.memory_peak_bytes
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    breakdown = None
    if traced and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        breakdown = {"device_ops": out.trace.device_ops,
                     "idle_gaps": out.trace.idle_gaps}
    line = core.result_line(correct, out.attempted, out.failed, metrics, dev,
                            checks, breakdown)
    return line, checks, out.notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")

    import torch

    from benchmark import core

    chips = core.load_cell(os.getcwd(), args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, checks, notes = measure(os.getcwd(), args.workload, args.seed,
                                  args.seconds, bool(args.trace))
    found = core.forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for n in notes:
        print(n, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
