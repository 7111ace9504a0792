"""Find the highest request rate a serving cell sustains: set the cell up
once, then offer each rate for a stretch and print one JSON line a rate
(median, p95 and largest latency in ms, requests failed, the mean seconds a
request is served in, and the rate that mean allows). The cell's traffic
file then fixes a rate of about four fifths of the highest sustained.

    python3 benchmark/sweep.py --workload full.serve --seed 1 \
        --seconds 10 --rates 100,150,200,250
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch

    from benchmark import core
    from benchmark.entries import serve

    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.load_cell(os.getcwd(), args.workload)
    cfg = core.run_config(cell)
    srv = serve.setup(cell, cfg, args.seed, torch.device("cuda", 0))
    r = 0
    for _ in range(cell.traffic["warm_requests"]):
        srv.request(r)
        r += 1
    for rate in (float(x) for x in args.rates.split(",")):
        lats, _, failed, wall, busy = serve.window(srv, r, args.seconds, rate)
        r += len(lats) + failed
        srv.served.clear()
        ms = np.asarray(lats) * 1e3
        print(json.dumps({"rate_per_s": rate, "served": len(lats),
                          "failed": failed, "wall_s": wall,
                          "median_ms": float(np.median(ms)),
                          "p95_ms": float(np.percentile(ms, 95)),
                          "max_ms": float(ms.max()),
                          "mean_service_s": busy / len(lats),
                          "service_rate_per_s": len(lats) / busy}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
