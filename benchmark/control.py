"""The control of `correct`: one precision below the configuration's, on a
cell's own inputs and sizes, judged by the cell's own comparison. It has
to come out not correct. Either the plain reference computed in fp8 where
the configuration states bf16 (the towers, reference/mlp.py) is put in
the program's place, or, with --setting, the program runs its own
lower-precision path (tower.table_dtype=bfloat16 for the f32 table) for a
short window; with --fault, the program runs with a fault of
benchmark/faults.py planted. One JSON line a seed: the compared numbers
and whether each is within its limit.

    python3 benchmark/control.py --workload full.train --seeds 1,2,3
    python3 benchmark/control.py --workload full.train --seeds 1,2,3 \
        --setting tower.table_dtype=bfloat16

Benchmark runs never run it; a test runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT


def train_numbers(cell, cfg, seed: int, device, precision: str):
    from benchmark import gen
    from benchmark.core import tower_of
    from benchmark.entries import common

    tower = tower_of(cfg)
    queries, titles = common.train_corpus(cell, cfg, seed)
    inputs = common.train_inputs(
        cfg, queries, titles, gen.torch_seed(seed, common.LOADER) % 2**32)
    n = cell.traffic["check_steps"]
    epoch = len(inputs.perm) // inputs.batch
    ctl = common.reference_steps(cfg, tower, seed, inputs, epoch, n, device,
                                 precision)
    ctl_cached, ref_cached = (
        common.reference_steps(cfg, tower, seed, inputs, n, 0, device, p,
                               first=epoch, start=ctl.params)
        for p in (precision, "f32"))
    ref = common.reference_steps(cfg, tower, seed, inputs, n, n, device)
    return common.train_checks(ctl.losses[:n], ctl_cached.losses, ctl.grad,
                               ctl.change, ref, ref_cached.losses, tower)[0]


def eval_numbers(cell, cfg, seed: int, device, precision: str):
    import torch

    from benchmark import gen
    from benchmark.core import tower_of
    from benchmark.entries import common
    from benchmark.reference import check, retrieval

    tower = tower_of(cfg)
    ref = common.reference(cfg)
    tq, tt = common.train_corpus(cell, cfg, seed)
    queries, titles = common.pairs(cell, cfg, cell.traffic["pairs"],
                                    seed, common.EVAL)
    remap = common.reference_remap(cfg, tq, tt)
    (qi, qw), (di, dw) = common.encoded(cfg, queries, titles, remap)
    p = common.reference_params(cfg, tower, seed, device)
    t = lambda a: torch.as_tensor(a, device=device)
    rq, rd = ref.embed(p, tower, t(qi), t(qw)), ref.embed(p, tower, t(di),
                                                           t(dw))
    cq = ref.embed(p, tower, t(qi), t(qw), precision)
    cd = ref.embed(p, tower, t(di), t(dw), precision)
    return {"emb_gap": max(check.emb_gap(cq, rq), check.emb_gap(cd, rd)),
            "rank_gap": check.rank_gap(rq, rd, retrieval.ranks(cq, cd))}


def serve_numbers(cell, cfg, seed: int, device, precision: str):
    import torch

    from benchmark import gen
    from benchmark.core import tower_of
    from benchmark.entries import common
    from benchmark.reference import check, retrieval

    tr = cell.traffic
    tower = tower_of(cfg)
    ref = common.reference(cfg)
    tq, tt = common.train_corpus(cell, cfg, seed)
    pool_q, titles = common.pairs(cell, cfg, tr["index_titles"],
                                   seed, common.INDEX)
    picks = gen.rng(seed, common.REQUESTS).integers(
        0, len(pool_q), size=(tr["request_pool"], tr["queries"]))
    remap = common.reference_remap(cfg, tq, tt)
    texts = [pool_q[j] for row in picks[:tr["check_requests"]] for j in row]
    (qi, qw), _ = common.encoded(cfg, texts, [], remap)
    _, (di, dw) = common.encoded(cfg, [], titles, remap)
    p = common.reference_params(cfg, tower, seed, device)
    t = lambda a: torch.as_tensor(a, device=device)
    rq, ri = ref.embed(p, tower, t(qi), t(qw)), ref.embed(p, tower, t(di),
                                                           t(dw))
    cq = ref.embed(p, tower, t(qi), t(qw), precision)
    ci = ref.embed(p, tower, t(di), t(dw), precision)
    scores, ids = retrieval.top_k(cq, ci, tr["k"])
    return check.topk_gaps(rq, ri, scores, ids)


NUMBERS = {"train": train_numbers, "eval": eval_numbers,
           "serve": serve_numbers}


def control(root: str, workload: str, seed: int, device,
            precision: str = "fp8", settings=None, fault: str = ""):
    """{number: (value, limit)} of the control on one seed: the reference
    in `precision`, or the program under `settings` {key: value}, or the
    program with a fault of benchmark/faults.py planted."""
    import contextlib
    import time

    from benchmark import core, faults

    cell = core.load_cell(root, workload)
    if settings or fault:
        cell.config["settings"].update(settings or {})
        cfg = core.run_config(cell)
        with (faults.planted(cell.traffic["entry"], fault) if fault
              else contextlib.nullcontext()):
            got = core.entry(cell).run(cell, cfg, seed, 0.5, False, device,
                                       time.perf_counter()).checks
    else:
        cfg = core.run_config(cell)
        got = NUMBERS[cell.traffic["entry"]](cell, cfg, seed, device,
                                             precision)
    return {k: (v, cell.limits[k]) for k, v in got.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="fp8")
    ap.add_argument("--setting", action="append", default=[],
                    help="key=value (JSON value): run the program so")
    ap.add_argument("--fault", default="",
                    help="run the program with this fault of faults.py")
    args = ap.parse_args()
    settings = {}
    for kv in args.setting:
        k, v = kv.split("=", 1)
        try:
            settings[k] = json.loads(v)
        except json.JSONDecodeError:
            settings[k] = v

    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control(os.getcwd(), args.workload, seed,
                      torch.device("cuda", 0), args.precision, settings,
                      args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or settings
                          or args.precision,
                          "numbers": {k: v for k, (v, _) in got.items()},
                          "within_limits": {k: v <= lim for k, (v, lim)
                                            in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
