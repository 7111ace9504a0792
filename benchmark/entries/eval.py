"""Eval traffic: whole passes of train/eval.py's evaluate over a held-out
set, each query ranked against every title (recall@k, NDCG@10, MRR), the
EvalCache of stacked wire blocks filled in set-up.

A pass runs evaluate's body (embed_corpus into a [2, N, D] buffer kept
from pass to pass, compute_ranks, metrics_from_ranks), so that the check
can read the embeddings and the ranks it produced, which evaluate keeps to
itself. eval_pairs_per_s = pairs ranked in whole passes / the window's
seconds.
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import numpy as np

from benchmark import trace as btrace
from benchmark.core import Stretch, tower_of
from benchmark.entries import common
from benchmark.reference import check
from benchmark.work import counts


def run(cell, cfg, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> common.Outcome:
    import torch
    from torch.profiler import record_function

    from dssm_tpu_torch.data.loader import hash_pairs
    from dssm_tpu_torch.data.remap import apply_remap, build_freq_remap
    from dssm_tpu_torch.data.toy import ToyPairs
    from dssm_tpu_torch.train import eval as eval_mod

    tr = cell.traffic
    tower = tower_of(cfg)
    cuda = device.type == "cuda"
    mark = common.Phases(t_start)
    mark("imports")
    tq, tt = common.train_corpus(cell, cfg, seed)
    queries, titles = common.pairs(cell, cfg, tr["pairs"], seed,
                                    common.EVAL)
    hashed = hash_pairs(ToyPairs(queries=queries, titles=titles), cfg.tower,
                        cfg.data)
    if cfg.data.freq_remap:
        remap = build_freq_remap(hash_pairs(ToyPairs(queries=tq, titles=tt),
                                            cfg.tower, cfg.data),
                                 cfg.tower.vocab_size,
                                 num_shards=cfg.mesh.model_parallel)
        hashed = apply_remap(hashed, remap)
    mark("hashed")
    params = common.program_params(cfg, tower, seed, device)
    n = len(hashed)
    emb = torch.empty((2, n, cfg.tower.semantic_dim), dtype=torch.float32,
                      device=device)
    seen = {}
    none = contextlib.nullcontext()

    def one(labelled: bool = False) -> None:
        with record_function("bench.pass") if labelled else none:
            q, d = eval_mod.embed_corpus(params, cfg, hashed,
                                         cfg.train.batch_size, cache=True,
                                         out=emb)
            ranks = eval_mod.compute_ranks(q, d)
            eval_mod.metrics_from_ranks(ranks)
        key = hashlib.blake2b(ranks.tobytes(), digest_size=16).digest()
        seen.setdefault(key, ranks)

    mark("weights")
    for _ in range(tr["warm_passes"]):
        one()
    mark("warm passes")
    common.settle()
    stretch = tobj = None
    if traced:
        units = tr["trace_passes"]
        tobj = btrace.profile(lambda: [one(labelled=True)
                                       for _ in range(units)], device)
        stretch = Stretch(kind="eval", units=units, busy_s=tobj.busy_s,
                          window_s=tobj.window_s)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    passes = 0
    while True:
        one()
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    prog_emb = emb.to("cpu", copy=True)
    del params, emb, hashed
    common.free(device)

    remap_r = common.reference_remap(cfg, tq, tt)
    (qi, qw), (di, dw) = common.encoded(cfg, queries, titles, remap_r)
    pr = common.reference_params(cfg, tower, seed, device)
    ref = common.reference(cfg)
    t = lambda a: torch.as_tensor(a, device=device)
    rq = ref.embed(pr, tower, t(qi), t(qw))
    rd = ref.embed(pr, tower, t(di), t(dw))
    checks = {
        "emb_gap": max(check.emb_gap(prog_emb[0].to(device), rq),
                       check.emb_gap(prog_emb[1].to(device), rd)),
        "rank_gap": max(check.rank_gap(rq, rd, r) for r in seen.values()),
    }
    notes = [mark.note(), f"{passes} passes in {wall:.3f} s; {len(seen)} "
             "distinct rank arrays"]
    if stretch is not None:
        b = cfg.train.batch_size
        entries, rows = 0, []
        for lo in range(0, n, b):
            e, u = common.live_counts([(qi, qw), (di, dw)],
                                      np.arange(lo, min(lo + b, n)))
            entries += e
            rows.append(u)
        items = counts.eval_pass(tower, n, entries, rows)
        stretch.work = items * stretch.units
        stretch.unit_flops = counts.flops(items)
        stretch.wall_units, stretch.wall_s = passes, wall
    return common.Outcome(
        metrics={"eval_pairs_per_s": passes * n / wall, "setup_s": setup_s},
        attempted=passes, failed=0, memory_peak_bytes=peak, checks=checks,
        stretch=stretch, trace=tobj, notes=notes)
