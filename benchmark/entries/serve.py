"""Serving traffic: an open loop at a fixed rate. Requests fall due every
1 / `rate_per_s` seconds; each is `queries` query texts drawn from the
seed: serve/retrieval.py's embed_queries (hash, dedupe, one replay of the
query tower a batch) and then top_k (exact) against an index of
`index_titles` titles that build_doc_index embeds in set-up and that is
held on the card as a tensor. One caller serves them in order, so a
request that falls due while another is served waits; its latency runs
from when it fell due until its ids are on the host. Every request that
falls due in the window is served, also past its close. query_p95_ms is
the 95th percentile of all of them. The rate is fixed in the traffic file
from a sweep of the card (benchmark/sweep.py) below the highest rate it
sustains.

The deployed model's frequency remap comes from its training corpus (the
configuration's toy corpus), as a trained model's would.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np

from benchmark import gen, trace as btrace
from benchmark.core import Stretch, tower_of
from benchmark.entries import common
from benchmark.reference import check
from benchmark.work import counts

LATE_S = 60.0  # past the window's close, requests not yet served fail


@dataclass
class Serving:
    """A set-up index and the requests of a run."""
    cfg: object
    tower: dict
    pool_q: List[str]
    titles: List[str]
    picks: np.ndarray            # [request pool, queries] query numbers
    train: Tuple[List[str], List[str]]
    request: Callable            # (number, labelled) -> (scores, ids)
    served: list = field(default_factory=list)  # (number, scores, ids)

    def texts(self, r: int) -> List[str]:
        return [self.pool_q[j] for j in self.picks[r % len(self.picks)]]


def setup(cell, cfg, seed: int, device, mark=lambda name: None
          ) -> Serving:
    import torch
    from torch.profiler import record_function

    from dssm_tpu_torch.data.loader import hash_pairs
    from dssm_tpu_torch.data.remap import build_freq_remap
    from dssm_tpu_torch.data.toy import ToyPairs
    from dssm_tpu_torch.serve import retrieval

    tr = cell.traffic
    tq, tt = common.train_corpus(cell, cfg, seed)
    pool_q, titles = common.pairs(cell, cfg, tr["index_titles"],
                                   seed, common.INDEX)
    mark("corpus")
    remap = None
    if cfg.data.freq_remap:
        remap = build_freq_remap(hash_pairs(ToyPairs(queries=tq, titles=tt),
                                            cfg.tower, cfg.data),
                                 cfg.tower.vocab_size,
                                 num_shards=cfg.mesh.model_parallel)
    mark("remap")
    tower = tower_of(cfg)
    params = common.program_params(cfg, tower, seed, device)
    index = torch.as_tensor(retrieval.build_doc_index(
        params, cfg, titles, tr["index_batch"], remap=remap, device=device),
        device=device)
    mark("index")
    picks = gen.rng(seed, common.REQUESTS).integers(
        0, len(pool_q), size=(tr["request_pool"], tr["queries"]))
    none = contextlib.nullcontext()
    srv = None

    def request(r: int, labelled: bool = False):
        with record_function("bench.request") if labelled else none:
            qe = retrieval.embed_queries(params, cfg, srv.texts(r),
                                         tr["query_batch"], remap=remap,
                                         device=device)
            return retrieval.top_k(qe, index, k=tr["k"], exact=tr["exact"],
                                   device=device)

    srv = Serving(cfg, tower, pool_q, titles, picks, (tq, tt), request)
    return srv


def window(srv: Serving, first: int, seconds: float, rate: float
           ) -> Tuple[List[float], List[float], int, float, float]:
    """Serve the requests that fall due in `seconds` at `rate` a second,
    numbered from `first`: (latencies s of those served, how late each was
    started, failed, seconds from the window's start to the last one
    served, seconds spent serving)."""
    due = np.arange(int(np.ceil(seconds * rate))) / rate
    lats, lates, failed, busy = [], [], 0, 0.0
    t0 = time.perf_counter()
    for i, d in enumerate(due):
        now = time.perf_counter() - t0
        if now > seconds + LATE_S:
            failed = len(due) - i
            break
        # The client busy-waits for each due time. A sleep's wake-up came
        # late by the host's whim and counted in the latency, and left the
        # core idle between requests (PERF.md).
        while time.perf_counter() - t0 < d:
            pass
        start = time.perf_counter()
        scores, ids = srv.request(first + i)
        end = time.perf_counter()
        busy += end - start
        lats.append(end - t0 - d)
        lates.append(start - t0 - d)
        srv.served.append((first + i, scores, ids))
    return lats, lates, failed, time.perf_counter() - t0, busy


def run(cell, cfg, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> common.Outcome:
    import torch

    tr = cell.traffic
    cuda = device.type == "cuda"
    mark = common.Phases(t_start)
    mark("imports")
    srv = setup(cell, cfg, seed, device, mark)
    r = 0
    for _ in range(tr["warm_requests"]):
        srv.request(r)
        r += 1
    common.settle()
    stretch = tobj = None
    traced_reqs = range(r, r + tr["trace_requests"]) if traced else range(0)
    if traced:
        tobj = btrace.profile(lambda: [srv.request(j, True)
                                       for j in traced_reqs], device)
        r += len(traced_reqs)
        stretch = Stretch(kind="serve", units=len(traced_reqs),
                          busy_s=tobj.busy_s, window_s=tobj.window_s)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    lats, lates, failed, wall, serving_s = window(srv, r, seconds,
                                                  tr["rate_per_s"])
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    srv.request = None  # drops the program's parameters and index
    common.free(device)

    # A sample of the window's requests, drawn from the seed.
    served = srv.served
    sample = np.sort(gen.rng(seed, common.SAMPLE).choice(
        len(served), size=min(tr["check_requests"], len(served)),
        replace=False))
    cfg_t = srv.tower
    remap_r = common.reference_remap(cfg, *srv.train)
    pr = common.reference_params(cfg, cfg_t, seed, device)
    ref = common.reference(cfg)
    t = lambda a: torch.as_tensor(a, device=device)
    _, (di, dw) = common.encoded(cfg, [], srv.titles, remap_r)
    rindex = ref.embed(pr, cfg_t, t(di), t(dw))
    (qi, qw), _ = common.encoded(
        cfg, [x for i in sample for x in srv.texts(served[i][0])], [],
        remap_r)
    rq = ref.embed(pr, cfg_t, t(qi), t(qw))
    checks = check.topk_gaps(rq, rindex,
                             np.concatenate([served[i][1] for i in sample]),
                             np.concatenate([served[i][2] for i in sample]))
    lat_ms = np.asarray(lats) * 1e3
    late_ms = np.asarray(lates) * 1e3
    svc_ms = lat_ms - late_ms
    notes = [mark.note(), f"{len(lats)} requests served in {wall:.3f} s at "
             f"{tr['rate_per_s']}/s, {failed} failed; latency ms median "
             f"{np.median(lat_ms):.4f} p90 {np.percentile(lat_ms, 90):.4f} "
             f"p95 {np.percentile(lat_ms, 95):.4f} p99 "
             f"{np.percentile(lat_ms, 99):.4f} max {lat_ms.max():.4f}; "
             f"{len(sample)} requests checked",
             f"started late ms median {np.median(late_ms):.4f} p95 "
             f"{np.percentile(late_ms, 95):.4f} max {late_ms.max():.4f}; "
             f"served in ms median {np.median(svc_ms):.4f} p95 "
             f"{np.percentile(svc_ms, 95):.4f} max {svc_ms.max():.4f}"]
    if stretch is not None:
        items = []
        for rr in traced_reqs:
            (qi, qw), _ = common.encoded(cfg, srv.texts(rr), [], remap_r)
            entries, uniq = common.live_counts([(qi, qw)],
                                               np.arange(tr["queries"]))
            items.append(counts.serve_request(cfg_t, tr["queries"], entries,
                                              uniq, len(srv.titles),
                                              tr["k"]))
        stretch.work = [it for req in items for it in req]
        stretch.unit_flops = sum(counts.flops(x) for x in items) / len(items)
        # The share of the peak while serving: the loop's idle waits for
        # the next request to fall due are left out.
        stretch.wall_units, stretch.wall_s = len(lats), serving_s
    return common.Outcome(
        metrics={"query_p95_ms": float(np.percentile(lat_ms, 95)),
                 "setup_s": setup_s},
        attempted=len(lats) + failed, failed=failed,
        memory_peak_bytes=peak, checks=checks, stretch=stretch, trace=tobj,
        notes=notes)
