"""The host data plane's cost a batch at the multihost preset's layout:
itemized stages, the pipeline's worker curve, the epoch cache. Host-only:
it touches no device.

    python -m dssm_tpu_torch.tools.host_plane_bench [--pairs=131072] \
        [--global-batch=65536] [--processes=8] [--reps=3] [--batches=6] \
        [--workers=0,2,4,8]

The layout is the port's multihost run: one process a GPU, each holding
its data coordinate's shard of the global batch (global_batch /
processes rows at dp = processes) and one slot space of
data.max_unique_rows_local slots (local_sel_shards = 1, as cli.train sets
it). The corpus is the preset's toy corpus, hashed and frequency-remapped
once (data/native.py's C++ plane). Three parts, as the repository root's
tools/host_plane_bench.py:

  (a) one batch, each stage timed alone (the mean of --reps after a warm
      call): the global two-level dedupe and the shard's slice, the row
      sort, reslot_local, compress_wire, and their sum;
  (b) the loader (data/loader.py::batch_iterator) at each pipeline width
      of --workers: ms a batch over --batches after one warm batch;
  (c) the epoch cache (reshuffle_each_epoch=False,
      cache_epoch_batches=True): ms a batch of the first epoch, then of
      three more epochs.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> None:
    from dssm_tpu_torch.config import get_preset

    cfg = get_preset("multihost")
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=cfg.data.toy_num_pairs)
    ap.add_argument("--global-batch", type=int,
                    default=cfg.train.batch_size)
    ap.add_argument("--processes", type=int, default=8,
                    help="data-parallel processes (dp)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--workers", default="0,2,4,8")
    args = ap.parse_args(argv)

    from dssm_tpu_torch.data import hash_pairs, loader, make_toy_pairs
    from dssm_tpu_torch.data.remap import apply_remap, build_freq_remap

    d = cfg.data
    gb, n, dp = args.global_batch, args.pairs, args.processes
    if n < gb or gb % dp:
        raise SystemExit(f"--pairs={n} must hold one --global-batch={gb}, "
                         f"a multiple of --processes={dp}")
    local = gb // dp
    t0 = time.perf_counter()
    pairs = make_toy_pairs(n, vocab_words=d.toy_vocab_words, seed=1)
    hashed = hash_pairs(pairs, cfg.tower, d)
    hashed = apply_remap(hashed, build_freq_remap(hashed,
                                                  cfg.tower.vocab_size))
    print(f"corpus: {n} pairs hashed+remapped in "
          f"{time.perf_counter() - t0:.1f} s (one-off); global batch {gb}, "
          f"{dp} processes of {local} rows, one slot space of "
          f"{d.max_unique_rows_local} a process")

    # ---- (a) one batch, itemized ---------------------------------------
    rows = np.random.default_rng(0).permutation(n)[:gb]

    def timeit(fn, label):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn()
        dt = (time.perf_counter() - t0) / args.reps
        print(f"  {label:44s} {dt * 1e3:8.1f} ms")
        return out, dt

    base, t_dedupe = timeit(
        lambda: loader._global_dedup_local_batch(
            hashed, rows, False, d.max_unique, 8, d.max_unique_rows, True,
            0, local),
        "global two-level dedupe + local slice (C++)")
    sortd, t_sort = timeit(lambda: loader.sort_batch_rows(dict(base)),
                           "sort_batch_rows")
    resl, t_reslot = timeit(
        lambda: loader.reslot_local(dict(sortd), d.max_unique_rows_local, 1),
        f"reslot_local (cap {d.max_unique_rows_local} x 1 shard)")
    plan = loader.wire_dtype_plan(hashed, d.max_unique, d.max_unique_rows)
    _, t_wire = timeit(lambda: loader.compress_wire(dict(resl), plan),
                       "compress_wire")
    total = t_dedupe + t_sort + t_reslot + t_wire
    print(f"  {'TOTAL per batch (serial, itemized)':44s} {total * 1e3:8.1f} ms")

    def stream(**kw):
        return loader.batch_iterator(
            hashed, gb, False, seed=1, process_index=0, process_count=dp,
            dedup_unique=d.max_unique, dedup_group=8,
            dedup_unique_rows=d.max_unique_rows, dedup_joint=True,
            wire_compress=True, sort_rows=True,
            local_sel_cap=d.max_unique_rows_local, local_sel_shards=1, **kw)

    # ---- (b) the pipeline's worker curve --------------------------------
    for w in (int(x) for x in args.workers.split(",") if x):
        it = stream(pipeline_workers=w)
        next(it)  # warm (fills the pool)
        t0 = time.perf_counter()
        for _ in range(args.batches):
            next(it)
        dt = (time.perf_counter() - t0) / args.batches
        print(f"  pipeline W={w}: {dt * 1e3:8.1f} ms/batch effective "
              f"({os.cpu_count()} cores on this host)")

    # ---- (c) the epoch cache's steady state -----------------------------
    it = stream(reshuffle_each_epoch=False, cache_epoch_batches=True)
    bpe = n // gb
    t0 = time.perf_counter()
    for _ in range(bpe):
        next(it)
    cold = (time.perf_counter() - t0) / bpe
    t0 = time.perf_counter()
    warm_batches = 3 * bpe
    for _ in range(warm_batches):
        next(it)
    warm = (time.perf_counter() - t0) / warm_batches
    print(f"  epoch cache: epoch-1 {cold * 1e3:.1f} ms/batch, "
          f"epoch>=2 {warm * 1e3:.3f} ms/batch "
          f"(reshuffle_each_epoch=False, cache_epoch_batches=True)")


if __name__ == "__main__":
    main()
