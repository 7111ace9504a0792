"""Vocab sizing for the trigram hash: collision rates and per-batch dedupe
sizes on a corpus. Host-only: it touches no device.

    python -m dssm_tpu_torch.tools.vocab_stats [--path=data.tsv] \
        [--batch=1024] [--vocab=30000,100000,500000] [--max-pairs=65536]

With no --path it reads the toy corpus. Prints, for each candidate vocab
size, the collision rate; then, for random training batches at the largest
size, the distinct trigram rows and row groups a side (f32 group = 8, bf16
group = 16), p50 / p99 / max: the numbers that set data.max_unique (group
slots * group) and data.max_unique_rows. The flags and lines are those of
the repository root's tools/vocab_stats.py; the hashing is the port's
(data/trigram.py: the C++ host plane, or its plain version), bit-equal to
dssm_tpu's.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="",
                    help="TSV/JSONL corpus (default: toy)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--vocab", default="30000,100000,500000")
    ap.add_argument("--max-pairs", type=int, default=65536)
    ap.add_argument("--max-trigrams", type=int, default=64)
    ap.add_argument("--num-batches", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from dssm_tpu_torch.data import make_toy_pairs, read_pairs
    from dssm_tpu_torch.data.trigram import collision_stats, hash_batch

    if args.path:
        pairs = read_pairs(args.path, args.max_pairs)
    else:
        pairs = make_toy_pairs(min(args.max_pairs, 16384), seed=args.seed)
    texts = pairs.queries + pairs.titles
    n = len(pairs.queries)
    print(f"corpus: {n} pairs ({len(texts)} texts)")

    vocabs = [int(v) for v in args.vocab.split(",") if v]
    for v in vocabs:
        st = collision_stats(texts, v)
        print(
            f"vocab {v:>8d}: distinct_trigrams={int(st['distinct_trigrams'])} "
            f"used_buckets={int(st['used_buckets'])} "
            f"collision_rate={st['collision_rate']:.4%}"
        )

    # Per-batch dedupe sizing at the largest candidate vocab.
    v = vocabs[-1]
    q_idx, _ = hash_batch(pairs.queries, v, args.max_trigrams)
    d_idx, _ = hash_batch(pairs.titles, v, args.max_trigrams)
    rng = np.random.default_rng(args.seed)
    rows_stats = {8: [], 16: [], 0: []}
    nb = min(args.num_batches, max(1, n // args.batch))
    for _ in range(nb):
        rows = rng.choice(n, size=min(args.batch, n), replace=False)
        # The dedupe caps are a side's (q and d each carry their own
        # unique list), so size to the larger side, not the pooled union.
        for side_idx in (q_idx, d_idx):
            idx = side_idx[rows].ravel()
            idx = idx[idx != 0]
            rows_stats[0].append(len(np.unique(idx)))
            for g in (8, 16):
                rows_stats[g].append(len(np.unique(idx // g)))

    def pct(a):
        a = np.sort(np.asarray(a))
        return (
            f"p50={int(np.percentile(a, 50))} "
            f"p99={int(np.percentile(a, 99))} max={int(a[-1])}"
        )

    print(f"\nper-batch dedup sizing (batch={args.batch}, vocab={v}, "
          f"per side, {nb} batches):")
    print(f"  unique rows:              {pct(rows_stats[0])}")
    for g, name in ((8, "f32"), (16, "bf16")):
        groups = rows_stats[g]
        print(f"  unique row-groups ({name:>4}): {pct(groups)}")
        rec = int(2 ** np.ceil(np.log2(max(1, np.percentile(groups, 99)))))
        print(
            f"    -> suggest data.max_unique={rec * g} "
            f"({rec} group slots x {g} rows)"
        )
    u = rows_stats[0]
    rec_rows = int(2 ** np.ceil(np.log2(max(1, np.percentile(u, 99)))))
    print(f"  -> suggest data.max_unique_rows={max(256, rec_rows)}")


if __name__ == "__main__":
    main()
