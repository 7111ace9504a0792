"""Host-side input pipeline: hash once, then batch by array slicing.

The corpus is hashed once into fixed-length numpy arrays (data/trigram.py);
a batch is a slice of them plus the per-batch dedupe fields the lookup
kernels take (data/dedupe.py). Batches stay numpy here; bridge.batch_to_torch
moves them to the device. A copy of the single-process, serial path of
dssm_tpu/data/loader.py, bit-identical to it (tests/test_torch_data.py): the
multi-host shards, the thread-pool pipeline, the epoch batch cache and the
per-shard slot spaces come with the multi-device path and the host plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from dssm_tpu_torch.config import DataConfig, TowerConfig
from dssm_tpu_torch.data import trigram
from dssm_tpu_torch.data.dedupe import dedupe_two_level, dedupe_two_level_joint
from dssm_tpu_torch.data.toy import ToyPairs

Batch = Dict[str, np.ndarray]

# Dedupe fields that describe the whole batch rather than one row each.
_BATCH_WIDE = ("uniq", "sel")


@dataclass
class HashedPairs:
    """Whole corpus, pre-hashed (bag-of-trigrams fields)."""

    q_idx: np.ndarray  # [N, K] int32
    q_wgt: np.ndarray  # [N, K] f32
    d_idx: np.ndarray
    d_wgt: np.ndarray

    def __len__(self) -> int:
        return self.q_idx.shape[0]


def hash_pairs(pairs: ToyPairs, tower: TowerConfig, data: DataConfig) -> HashedPairs:
    if tower.is_sequence_model:
        raise NotImplementedError(
            f"{tower.arch} towers are not ported yet (ROADMAP.md, Queue 1: "
            "cnn/lstm)")
    kq = data.max_trigrams_query or data.max_trigrams
    q_idx, q_wgt = trigram.hash_batch(
        pairs.queries, tower.vocab_size, kq, data.normalize_counts
    )
    d_idx, d_wgt = trigram.hash_batch(
        pairs.titles, tower.vocab_size, data.max_trigrams, data.normalize_counts
    )
    return HashedPairs(q_idx=q_idx, q_wgt=q_wgt, d_idx=d_idx, d_wgt=d_wgt)


def add_dedup_fields(batch: Batch, max_unique: int, group: int = 8,
                     max_unique_rows: Optional[int] = None,
                     joint: bool = False) -> Batch:
    """Per-batch two-level index dedupe for the compact-gather lookup.
    Dropped-overflow lookups get their weights zeroed. `group` is the row
    group of the table dtype (8 f32 / 16 bf16).

    joint=False (separate tower tables): adds {q,d}_uniq (row-GROUP ids),
    {q,d}_sel (unique-row slots), {q,d}_inv (slot per lookup).
    joint=True (SHARED table): one UNION dedupe over both sides, adding
    `uniq`, `sel`, and per-side {q,d}_inv.

    max_unique is a compact-row budget at f32 (8-row-group) granularity: the
    GROUP-SLOT budget max_unique // 8 stays constant across table dtypes.
    """
    if max_unique_rows is None:
        max_unique_rows = max(256, max_unique // 8)
    max_unique = (max_unique // 8) * group
    out = dict(batch)
    if joint:
        uniq, sel, q_inv, d_inv, q_keep, d_keep = dedupe_two_level_joint(
            batch["q_idx"], batch["d_idx"], max_unique, max_unique_rows,
            group,
        )
        out["uniq"] = uniq
        out["sel"] = sel
        out["q_inv"] = q_inv
        out["d_inv"] = d_inv
        if not np.all(q_keep == 1.0):
            out["q_wgt"] = batch["q_wgt"] * q_keep
        if not np.all(d_keep == 1.0):
            out["d_wgt"] = batch["d_wgt"] * d_keep
        return out
    for side in ("q", "d"):
        uniq, sel, inv, keep = dedupe_two_level(
            batch[f"{side}_idx"], max_unique, max_unique_rows, group
        )
        out[f"{side}_uniq"] = uniq
        out[f"{side}_sel"] = sel
        out[f"{side}_inv"] = inv
        if not np.all(keep == 1.0):
            out[f"{side}_wgt"] = batch[f"{side}_wgt"] * keep
    return out


def select_batch(
    hashed: HashedPairs,
    rows: np.ndarray,
    dedup_unique: Optional[int] = None,
    dedup_group: int = 8,
    dedup_unique_rows: Optional[int] = None,
    dedup_joint: bool = False,
) -> Batch:
    batch = {
        "q_idx": hashed.q_idx[rows],
        "q_wgt": hashed.q_wgt[rows],
        "d_idx": hashed.d_idx[rows],
        "d_wgt": hashed.d_wgt[rows],
    }
    if dedup_unique:
        batch = add_dedup_fields(batch, dedup_unique, dedup_group,
                                 dedup_unique_rows, dedup_joint)
    return batch


def eval_batches(
    hashed: HashedPairs, batch: int,
    dedup_unique: Optional[int] = None, dedup_group: int = 8,
    dedup_unique_rows: Optional[int] = None,
    dedup_joint: bool = False,
) -> Iterator[Batch]:
    """One pass over the corpus in order, including the ragged tail."""
    n = len(hashed)
    for start in range(0, n, batch):
        rows = np.arange(start, min(start + batch, n))
        yield select_batch(hashed, rows, dedup_unique, dedup_group,
                           dedup_unique_rows, dedup_joint)


def pad_batch(batch: Batch, to_rows: int) -> Batch:
    """Pad every per-row field to `to_rows` rows by repeating row 0 (the
    padded rows' outputs are sliced off afterwards). The batch-wide dedupe
    fields (uniq/sel, {q,d}_uniq/_sel) pass through."""
    out = {}
    for k, v in batch.items():
        if k in _BATCH_WIDE or k.endswith(("_uniq", "_sel")):
            out[k] = v
            continue
        n = v.shape[0]
        if n == to_rows:
            out[k] = v
        else:
            pad = np.repeat(v[:1], to_rows - n, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
    return out


def sort_batch_rows(batch: Batch) -> Batch:
    """Jointly permute the batch's rows (q and d together, so diagonal
    positive labels stay aligned) by descending trigram count, so that rows
    of similar length sit together. A pure within-batch permutation of
    (query, doc) PAIRS: the in-batch loss, its gradient and eval metrics are
    order-invariant. The batch-wide dedup fields pass through untouched."""
    key_d = (batch["d_wgt"] != 0).sum(axis=1)
    key_q = (batch["q_wgt"] != 0).sum(axis=1)
    if key_d.ndim != 1:  # sequence batches
        return batch
    perm = np.lexsort((-key_q, -key_d))
    out = {}
    for k, v in batch.items():
        if k in _BATCH_WIDE or k.endswith(("_uniq", "_sel")):
            out[k] = v
        else:
            out[k] = v[perm]
    return out


def wire_dtype_plan(
    hashed: HashedPairs,
    dedup_unique: int,
    dedup_unique_rows: Optional[int],
) -> Dict[str, bool]:
    """Decide the compressed wire dtypes ONCE from whole-run invariants, so
    every batch of a run ships the same dtypes:

      - inv int16 iff the unique-row slot bound keeps every slot id < 32768;
      - wgt uint8 iff every weight in the corpus is a small non-negative
        integer (the dedupe's keep masks only zero entries).
    """
    slots = (dedup_unique_rows if dedup_unique_rows is not None
             else max(256, dedup_unique // 8))
    u8 = True
    for arr in (hashed.q_wgt, hashed.d_wgt):
        if arr is None or arr.dtype != np.float32:
            u8 = False
            break
        if arr.size and not (
            float(arr.min(initial=0.0)) >= 0.0
            and float(arr.max(initial=0.0)) <= 255.0
            and np.array_equal(arr.astype(np.uint8).astype(np.float32), arr)
        ):
            u8 = False
            break
    return {"inv_int16": slots <= 32768, "wgt_uint8": u8}


def compress_wire(batch: Batch, plan: Optional[Dict[str, bool]] = None) -> Batch:
    """Shrink the host->device format of a dedup batch, losslessly:

      - {q,d}_idx are DROPPED when inv fields exist (the dedup step reads
        only uniq/sel/inv/wgt);
      - {q,d}_inv int32 -> int16 when the unique-row slot count fits;
      - {q,d}_wgt f32 -> uint8 when every weight is a small integral count.

    bridge.batch_to_torch widens them again on the device. `plan`
    (wire_dtype_plan) fixes the dtypes for a whole run; without it they are
    decided per batch."""
    out = dict(batch)
    for side in ("q", "d"):
        if f"{side}_inv" not in out:
            continue
        out.pop(f"{side}_idx", None)
        inv = out[f"{side}_inv"]
        if inv.dtype == np.int32:
            ok = (plan["inv_int16"] if plan is not None
                  else bool(inv.size and inv.max() < 32768))
            if ok:
                out[f"{side}_inv"] = inv.astype(np.int16)
        wgt = out[f"{side}_wgt"]
        if wgt.dtype == np.float32:
            if plan is not None:
                if plan["wgt_uint8"]:
                    out[f"{side}_wgt"] = wgt.astype(np.uint8)
            elif (wgt.size
                    and float(wgt.max(initial=0.0)) <= 255.0
                    and float(wgt.min(initial=0.0)) >= 0.0):
                w8 = wgt.astype(np.uint8)
                if np.array_equal(w8.astype(np.float32), wgt):
                    out[f"{side}_wgt"] = w8
    return out


def batch_iterator(
    hashed: HashedPairs,
    global_batch: int,
    sequence: bool = False,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    drop_remainder: bool = True,
    dedup_unique: Optional[int] = None,
    dedup_group: int = 8,
    dedup_unique_rows: Optional[int] = None,
    dedup_joint: bool = False,
    wire_compress: bool = False,
    sort_rows: bool = False,
    pipeline_workers: int = 0,
    local_sel_cap: int = 0,
    local_sel_shards: int = 1,
    start_batch: int = 0,
    reshuffle_each_epoch: bool = True,
    cache_epoch_batches: bool = False,
) -> Iterator[Batch]:
    """Infinite epoch-shuffled iterator over training batches, with
    dssm_tpu's signature; one process, built serially.

    Each epoch is a seeded permutation of the corpus cut into batches (the
    ragged tail is dropped). start_batch is the DATA CURSOR: the number of
    batches a previous incarnation of the run consumed. The stream
    fast-forwards by index math on the deterministic per-epoch permutation,
    so a resumed run continues the data stream where the checkpoint left it.
    Every train step consumes one batch, so the cursor is TrainState.step.
    """
    if sequence:
        raise NotImplementedError(
            "sequence batches are not ported yet (ROADMAP.md, Queue 1: "
            "cnn/lstm)")
    if process_count != 1 or process_index != 0:
        raise NotImplementedError(
            "multi-host batch shards are not ported yet (ROADMAP.md, "
            "Queue 1: multi-device)")
    if local_sel_cap:
        raise NotImplementedError(
            "per-shard slot spaces (local_sel_cap) are not ported yet "
            "(ROADMAP.md, Queue 1: multi-device)")
    if (pipeline_workers and pipeline_workers > 1) or cache_epoch_batches:
        raise NotImplementedError(
            "the thread-pool batch pipeline and the epoch batch cache are "
            "not ported yet (ROADMAP.md, Queue 1: the pipelined loader)")
    n = len(hashed)
    if global_batch > n:
        raise ValueError(f"global batch {global_batch} > corpus size {n}")
    plan = (wire_dtype_plan(hashed, dedup_unique or 0, dedup_unique_rows)
            if wire_compress else None)
    batches_per_epoch = n // global_batch
    epoch, skip = divmod(max(0, start_batch), batches_per_epoch)
    while True:
        rng = np.random.default_rng(
            (seed, epoch if reshuffle_each_epoch else 0))
        perm = rng.permutation(n)
        for start in range(skip * global_batch, n - global_batch + 1,
                           global_batch):
            out = select_batch(hashed, perm[start:start + global_batch],
                               dedup_unique, dedup_group, dedup_unique_rows,
                               dedup_joint)
            if sort_rows:
                out = sort_batch_rows(out)
            yield compress_wire(out, plan) if wire_compress else out
        epoch += 1
        skip = 0


def prefetch(iterator: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run the host-side batch pipeline in a background thread so it
    overlaps device steps (numpy releases the GIL in its large array
    operations; the pure-Python parts do not overlap)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                q.put(item)
        finally:
            q.put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()
