"""Host-side input pipeline: hash once, then batch by array slicing.

The corpus is hashed once into fixed-length numpy arrays (data/trigram.py);
a batch is a slice of them plus the per-batch dedupe fields the lookup
kernels take (data/dedupe.py). The sequence towers (cnn, lstm) take the
per-word fields [N, T, Kw] plus a word mask [N, T] in place of the bag
fields (select_batch(sequence=True)). Batches stay numpy here;
bridge.batch_to_torch moves them to the device. Hashing and the dedupe run
on the C++ host data plane (data/native.py), which releases the GIL, so
batch_iterator's and eval_batches' thread pools (pipeline_workers) build
several batches at once, handed back in order: bit-identical to the serial
path. A copy of dssm_tpu/data/loader.py, bit-identical to it
(tests/test_torch_data.py, tests/test_torch_pipeline.py,
tests/test_torch_parallel.py), with its process shards (a batch's rows cut
into contiguous shards, the dedupe over the whole batch) and its per-shard
slot spaces (reslot_local).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Iterator, Optional

import numpy as np

from dssm_tpu_torch.config import DataConfig, TowerConfig
from dssm_tpu_torch.data import trigram
from dssm_tpu_torch.data.dedupe import dedupe_two_level, dedupe_two_level_joint
from dssm_tpu_torch.data.toy import ToyPairs

Batch = Dict[str, np.ndarray]

# Dedupe fields that describe the whole batch rather than one row each.
_BATCH_WIDE = ("uniq", "sel", "sel_local")


@dataclass
class HashedPairs:
    """Whole corpus, pre-hashed. Bag fields always present; sequence fields
    only for cnn/lstm towers."""

    q_idx: np.ndarray  # [N, K] int32
    q_wgt: np.ndarray  # [N, K] f32
    d_idx: np.ndarray
    d_wgt: np.ndarray
    q_seq_idx: Optional[np.ndarray] = None  # [N, T, Kw]
    q_seq_wgt: Optional[np.ndarray] = None
    q_mask: Optional[np.ndarray] = None  # [N, T]
    d_seq_idx: Optional[np.ndarray] = None
    d_seq_wgt: Optional[np.ndarray] = None
    d_mask: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.q_idx.shape[0]


def hash_pairs(pairs: ToyPairs, tower: TowerConfig, data: DataConfig) -> HashedPairs:
    """Both sides of every pair as bag fields and, for a sequence tower,
    as per-word fields too (each text is hashed twice, as in dssm_tpu)."""
    kq = data.max_trigrams_query or data.max_trigrams
    q_idx, q_wgt = trigram.hash_batch(
        pairs.queries, tower.vocab_size, kq, data.normalize_counts
    )
    d_idx, d_wgt = trigram.hash_batch(
        pairs.titles, tower.vocab_size, data.max_trigrams, data.normalize_counts
    )
    out = HashedPairs(q_idx=q_idx, q_wgt=q_wgt, d_idx=d_idx, d_wgt=d_wgt)
    if tower.is_sequence_model:
        out.q_seq_idx, out.q_seq_wgt, out.q_mask = trigram.hash_batch_sequence(
            pairs.queries, tower.vocab_size, data.max_words,
            data.max_trigrams_per_word, data.normalize_counts)
        out.d_seq_idx, out.d_seq_wgt, out.d_mask = trigram.hash_batch_sequence(
            pairs.titles, tower.vocab_size, data.max_words,
            data.max_trigrams_per_word, data.normalize_counts)
    return out


def add_dedup_fields(batch: Batch, max_unique: int, group: int = 8,
                     max_unique_rows: Optional[int] = None,
                     joint: bool = False, impl: str = "auto") -> Batch:
    """Per-batch two-level index dedupe for the compact-gather lookup.
    Dropped-overflow lookups get their weights zeroed. `group` is the row
    group of the table dtype (8 f32 / 16 bf16).

    joint=False (separate tower tables): adds {q,d}_uniq (row-GROUP ids),
    {q,d}_sel (unique-row slots), {q,d}_inv (slot per lookup).
    joint=True (SHARED table): one UNION dedupe over both sides, adding
    `uniq`, `sel`, and per-side {q,d}_inv.

    max_unique is a compact-row budget at f32 (8-row-group) granularity: the
    GROUP-SLOT budget max_unique // 8 stays constant across table dtypes.
    impl picks the dedupe's C++ ("auto") or numpy ("plain") version.
    """
    if max_unique_rows is None:
        max_unique_rows = max(256, max_unique // 8)
    max_unique = (max_unique // 8) * group
    out = dict(batch)
    if joint:
        uniq, sel, q_inv, d_inv, q_keep, d_keep = dedupe_two_level_joint(
            batch["q_idx"], batch["d_idx"], max_unique, max_unique_rows,
            group, impl,
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
            batch[f"{side}_idx"], max_unique, max_unique_rows, group, impl
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
    *,
    sequence: bool = False,
    impl: str = "auto",
) -> Batch:
    """The batch of corpus rows `rows`: the bag fields, or with sequence
    the per-word fields and word masks under the same names ({q,d}_idx /
    _wgt [B, T, Kw], {q,d}_mask [B, T]); then the dedupe fields (impl:
    add_dedup_fields')."""
    if sequence:
        batch = {
            "q_idx": hashed.q_seq_idx[rows],
            "q_wgt": hashed.q_seq_wgt[rows],
            "q_mask": hashed.q_mask[rows],
            "d_idx": hashed.d_seq_idx[rows],
            "d_wgt": hashed.d_seq_wgt[rows],
            "d_mask": hashed.d_mask[rows],
        }
    else:
        batch = {
            "q_idx": hashed.q_idx[rows],
            "q_wgt": hashed.q_wgt[rows],
            "d_idx": hashed.d_idx[rows],
            "d_wgt": hashed.d_wgt[rows],
        }
    if dedup_unique:
        batch = add_dedup_fields(batch, dedup_unique, dedup_group,
                                 dedup_unique_rows, dedup_joint, impl)
    return batch


def eval_batches(
    hashed: HashedPairs, batch: int,
    dedup_unique: Optional[int] = None, dedup_group: int = 8,
    dedup_unique_rows: Optional[int] = None,
    dedup_joint: bool = False,
    wire_compress: bool = False,
    *,
    sequence: bool = False,
    pipeline_workers: int = 0,
    impl: str = "auto",
) -> Iterator[Batch]:
    """One pass over the corpus in order, including the ragged tail
    (sequence: the per-word fields, as select_batch).
    wire_compress shrinks the host->device fields exactly as in training
    (the embed path reads inv/wgt, so idx is dead weight), with one dtype
    plan for the whole pass. pipeline_workers > 1 builds the batches on a
    thread pool, handed back in order (bit-identical to the serial pass)."""
    n = len(hashed)
    plan = (wire_dtype_plan(hashed, dedup_unique or 0, dedup_unique_rows)
            if wire_compress else None)

    def make(start: int) -> Batch:
        rows = np.arange(start, min(start + batch, n))
        out = select_batch(hashed, rows, dedup_unique, dedup_group,
                           dedup_unique_rows, dedup_joint, sequence=sequence,
                           impl=impl)
        return compress_wire(out, plan) if wire_compress else out

    yield from map_in_order(make, ((s, s) for s in range(0, n, batch)),
                            pipeline_workers)


def _global_dedup_local_batch(
    hashed: HashedPairs,
    rows: np.ndarray,
    sequence: bool,
    dedup_unique: int,
    dedup_group: int,
    dedup_unique_rows: Optional[int],
    dedup_joint: bool,
    lo: int,
    local: int,
    impl: str = "auto",
) -> Batch:
    """One process's shard, rows [lo, lo + local) of the batch of corpus
    rows `rows`, with the dedupe fields of the WHOLE batch: the dedupe sees
    every row's indices, so `uniq` / `sel` (or {q,d}_uniq / _sel) are the
    same in every process, while the weights, masks and slots are sliced to
    the shard. Bit-identical to select_batch of the whole batch, sliced."""
    if sequence:
        q_idx_g, d_idx_g = hashed.q_seq_idx[rows], hashed.d_seq_idx[rows]
    else:
        q_idx_g, d_idx_g = hashed.q_idx[rows], hashed.d_idx[rows]
    if dedup_unique_rows is None:
        dedup_unique_rows = max(256, dedup_unique // 8)
    max_u = (dedup_unique // 8) * dedup_group
    sl = slice(lo, lo + local)
    loc = rows[sl]
    out: Batch = {"q_idx": q_idx_g[sl], "d_idx": d_idx_g[sl]}
    if sequence:
        out["q_wgt"] = hashed.q_seq_wgt[loc]
        out["d_wgt"] = hashed.d_seq_wgt[loc]
        out["q_mask"] = hashed.q_mask[loc]
        out["d_mask"] = hashed.d_mask[loc]
    else:
        out["q_wgt"] = hashed.q_wgt[loc]
        out["d_wgt"] = hashed.d_wgt[loc]
    if dedup_joint:
        uniq, sel, q_inv, d_inv, q_keep, d_keep = dedupe_two_level_joint(
            q_idx_g, d_idx_g, max_u, dedup_unique_rows, dedup_group, impl)
        out["uniq"], out["sel"] = uniq, sel
        out["q_inv"], out["d_inv"] = q_inv[sl], d_inv[sl]
        keeps = {"q": q_keep, "d": d_keep}
    else:
        keeps = {}
        for side, idx_g in (("q", q_idx_g), ("d", d_idx_g)):
            uniq, sel, inv, keep = dedupe_two_level(
                idx_g, max_u, dedup_unique_rows, dedup_group, impl)
            out[f"{side}_uniq"] = uniq
            out[f"{side}_sel"] = sel
            out[f"{side}_inv"] = inv[sl]
            keeps[side] = keep
    for side, keep in keeps.items():
        kl = keep[sl]
        if not np.all(kl == 1.0):
            out[f"{side}_wgt"] = out[f"{side}_wgt"] * kl
    return out


def reslot_local(batch: Batch, cap: int, shards: int = 1) -> Batch:
    """Third dedupe level: each data shard's lookups re-slotted into a slot
    space of its own, `cap` wide, so a shard's lookup reads `cap` rows
    instead of the whole batch's unique-row width.

    The batch's rows are cut into `shards` contiguous blocks (a mesh's
    data shards). Adds `sel_local` [shards, cap]: sel_local[s, j] is the
    slot of `sel` (a global unique-row slot) that shard s's local slot j
    holds; rewrites {q,d}_inv into local slots. A shard's slots are its
    used global slots in increasing order; past `cap`, the most used are
    kept (ties to the lower slot) and the others' lookups get weight 0.
    `sel` is kept: the step selects each shard's rows from compact[sel]."""
    sel = batch["sel"]
    out = dict(batch)
    b = batch["q_inv"].shape[0]
    if b % shards:
        raise ValueError(f"batch {b} not divisible by {shards} shards")
    rows_per = b // shards
    sel_local = np.zeros((shards, cap), dtype=sel.dtype)
    q_inv = np.ascontiguousarray(batch["q_inv"]).copy()
    d_inv = np.ascontiguousarray(batch["d_inv"]).copy()
    q_wgt = np.array(batch["q_wgt"], copy=True)
    d_wgt = np.array(batch["d_wgt"], copy=True)
    for s in range(shards):
        sl = slice(s * rows_per, (s + 1) * rows_per)
        qi, di = q_inv[sl], d_inv[sl]
        qw, dw = q_wgt[sl], d_wgt[sl]
        both = np.concatenate([qi.reshape(-1), di.reshape(-1)])
        live = np.concatenate([(qw != 0).reshape(-1), (dw != 0).reshape(-1)])
        used, counts = np.unique(both[live], return_counts=True)
        if used.size > cap:
            keep = np.argsort(-counts, kind="stable")[:cap]
            keep.sort()
            used = used[keep]
        remap = np.zeros((int(sel.shape[0]),), dtype=np.int32)
        hit = np.zeros((int(sel.shape[0]),), dtype=bool)
        remap[used] = np.arange(used.size, dtype=np.int32)
        hit[used] = True
        sel_local[s, :used.size] = used
        for inv, wgt in ((qi, qw), (di, dw)):
            ok = hit[inv]
            wgt[~ok] = 0
            inv[...] = np.where(ok, remap[inv], 0)
    out["sel_local"] = sel_local
    out["q_inv"], out["d_inv"] = q_inv, d_inv
    out["q_wgt"], out["d_wgt"] = q_wgt, d_wgt
    return out


def pad_batch(batch: Batch, to_rows: int) -> Batch:
    """Pad every per-row field ({q,d}_mask too) to `to_rows` rows by
    repeating row 0 (the padded rows' outputs are sliced off afterwards).
    The batch-wide dedupe
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


class OrderedPool:
    """Builds jobs on a pool of threads and hands their results back in the
    order they were submitted.

    With a cache (a dict, key -> future), the jobs submitted under one key
    share one build, also when a job is submitted again before its first
    build has finished (an epoch shorter than the jobs in flight). A build
    that raised is evicted, so a later submit of its key builds it again
    (dssm_tpu's fut_memo keeps it and raises it on every later submit).
    """

    def __init__(self, fn: Callable[[Any], Any], workers: int,
                 cache: Optional[Dict[Hashable, Future]] = None):
        self._fn = fn
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._queue: "deque" = deque()  # (key, future), submission order
        self._cache = cache

    def __len__(self) -> int:
        return len(self._queue)

    @staticmethod
    def _failed(f: Future) -> bool:
        return f.done() and not f.cancelled() and f.exception() is not None

    def submit(self, key: Hashable, job: Any) -> None:
        f = None if self._cache is None else self._cache.get(key)
        if f is None or self._failed(f):
            f = self._pool.submit(self._fn, job)
            if self._cache is not None:
                self._cache[key] = f
        self._queue.append((key, f))

    def next(self) -> Any:
        """The oldest job's result; raises what its build raised."""
        key, f = self._queue.popleft()
        try:
            return f.result()
        finally:
            if (self._cache is not None and self._cache.get(key) is f
                    and self._failed(f)):
                del self._cache[key]

    def close(self) -> None:
        """Drop the jobs not started, without waiting for those running."""
        self._pool.shutdown(wait=False, cancel_futures=True)


def map_in_order(fn: Callable[[Any], Any], jobs: Iterator, workers: int,
                 cache: Optional[Dict[Hashable, Any]] = None) -> Iterator:
    """fn(job) for each (key, job) of `jobs`, in order: serially when
    workers <= 1, else on an OrderedPool of `workers` threads kept
    workers + 1 jobs ahead of the consumer, as dssm_tpu's pools are. With a
    cache, a key built once is not built again: the cache holds its result
    (serially) or its future (on the pool), and keeps no build that raised.
    Closing the generator drops the jobs not started without waiting for
    the running ones."""
    if workers <= 1:
        for key, job in jobs:
            if cache is None:
                yield fn(job)
                continue
            if key not in cache:
                cache[key] = fn(job)
            yield cache[key]
        return
    pool = OrderedPool(fn, workers, cache)
    try:
        for key, job in jobs:
            pool.submit(key, job)
            if len(pool) > workers + 1:
                yield pool.next()
        while len(pool):
            yield pool.next()
    finally:
        pool.close()


class LockedIterator:
    """One iterator shared by several threads: each next() is serialized,
    so each item goes to exactly one caller (in no fixed order across the
    callers). A bare generator raises "generator already executing" when
    two threads call next() at once."""

    def __init__(self, iterator):
        self._it = iter(iterator)
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            return next(self._it)


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
    *,
    impl: str = "auto",
) -> Iterator[Batch]:
    """Infinite epoch-shuffled iterator over one process's shards of the
    training batches, with dssm_tpu's signature.

    Each epoch is a seeded permutation of the corpus cut into batches of
    global_batch rows (the ragged tail is dropped); every process computes
    the same permutation and takes its contiguous shard, rows
    [process_index * B_local, (process_index + 1) * B_local) of each batch.
    With dedupe and process_count > 1 the dedupe runs over the whole batch,
    so the batch-wide fields (`uniq`, `sel`, ...) are the same in every
    process (_global_dedup_local_batch). local_sel_cap > 0 adds the third
    dedupe level to a joint batch: local_sel_shards slot spaces of that
    width over the process's shard (reslot_local), after the row sort. start_batch is the DATA CURSOR: the number of
    batches a previous incarnation of the run consumed. The stream
    fast-forwards by index math on the deterministic per-epoch permutation,
    so a resumed run continues the data stream where the checkpoint left it.
    Every train step consumes one batch, so the cursor is TrainState.step.

    pipeline_workers > 1 builds each batch (slice, dedupe, sort, compress)
    on a pool of that many threads, pipeline_workers + 1 batches ahead, and
    hands them back in order: bit-identical to the serial stream. The C++
    dedupe releases the GIL, so the builds run side by side.

    reshuffle_each_epoch=False replays the (seed, 0) permutation every
    epoch; with cache_epoch_batches=True the finished batches are kept by
    in-epoch index as the first epoch builds them and handed out again
    after, so a later epoch costs a dict lookup a batch. Cached batches are
    shared objects: consumers treat batches as read-only (the train step,
    batch_to_torch and add_rotation_offsets do). impl picks the dedupe's
    C++ ("auto") or numpy ("plain") version.
    """
    if global_batch % process_count != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {process_count} "
            "processes")
    local = global_batch // process_count
    if cache_epoch_batches and reshuffle_each_epoch:
        raise ValueError("cache_epoch_batches requires "
                         "reshuffle_each_epoch=False: a reshuffled epoch is "
                         "not the cached one")
    n = len(hashed)
    if global_batch > n:
        raise ValueError(f"global batch {global_batch} > corpus size {n}")
    plan = (wire_dtype_plan(hashed, dedup_unique or 0, dedup_unique_rows)
            if wire_compress else None)

    def jobs() -> Iterator:
        """(in-epoch batch index, rows) from the cursor on, forever."""
        batches_per_epoch = n // global_batch
        epoch, skip = divmod(max(0, start_batch), batches_per_epoch)
        while True:
            rng = np.random.default_rng(
                (seed, epoch if reshuffle_each_epoch else 0))
            perm = rng.permutation(n)
            for bi in range(skip, batches_per_epoch):
                yield bi, perm[bi * global_batch:(bi + 1) * global_batch]
            epoch += 1
            skip = 0

    def make(job) -> Batch:
        _, rows = job
        if dedup_unique and process_count > 1:
            out = _global_dedup_local_batch(
                hashed, rows, sequence, dedup_unique, dedup_group,
                dedup_unique_rows, dedup_joint, process_index * local, local,
                impl)
        else:
            shard = rows[process_index * local:(process_index + 1) * local]
            out = select_batch(hashed, shard, dedup_unique, dedup_group,
                               dedup_unique_rows, dedup_joint,
                               sequence=sequence, impl=impl)
        if sort_rows:
            out = sort_batch_rows(out)
        if local_sel_cap and "sel" in out:
            out = reslot_local(out, local_sel_cap, local_sel_shards)
        if wire_compress:
            out = compress_wire(out, plan)
        return out

    # The epoch batch cache, by in-epoch batch index.
    yield from map_in_order(make, ((job[0], job) for job in jobs()),
                            pipeline_workers,
                            cache={} if cache_epoch_batches else None)


class _Raised:
    """An exception the prefetch thread's source raised, for the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


def prefetch(iterator: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run the host-side batch pipeline in a background thread so it
    overlaps device steps, at most `depth` batches ahead. An exception the
    pipeline raises is raised to the consumer, after the batches before
    it; closing the consumer stops the thread (and drops its source)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        last = end
        try:
            for item in iterator:
                if not put(item):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            last = _Raised(e)
        finally:
            put(last)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        stop.set()
