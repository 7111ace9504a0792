"""Host-side input pipeline: hash once, then batch by array slicing.

The corpus is hashed once into fixed-length numpy arrays (data/trigram.py);
a batch is a slice of them plus the per-batch dedupe fields the lookup
kernels take (data/dedupe.py). Batches stay numpy here; bridge.batch_to_torch
moves them to the device. A copy of the serving half of
dssm_tpu/data/loader.py, bit-identical to it (tests/test_torch_data.py).
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
