"""Frequency-ordered vocab remap: cluster hot trigram rows into row groups.

FNV-hashed trigram ids are uniformly random over the table, so a batch's
unique rows land in nearly as many distinct row groups as there are rows.
Remapping ids by corpus frequency rank packs the hot rows into a dense
prefix of the table, so the rows a batch touches collapse into far fewer
groups (the `full` preset's 256 gather slots are sized for remapped ids).
A pure permutation of table rows: the model's math is unchanged.

`num_shards` stripes rank r to shard r % S at slot r // S, so a
vocab-sharded table gives every shard its own dense hot prefix.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dssm_tpu_torch.data.loader import HashedPairs

PAD_INDEX = 0  # data/trigram.py reserves row 0 for padding

# The remap is part of the trained model: table rows live at remapped
# positions, so serving must push inputs through the SAME permutation.
# Training persists it next to the checkpoints under this name.
REMAP_FILE = "vocab_remap.npy"


def save_remap(workdir: str, remap: np.ndarray) -> str:
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, REMAP_FILE)
    np.save(path, remap.astype(np.int32))
    return path


def load_remap(workdir: str) -> Optional[np.ndarray]:
    """The remap saved by training, or None if the run never built one."""
    path = os.path.join(workdir, REMAP_FILE)
    if not os.path.exists(path):
        return None
    return np.load(path)


def build_freq_remap(
    hashed: HashedPairs, vocab_size: int, num_shards: int = 1
) -> np.ndarray:
    """remap [vocab_size] int32: old id -> new id, frequency-ranked.

    Rank ids by (occurrence count desc, id asc) over the hashed corpus
    (occurrences = slots with nonzero weight, both sides). PAD_INDEX stays
    fixed at 0. Unseen ids follow the ranked ones in id order (deterministic:
    the same corpus always yields the same permutation).
    """
    counts = np.zeros((vocab_size,), dtype=np.int64)
    for idx, wgt in ((hashed.q_idx, hashed.q_wgt), (hashed.d_idx, hashed.d_wgt)):
        flat = idx.reshape(-1)[wgt.reshape(-1) > 0]
        counts += np.bincount(flat, minlength=vocab_size)
    counts[PAD_INDEX] = 0
    # Stable argsort of -counts: count desc, id asc. PAD excluded then
    # reinserted at position 0.
    order = np.argsort(-counts, kind="stable")
    order = order[order != PAD_INDEX]
    v = vocab_size
    if num_shards > 1:
        if v % num_shards:
            raise ValueError(f"vocab {v} not divisible by {num_shards} shards")
        per = v // num_shards
        ranks = np.arange(v, dtype=np.int64)
        dests = (ranks % num_shards) * per + ranks // num_shards
    else:
        dests = np.arange(v, dtype=np.int64)
    dests = dests[dests != PAD_INDEX]
    remap = np.empty((v,), dtype=np.int32)
    remap[PAD_INDEX] = PAD_INDEX
    remap[order] = dests[: order.shape[0]].astype(np.int32)
    return remap


def apply_remap(hashed: HashedPairs, remap: np.ndarray) -> HashedPairs:
    """New HashedPairs with every index field mapped through `remap`."""
    return HashedPairs(
        q_idx=remap[hashed.q_idx],
        q_wgt=hashed.q_wgt,
        d_idx=remap[hashed.d_idx],
        d_wgt=hashed.d_wgt,
    )
