"""Host-side batch dedupe (numpy): row groups, then exact unique rows.

A batch of short texts touches few DISTINCT trigram rows, so the lookup
gathers those rows once into a compact block and reads every lookup from it:

  host:   uniq_groups[G], row_sel[U2], inv[B, K] = dedupe(idx)
  device: compact  = table rows of each group id        (gather kernel)
          compact2 = compact[row_sel]                    (row select)
          out[b]   = sum_k wgt[b,k] * compact2[inv[b,k]] (count lookup kernel)

A copy of the numpy host half of dssm_tpu/kernels/dedup_embed.py,
bit-identical to it (tests/test_torch_data.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Padding slots in uniq_groups carry this out-of-range group id. The gather
# kernel skips it (no read; the slot's output rows are zero). Chosen so
# sentinel * group + 31 still fits int32 for every row group (<= 32 rows);
# config validation keeps real vocab group ids below it.
SKIP_SENTINEL_GID = np.int32(1 << 25)


def dedupe_indices(
    idx: np.ndarray, u_cap: int, group: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch dedupe at ROW-GROUP granularity (vocab row group = idx // group;
    the within-group offset idx % group folds into the compact row index).

    idx: int32 [...]. Returns:
      uniq_groups [u_cap // group] int32 — GROUP ids; compact row j corresponds
          to vocab row uniq_groups[j // group]*group + j%group. Real slots are
          a sorted strictly increasing prefix; padding slots carry
          SKIP_SENTINEL_GID.
      inv  same shape as idx, int32 in [0, u_cap) — compact row per lookup
      keep_mask same shape, f32 — 0 where a lookup's group was dropped
          (overflow: rarest groups dropped; caller zeroes those weights)
    """
    if u_cap % group:
        raise ValueError(f"u_cap {u_cap} not divisible by group {group}")
    g_cap = u_cap // group
    flat = idx.reshape(-1)
    gids = flat // group
    uniq_g, inv_g = np.unique(gids, return_inverse=True)
    n = uniq_g.shape[0]
    if n > g_cap:
        counts = np.bincount(inv_g, minlength=n)
        keep = np.argsort(-counts, kind="stable")[:g_cap]
        keep.sort()
        remap = np.full((n,), -1, dtype=np.int64)
        remap[keep] = np.arange(g_cap)
        new_inv_g = remap[inv_g]
        mask = (new_inv_g >= 0).astype(np.float32)
        new_inv_g = np.where(new_inv_g >= 0, new_inv_g, 0)
        uniq_out = uniq_g[keep].astype(np.int32)
        pad = np.zeros((0,), dtype=np.int32)
    else:
        mask = np.ones_like(flat, dtype=np.float32)
        new_inv_g = inv_g
        uniq_out = uniq_g.astype(np.int32)
        pad = np.full((g_cap - n,), SKIP_SENTINEL_GID, dtype=np.int32)
    inv = new_inv_g * group + (flat % group)
    return (
        np.concatenate([uniq_out, pad]),
        inv.reshape(idx.shape).astype(np.int32),
        mask.reshape(idx.shape),
    )


def dedupe_two_level(
    idx: np.ndarray, g_cap_rows: int, u2_cap: int, group: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two-level dedupe: row GROUPS for the gather, then exact unique ROWS,
    so the lookup reads U2 rows instead of the group-diluted compact block.

    Returns:
      uniq_groups [g_cap_rows // group] int32 — as dedupe_indices
      row_sel     [u2_cap] int32 — compact-row index of each unique vocab row
                  (padded with 0)
      inv2        same shape as idx, int32 in [0, u2_cap) — unique-row slot
                  per lookup
      keep_mask   same shape, f32 — 0 where a lookup overflowed either cap
    """
    uniq_groups, inv, keep = dedupe_indices(idx, g_cap_rows, group)
    flat_inv = inv.reshape(-1)
    flat_keep = keep.reshape(-1)
    # Unique over kept compact-row ids only.
    kept_rows = flat_inv[flat_keep > 0]
    uniq_rows, _ = np.unique(kept_rows, return_inverse=True)
    n = uniq_rows.shape[0]
    if n > u2_cap:
        counts = np.bincount(
            np.searchsorted(uniq_rows, kept_rows), minlength=n
        )
        keep_idx = np.argsort(-counts, kind="stable")[:u2_cap]
        keep_idx.sort()
        uniq_rows = uniq_rows[keep_idx]
        n = u2_cap
    # Map every lookup's compact-row id to its slot (or drop).
    pos = np.searchsorted(uniq_rows, flat_inv)
    pos = np.clip(pos, 0, n - 1)
    hit = (uniq_rows[pos] == flat_inv) & (flat_keep > 0)
    inv2 = np.where(hit, pos, 0).astype(np.int32)
    keep2 = hit.astype(np.float32)
    row_sel = np.zeros((u2_cap,), dtype=np.int32)
    row_sel[:n] = uniq_rows
    return (
        uniq_groups,
        row_sel,
        inv2.reshape(idx.shape),
        keep2.reshape(idx.shape),
    )


def dedupe_two_level_joint(
    q_idx: np.ndarray, d_idx: np.ndarray, g_cap_rows: int, u2_cap: int,
    group: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray]:
    """UNION two-level dedupe over both sides' indices, for SHARED-table
    towers: one compact gather and one row selection serve both towers.

    Returns (uniq_groups [G], row_sel [u2], q_inv, d_inv, q_keep, d_keep).
    """
    nq = q_idx.size
    both = np.concatenate([q_idx.reshape(-1), d_idx.reshape(-1)])
    uniq_groups, row_sel, inv2, keep = dedupe_two_level(
        both, g_cap_rows, u2_cap, group)
    return (
        uniq_groups,
        row_sel,
        inv2[:nq].reshape(q_idx.shape),
        inv2[nq:].reshape(d_idx.shape),
        keep[:nq].reshape(q_idx.shape),
        keep[nq:].reshape(d_idx.shape),
    )
