"""Deduplicated embedding lookup: compact gather, row select, count lookup.

Device half of dssm_tpu/kernels/dedup_embed.py (the host half is
data/dedupe.py):

  compact  = gather_row_groups(table, uniq_groups)       (kernel)
             (an int8 table's compact is dequantized against the per-row
             scale here: dequant_compact)
  compact2 = compact[row_sel], cast to the compute dtype (exact selection)
  out      = count_lookup(compact2, inv, wgt)            (kernel)

With the joint batch layout (`uniq`/`sel`, shared table) both towers read
one compact block; with the per-side layout each side has its own
`{q,d}_uniq`/`_sel`. Each lookup here is differentiable in `compact` (the
kernels' backward kernels): the per-side training step differentiates at
the compact blocks. The joint step differentiates at the lookup outputs
instead, and on an f32 or bf16 table runs the gather and the joint lookup
as one fused kernel (kernels/joint.py::fused_gather_joint_lookup).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dssm_tpu_torch.kernels.count import count_lookup
from dssm_tpu_torch.kernels.gather import (  # noqa: F401
    expand_group_rows, gather_row_groups)
from dssm_tpu_torch.kernels.joint import joint_lookup, select_rows_plain



def gather_compact(table: torch.Tensor, uniq_groups: torch.Tensor,
                   group: int = 8, *, impl: str = "auto") -> torch.Tensor:
    """compact [G*group, H] = the table rows of each unique group (the
    gather kernel). Inside a sharded context the table is this rank's
    shard: each model rank gathers the groups it owns and the partial
    blocks are summed over the model group (kernels/sharded_embed.py)."""
    from dssm_tpu_torch.kernels import sharded_embed

    ctx = sharded_embed.current_context()
    if ctx is not None:
        mesh, _, coll = ctx
        return sharded_embed.gather_compact_sharded(
            table, uniq_groups, group, mesh, impl=impl, collective_dtype=coll)
    return gather_row_groups(table, uniq_groups, group, impl=impl)


def select_rows(compact: torch.Tensor, row_sel: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """compact2 [u2, H] = compact[row_sel] in the compute dtype: the exact
    selection dssm_tpu forms as a one-hot matmul."""
    return select_rows_plain(compact.to(compute_dtype), row_sel)


def lookup_from_compact(
    compact: torch.Tensor,
    inv: torch.Tensor,
    wgt: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    row_sel: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """out[...] = sum_k wgt[..., k] * compact2[inv[..., k]], f32.

    With row_sel (two-level dedupe) inv indexes the U2 unique-row slots of
    compact2 = compact[row_sel]; without it, the compact rows themselves.
    Weights are rounded to the compute dtype first, as dssm_tpu rounds them.
    """
    inv = inv.to(torch.int32).contiguous()
    wgt = wgt.to(compute_dtype).float().contiguous()
    if row_sel is not None:
        compact2 = select_rows(compact, row_sel, compute_dtype)
    else:
        compact2 = compact.to(compute_dtype)
    return count_lookup(compact2.contiguous(), inv, wgt, impl=impl)


def joint_lookup_from_compact(
    compact: torch.Tensor,
    row_sel: torch.Tensor,
    q_inv: torch.Tensor,
    q_wgt: torch.Tensor,
    d_inv: torch.Tensor,
    d_wgt: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union-dedupe lookup for BOTH towers from one compact block, outputs
    in the compute dtype.

    One kernel does the row selection and both sides' lookups. It follows
    dssm_tpu's fused Pallas kernel: compact rows and weights meet in
    compact's own dtype (f32 for an f32 table) and only the outputs are
    cast. dssm_tpu's XLA fallback rounds compact to the compute dtype first,
    so under bf16 compute the two differ by one bf16 rounding of each row.
    """
    lq, ld = joint_lookup(
        compact, row_sel.to(torch.int32).contiguous(),
        q_inv.to(torch.int32).contiguous(), q_wgt.float().contiguous(),
        d_inv.to(torch.int32).contiguous(), d_wgt.float().contiguous(),
        impl=impl)
    return lq.to(compute_dtype), ld.to(compute_dtype)


def gather_scale_rows(scale: torch.Tensor, uniq_groups: torch.Tensor,
                      group: int) -> torch.Tensor:
    """Per-row scales of the compact block, [G*group, 1] f32, from the
    [V, 1] scale parameter; out-of-range slots take scale 0."""
    v = scale.shape[0]
    sg = scale.reshape(v // group, group)
    gids = uniq_groups.long()
    valid = (gids >= 0) & (gids < v // group)
    sc = sg.index_select(0, torch.where(valid, gids, 0))
    return (sc * valid[:, None].to(sc.dtype)).reshape(-1, 1)


def dequant_compact(compact: torch.Tensor, scale: torch.Tensor,
                    uniq_groups: torch.Tensor, group: int) -> torch.Tensor:
    """int8 compact rows -> f32 against the [V, 1] per-row scale parameter
    (sentinel rows take scale 0: exact zero rows)."""
    return compact.float() * gather_scale_rows(scale, uniq_groups, group)


def dedup_embedding_bag(
    table: torch.Tensor,
    uniq_groups: torch.Tensor,
    inv: torch.Tensor,
    wgt: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    group: int = 8,
    impl: str = "auto",
    row_sel: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full forward: gather the compact row groups (dequantized for an int8
    table), then the count lookup."""
    compact = gather_compact(table, uniq_groups, group, impl=impl)
    if scale is not None:
        compact = dequant_compact(compact, scale, uniq_groups, group)
    return lookup_from_compact(compact, inv, wgt, compute_dtype, row_sel,
                               impl=impl)
