"""Row-group gather and scatter-add between the table and a compact block.

gather_row_groups: compact[G*group, H] = the table rows of each group id.
Counterpart of dssm_tpu/kernels/pallas_gather.py::gather_row_groups; the
CUDA kernel is csrc/gather.cu. Slots whose group id is out of range (the
dedupe's SKIP_SENTINEL_GID padding) read nothing and come back as zero rows.

scatter_add_row_groups: the table rows of each group id += the slot's rows
of vals, IN PLACE on the table tensor (the reference returns a new array
aliased onto its donated input). Counterpart of pallas_gather.py::
scatter_add_row_groups; the CUDA kernels are in csrc/scatter.cu: f32, and
bf16 rounded to nearest for a bf16 table trained without stochastic
rounding. Out-of-range slots are skipped. Real group ids must be distinct
wherever vals is nonzero, as the dedupe makes them.
"""

from __future__ import annotations

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "gather_row_groups"
_SCATTER = "scatter_add_row_groups"


def sublane_group(dtype: torch.dtype) -> int:
    """Rows per gather group for a table dtype: 8 f32, 16 bf16, 32 int8 —
    the dedupe's granularity, kept so both packages take identical batches."""
    size = torch.empty((), dtype=dtype).element_size()
    if size not in (4, 2, 1):
        raise ValueError(f"unsupported table dtype {dtype}")
    return {4: 8, 2: 16, 1: 32}[size]


def gather_row_groups_plain(table: torch.Tensor, gids: torch.Tensor,
                            group: int) -> torch.Tensor:
    """Plain PyTorch version: index_select of the expanded rows, then the
    out-of-range slots zeroed."""
    v, h = table.shape
    if v % group:
        raise ValueError(f"vocab {v} not divisible by group {group}")
    gids = gids.long()
    valid = (gids >= 0) & (gids < v // group)
    rows = (torch.where(valid, gids, 0)[:, None] * group
            + torch.arange(group, device=gids.device)).reshape(-1)
    out = table.index_select(0, rows)
    return out.masked_fill_(~valid.repeat_interleave(group)[:, None], 0)


def gather_row_groups(table: torch.Tensor, gids: torch.Tensor, group: int,
                      *, impl: str = "auto") -> torch.Tensor:
    """table [V, H], gids [G] int32 -> [G*group, H] (table's dtype)."""
    if _build.resolve_impl(impl, table, _NAME) == "plain":
        return gather_row_groups_plain(table, gids, group)
    v, h = table.shape
    if v % group:
        raise ValueError(f"vocab {v} not divisible by group {group}")
    if gids.dtype != torch.int32 or gids.dim() != 1:
        raise ValueError(f"{_NAME}: gids must be 1-D int32, got "
                         f"{gids.dtype} {tuple(gids.shape)}")
    _build.check_cuda(_NAME, table.device, table, gids)
    group_bytes = group * h * table.element_size()
    if group_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{_NAME}: a row group must be a whole number of "
                         f"16-byte vectors ({group_bytes} bytes)")
    g = gids.shape[0]
    if g * group_bytes >= 1 << 35:
        raise ValueError(f"{_NAME}: the kernel writes under 2^31 16-byte "
                         f"vectors; {g} slots of {group_bytes} bytes")
    out = torch.empty((g * group, h), dtype=table.dtype, device=table.device)
    if g == 0:
        return out
    _build.launch(_NAME, "dssm_gather_row_groups", table.device,
                  table.data_ptr(), gids.data_ptr(), out.data_ptr(), g,
                  v // group, group_bytes)
    return out


def expand_group_rows(gids: torch.Tensor, group: int) -> torch.Tensor:
    """GROUP ids [G] -> vocab row ids [G * group] int64 (compact row order)."""
    offs = torch.arange(group, device=gids.device)
    return (gids.long()[:, None] * group + offs[None, :]).reshape(-1)


def scatter_add_row_groups_plain(table: torch.Tensor, gids: torch.Tensor,
                                 vals: torch.Tensor, group: int) -> torch.Tensor:
    """Plain PyTorch version: index_add_ of the in-range slots' rows."""
    v, h = table.shape
    if v % group:
        raise ValueError(f"vocab {v} not divisible by group {group}")
    gids = gids.long()
    valid = (gids >= 0) & (gids < v // group)
    rows = expand_group_rows(torch.where(valid, gids, 0), group)
    keep = valid.repeat_interleave(group)[:, None].to(table.dtype)
    return table.index_add_(0, rows, vals.to(table.dtype) * keep)


def scatter_add_row_groups(table: torch.Tensor, gids: torch.Tensor,
                           vals: torch.Tensor, group: int, *,
                           impl: str = "auto") -> torch.Tensor:
    """table [V, H] f32 or bf16 updated in place and returned; gids [G]
    int32; vals [G*group, H] of the table's dtype (a bf16 sum is rounded to
    nearest, as a bf16 add is)."""
    if _build.resolve_impl(impl, table, _SCATTER) == "plain":
        return scatter_add_row_groups_plain(table, gids, vals, group)
    v, h = table.shape
    if v % group:
        raise ValueError(f"vocab {v} not divisible by group {group}")
    if (table.dtype not in (torch.float32, torch.bfloat16)
            or vals.dtype != table.dtype):
        raise ValueError(f"{_SCATTER}: the kernel adds f32 into an f32 "
                         f"table or bf16 into a bf16 table, got "
                         f"{table.dtype} and {vals.dtype}")
    if gids.dtype != torch.int32 or gids.dim() != 1:
        raise ValueError(f"{_SCATTER}: gids must be 1-D int32, got "
                         f"{gids.dtype} {tuple(gids.shape)}")
    g = gids.shape[0]
    if tuple(vals.shape) != (g * group, h):
        raise ValueError(f"{_SCATTER}: vals {tuple(vals.shape)}, expected "
                         f"{(g * group, h)}")
    _build.check_cuda(_SCATTER, table.device, table, gids, vals)
    bf16 = table.dtype == torch.bfloat16
    if ((group * h) % (8 if bf16 else 4) or table.data_ptr() % 16
            or vals.data_ptr() % 16):
        raise ValueError(f"{_SCATTER}: a row group must be a whole number "
                         f"of 16-byte vectors ({group * h} elements)")
    if g == 0:
        return table
    fn = ("dssm_scatter_add_bf16_row_groups" if bf16
          else "dssm_scatter_add_row_groups")
    _build.launch(_SCATTER, fn, table.device,
                  table.data_ptr(), gids.data_ptr(), vals.data_ptr(), g,
                  v // group, group * h)
    return table
