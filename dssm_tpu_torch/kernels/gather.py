"""Row-group gather: compact[G*group, H] = the table rows of each group id.

Counterpart of dssm_tpu/kernels/pallas_gather.py::gather_row_groups; the
CUDA kernel is csrc/gather.cu. Slots whose group id is out of range (the
dedupe's SKIP_SENTINEL_GID padding) read nothing and come back as zero rows.
"""

from __future__ import annotations

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "gather_row_groups"


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
    out = torch.empty((g * group, h), dtype=table.dtype, device=table.device)
    if g == 0:
        return out
    _build.launch(_NAME, "dssm_gather_row_groups", table.device,
                  table.data_ptr(), gids.data_ptr(), out.data_ptr(), g,
                  v // group, group_bytes)
    return out
