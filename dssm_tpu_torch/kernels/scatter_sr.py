"""Row-group scatter updates with stochastic rounding, IN PLACE on a bf16 or
an int8 table.

scatter_sr_row_groups: the bf16 table rows of each real group id become
stochastic_round_bf16(f32(rows) + f32(vals)). Counterpart of
dssm_tpu/kernels/pallas_gather.py::scatter_sr_row_groups.

scatter_sr_int8_row_groups: the int8 table rows become
int8(clip(floor(f32(q) + vals_grid + u), -127, 127)); vals_grid is ALREADY
in grid units (the update divided by the row's scale, 0 where the scale is
0), as the reference's kernel takes it. Counterpart of pallas_gather.py::
scatter_sr_int8_row_groups.

The CUDA kernels are in csrc/scatter_sr.cu: one launch a call, a thread a
16-byte vector of the table (8 bf16 or 16 int8 elements) and a block 256
of them, so each real slot's group spreads over several blocks and SMs
and a skip slot's blocks read its id and leave. SET semantics: the real
group ids of one call must be distinct, as the dedupe makes them.
Out-of-range slots (the dedupe's SKIP_SENTINEL_GID padding, a negative id,
one past the table), at any position, are skipped: nothing is read or
written through them. The random bits are kernels/stochastic.py's Philox
stream under `seed`, indexed by the element's position in the compact
block, whatever thread computes it; the plain versions draw the same
stream with philox_bits, so kernel and plain version are bit-equal.

The kernels read the seed on the device, from a one-element int32 tensor
(the train step's step * 4 + the scatter's index, computed from its device
step counter), so a CUDA graph of the step draws each replay's own stream.
An int seed is copied to the device first (tests, tools): a synchronising
copy, which a graph capture refuses.
"""

from __future__ import annotations

from typing import Union

import torch

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.kernels.gather import expand_group_rows
from dssm_tpu_torch.kernels.stochastic import (
    philox_bits, stochastic_round_bf16, stochastic_round_int8)

_BF16 = "scatter_sr_row_groups"
_INT8 = "scatter_sr_int8_row_groups"


Seed = Union[int, torch.Tensor]


def _c_int(seed: int) -> int:
    """The seed as an int32 (its bits are the key)."""
    seed = int(seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= 1 << 31 else seed


def seed_tensor(name: str, seed: Seed, device: torch.device) -> torch.Tensor:
    """The seed as the one-element int32 tensor on `device` the kernel
    reads."""
    if not isinstance(seed, torch.Tensor):
        return torch.tensor([_c_int(seed)], dtype=torch.int32, device=device)
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or seed.device != device):
        raise ValueError(f"{name}: the seed must be one int32 on {device}, "
                         f"got {seed.dtype} {tuple(seed.shape)} on "
                         f"{seed.device}")
    return seed

def _plain(table, gids, vals, group, seed, round_fn):
    v, h = table.shape
    if v % group:
        raise ValueError(f"vocab {v} not divisible by group {group}")
    gids = gids.long()
    valid = (gids >= 0) & (gids < v // group)
    rows = expand_group_rows(torch.where(valid, gids, 0), group)
    bits = philox_bits(seed, rows.numel() * h, table.device).view(-1, h)
    new = round_fn(table.index_select(0, rows).float() + vals.float(), bits)
    keep = valid.repeat_interleave(group)
    return table.index_copy_(0, rows[keep], new[keep])


def scatter_sr_row_groups_plain(table: torch.Tensor, gids: torch.Tensor,
                                vals: torch.Tensor, group: int,
                                seed: Seed) -> torch.Tensor:
    """Plain PyTorch version: philox_bits, the bit-trick rounding and an
    index_copy_ of the real slots' rows."""
    return _plain(table, gids, vals, group, seed, stochastic_round_bf16)


def scatter_sr_int8_row_groups_plain(table: torch.Tensor, gids: torch.Tensor,
                                     vals_grid: torch.Tensor, group: int,
                                     seed: Seed) -> torch.Tensor:
    return _plain(table, gids, vals_grid, group, seed, stochastic_round_int8)


def _launch(name, fn, table, gids, vals, group, seed, dtype, vec_elems):
    v, h = table.shape
    if v % group:
        raise ValueError(f"vocab {v} not divisible by group {group}")
    if table.dtype != dtype or vals.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel adds f32 into a {dtype} "
                         f"table, got {table.dtype} and {vals.dtype}")
    if gids.dtype != torch.int32 or gids.dim() != 1:
        raise ValueError(f"{name}: gids must be 1-D int32, got "
                         f"{gids.dtype} {tuple(gids.shape)}")
    g = gids.shape[0]
    if tuple(vals.shape) != (g * group, h):
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, expected "
                         f"{(g * group, h)}")
    _build.check_cuda(name, table.device, table, gids, vals)
    if (group * h) % vec_elems or table.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError(f"{name}: a row group must be a whole number of "
                         f"16-byte vectors ({group * h} elements)")
    if g == 0:
        return table
    seed = seed_tensor(name, seed, table.device)
    _build.launch(name, fn, table.device, table.data_ptr(), gids.data_ptr(),
                  vals.data_ptr(), g, v // group, group * h, seed.data_ptr())
    return table


def scatter_sr_row_groups(table: torch.Tensor, gids: torch.Tensor,
                          vals: torch.Tensor, group: int, seed: Seed, *,
                          impl: str = "auto") -> torch.Tensor:
    """table [V, H] bf16 updated in place and returned; gids [G] int32; vals
    [G*group, H] f32; seed: vary it per step and scatter (an int, or one
    int32 on the table's device)."""
    if _build.resolve_impl(impl, table, _BF16) == "plain":
        return scatter_sr_row_groups_plain(table, gids, vals, group, seed)
    return _launch(_BF16, "dssm_scatter_sr_bf16_row_groups", table, gids,
                   vals, group, seed, torch.bfloat16, 8)


def scatter_sr_int8_row_groups(table: torch.Tensor, gids: torch.Tensor,
                               vals_grid: torch.Tensor, group: int,
                               seed: Seed, *, impl: str = "auto"
                               ) -> torch.Tensor:
    """table [V, H] int8 updated in place and returned; vals_grid [G*group,
    H] f32 in grid units."""
    if _build.resolve_impl(impl, table, _INT8) == "plain":
        return scatter_sr_int8_row_groups_plain(table, gids, vals_grid, group,
                                                seed)
    return _launch(_INT8, "dssm_scatter_sr_int8_row_groups", table, gids,
                   vals_grid, group, seed, torch.int8, 16)
