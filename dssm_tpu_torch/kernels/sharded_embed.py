"""The embedding table cut by rows over the mesh's 'model' axis: lookups
as a local partial + a sum over the model group, updates shard-local.

Model rank m of mp holds rows [m * V/mp, (m + 1) * V/mp) of the [V, H]
table (the row groups [m * G_s, (m + 1) * G_s), G_s = V / mp / group).
Each operation is a shard-local body, a plain function of (shard, mp) on
that rank's rows, and a wrapper that applies it to this rank's shard and
adds the collective, so one process can also run every shard's body (the
GPU tests hold the bodies, summed by hand, to the unsharded kernels):

  gather_compact_local     the compact gather of the groups this shard owns;
                           the others map to the out-of-range sentinel G_s,
                           which the gather kernel reads as zero rows
  gather_compact_sharded   ... summed over the model group (each row lives
                           on one shard, so the sum fills it in), on the
                           mesh.collective_dtype wire
  embedding_bag_local      the raw-index bag over the lookups this shard
                           owns (the others at weight 0)
  embedding_bag_sharded    ... summed over the model group; its backward is
                           the local bag's, into this shard's rows
  scatter_add_groups_*     the row-group add into the owned groups (the
                           others at the sentinel, which the kernel skips)
  scatter_sr_groups_*      the stochastic-rounding set into the owned
                           groups, the stream seeded seed * mp + shard

No kernel is added: the bodies launch the gather, bag and scatter kernels
of kernels/gather.py, embed.py and scatter_sr.py on the shard. The lookups
route here inside sharded_lookup_context (kernels/sparse_embed.py::
embedding_bag, kernels/dedup_embed.py::gather_compact), which the parallel
steps install when mp > 1, so model code never changes. Counterpart of
dssm_tpu/kernels/sharded_embed.py and of the sharded branch of its
dedup_embed.gather_compact.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from dssm_tpu_torch.kernels.embed import embedding_bag as _bag
from dssm_tpu_torch.kernels.gather import (
    gather_row_groups, scatter_add_row_groups)
from dssm_tpu_torch.kernels.scatter_sr import scatter_sr_row_groups
from dssm_tpu_torch.parallel.dist import AllReduceSum, all_reduce

# The installed context, for the whole process: a backward pass that
# recomputes a lookup (train.remat) runs on autograd's own thread on the
# card, and must route it as the forward did. One training loop a process.
_CTX: list = [None]


@contextmanager
def sharded_lookup_context(mesh, impl: str = "auto",
                           collective_dtype: str = "float32"):
    """Route the table lookups of the enclosed code (its backward pass
    included, when it runs inside) to the sharded ones over `mesh`'s model
    group."""
    prev = _CTX[0]
    _CTX[0] = (mesh, impl, collective_dtype)
    try:
        yield
    finally:
        _CTX[0] = prev


def current_context() -> Optional[Tuple[object, str, str]]:
    """(mesh, impl, collective_dtype) when a sharded context with mp > 1 is
    installed, else None."""
    ctx = _CTX[0]
    if ctx is None or ctx[0].shape["model"] <= 1:
        return None
    return ctx


def owned_group_ids(gids: torch.Tensor, shard: int,
                    groups_per_shard: int) -> torch.Tensor:
    """Global group ids -> this shard's local ids, int32; the groups it
    does not own (and the dedupe's sentinel padding) -> the local
    out-of-range sentinel groups_per_shard."""
    rel = gids.long() - shard * groups_per_shard
    owned = (rel >= 0) & (rel < groups_per_shard)
    return torch.where(owned, rel, groups_per_shard).to(torch.int32)


def _groups_per_shard(table_shard: torch.Tensor, group: int) -> int:
    rows = table_shard.shape[0]
    if rows % group:
        raise ValueError(f"a table shard of {rows} rows is not a whole "
                         f"number of {group}-row groups")
    return rows // group


def gather_compact_local(table_shard: torch.Tensor, gids: torch.Tensor,
                         group: int, shard: int, *,
                         impl: str = "auto") -> torch.Tensor:
    """[G * group, H]: the rows of the groups shard `shard` owns, zero rows
    for the others."""
    rel = owned_group_ids(gids, shard, _groups_per_shard(table_shard, group))
    return gather_row_groups(table_shard, rel, group, impl=impl)


def gather_compact_sharded(table_shard: torch.Tensor, gids: torch.Tensor,
                           group: int, mesh, *, impl: str = "auto",
                           collective_dtype: str = "float32") -> torch.Tensor:
    """The whole compact block on every rank of the model group. A
    "bfloat16" collective_dtype sends an f32 block as bf16 (each row is
    rounded once, as the bf16 compute cast rounds it anyway)."""
    part = gather_compact_local(table_shard, gids, group,
                                mesh.coords["model"], impl=impl)
    wire = (torch.bfloat16 if collective_dtype == "bfloat16"
            and part.dtype == torch.float32 else None)
    return all_reduce(part, mesh.groups["model"], wire)


def embedding_bag_local(table_shard: torch.Tensor, idx: torch.Tensor,
                        wgt: torch.Tensor, shard: int, *,
                        impl: str = "auto") -> torch.Tensor:
    """The bag over the lookups whose rows shard `shard` holds, f32; the
    others are clipped into the shard at weight 0."""
    rows = table_shard.shape[0]
    rel = idx - shard * rows
    owned = (rel >= 0) & (rel < rows)
    rel = rel.clamp(0, rows - 1).to(torch.int32)
    return _bag(table_shard, rel, wgt * owned.to(wgt.dtype), impl=impl)


def embedding_bag_sharded(table_shard: torch.Tensor, idx: torch.Tensor,
                          wgt: torch.Tensor, mesh, *,
                          impl: str = "auto") -> torch.Tensor:
    """[..., H] f32, the whole bag on every rank of the model group;
    differentiable in the shard (its gradient is this shard's rows')."""
    part = embedding_bag_local(table_shard, idx, wgt, mesh.coords["model"],
                               impl=impl)
    return AllReduceSum.apply(part, mesh.groups["model"])


def scatter_add_groups_local(table_shard: torch.Tensor, gids: torch.Tensor,
                             vals: torch.Tensor, group: int, shard: int, *,
                             impl: str = "auto") -> torch.Tensor:
    """The groups shard `shard` owns += their rows of vals [G * group, H],
    in place; the replicated vals of the other groups are skipped."""
    rel = owned_group_ids(gids, shard, _groups_per_shard(table_shard, group))
    return scatter_add_row_groups(table_shard, rel, vals, group, impl=impl)


def scatter_add_groups_sharded(table_shard: torch.Tensor, gids: torch.Tensor,
                               vals: torch.Tensor, group: int, mesh, *,
                               impl: str = "auto") -> torch.Tensor:
    return scatter_add_groups_local(table_shard, gids, vals, group,
                                    mesh.coords["model"], impl=impl)


def scatter_sr_groups_local(table_shard: torch.Tensor, gids: torch.Tensor,
                            vals: torch.Tensor, group: int, seed: int,
                            shard: int, mp: int, *,
                            impl: str = "auto") -> torch.Tensor:
    """The owned bf16 groups become SR(f32(rows) + vals), in place, on the
    stream of seed * mp + shard (the shards' rows are disjoint; the seeds
    decorrelate their streams anyway, as dssm_tpu's do)."""
    rel = owned_group_ids(gids, shard, _groups_per_shard(table_shard, group))
    return scatter_sr_row_groups(table_shard, rel, vals, group,
                                 seed * mp + shard, impl=impl)


def scatter_sr_groups_sharded(table_shard: torch.Tensor, gids: torch.Tensor,
                              vals: torch.Tensor, group: int, seed: int,
                              mesh, *, impl: str = "auto") -> torch.Tensor:
    return scatter_sr_groups_local(table_shard, gids, vals, group, seed,
                                   mesh.coords["model"],
                                   mesh.shape["model"], impl=impl)
