"""The SPMD sparse-update step, one process a rank of the mesh: the
multihost preset's configuration.

Each rank holds its data shard of the batch (the dedupe's batch-wide fields
whole; with per-shard slot spaces its row of sel_local as [1, cap]) and
its model shard of the table. A step:

  - gathers the compact block: on mp > 1 each model rank gathers the groups
    it owns and the partials are summed over the model group
    (kernels/sharded_embed.py, on the mesh.collective_dtype wire);
  - looks up its rows. A joint batch with sel_local reads rows2 =
    compact[sel] (the u2-wide basis of every shard's slots, bf16 on a bf16
    wire) through its own slot space, the joint lookup kernel on
    (rows2, sel_local[0]); else the joint or per-side lookups as on one
    device;
  - runs the towers and the loss, the doc pool all-gathered over the data
    group when dp > 1 (loss/cosine_softmax.in_batch_loss_sharded);
  - sums over the data group what dssm_tpu's XLA sums implicitly: the
    gradient of the replicated lookup input (g_rows2 in the sel basis, on
    the wire's dtype, then added into the compact rows locally: the take's
    transpose; or the compact gradients) and the dense gradients. The mp
    ranks of one data coordinate hold the same batch shard and compute the
    same gradients, so nothing is summed over the whole world;
  - updates, in place, its table shard (the scatters on the groups it
    owns; the stochastic-rounding stream seeded (step * 4 + ix) * mp +
    shard from the device step counter), the replicated dense parameters
    and their optimizer state, and the step counter.

The body is in place and reads nothing back, so the compiled step
(train/compiled.py) captures it, its NCCL collectives inside the graph,
as dssm_tpu jits its body with the state donated. With no process group
(one process) or at world size 1 it computes what train/sparse_update.py's
body computes; at world size 1 bit for bit on an f32 wire. Counterpart of
dssm_tpu/parallel/sparse_step.py.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.kernels.dedup_embed import dequant_compact
from dssm_tpu_torch.kernels.gather import gather_row_groups, sublane_group
from dssm_tpu_torch.kernels.joint import joint_lookup, joint_lookup_bwd
from dssm_tpu_torch.kernels.sharded_embed import (
    gather_compact_sharded, scatter_add_groups_sharded,
    scatter_sr_groups_sharded)
from dssm_tpu_torch.loss.cosine_softmax import (
    in_batch_loss, in_batch_loss_sharded, rotate_loss, rotate_loss_sharded)
from dssm_tpu_torch.models.base import TABLE_KEY, torch_dtype
from dssm_tpu_torch.parallel.dist import (
    all_reduce, all_reduce_tree, check_graph_safe)
from dssm_tpu_torch.train.compiled import CompiledStep
from dssm_tpu_torch.train.sparse_update import (
    _dense_subtree, apply_table_update, grads_of, joint_fields,
    scatter_seed, side_lookups, table_update_vals, towers_from_lookups)
from dssm_tpu_torch.train.state import TrainState, optimizer_step_

Batch = Dict[str, torch.Tensor]


def rows2_from_compact(compact: torch.Tensor, sel: torch.Tensor,
                       collective_dtype: str = "float32") -> torch.Tensor:
    """rows2 [u2, H] = compact[sel], the basis the shards' slot spaces
    select from; bf16 when the collective wire is ("bfloat16"), so the data
    group's sum of its gradient rides bf16."""
    rows2 = compact.index_select(0, sel.long())
    if collective_dtype == "bfloat16" and rows2.dtype == torch.float32:
        rows2 = rows2.to(torch.bfloat16)
    return rows2


def make_loss(cfg: RunConfig, mesh, impl: str = "auto") -> Callable:
    """(q, d, batch) -> (loss, aux) on this rank's data shard: over the
    global pool (or the local one, mesh.global_negatives=False) when dp > 1,
    as on one device otherwise."""
    gamma = cfg.loss.gamma

    def loss_of(q, d, batch):
        if mesh.shape["data"] > 1:
            if cfg.loss.mode == "rotate":
                return rotate_loss_sharded(q, d, batch["rot_offsets"], gamma,
                                           mesh)
            return in_batch_loss_sharded(
                q, d, gamma, mesh, impl=impl,
                global_pool=cfg.mesh.global_negatives)
        if cfg.loss.mode == "rotate":
            return rotate_loss(q, d, batch["rot_offsets"], gamma)
        return in_batch_loss(q, d, gamma, impl=impl)

    return loss_of


def make_parallel_sparse_step_body(cfg: RunConfig, mesh,
                                   impl: str = "auto") -> Callable:
    """(state, local batch) -> aux: one sparse step on dedupe batches, IN
    PLACE, as train/sparse_update.py::make_sparse_train_step_body: this
    rank's table shard scattered where it lies, the dense parameters and
    their optimizer state stepped by optimizer_step_, the device step
    counter advanced, nothing read back to the host. The table in `state`
    is this rank's shard (parallel/train_step.py::create_sharded_state).
    The stochastic-rounding seeds are scatter_seed(state.step, ix), then *
    mp + shard, computed on the card, so each replay of a captured step and
    each body of a K-step graph draws its own step's stream."""
    table_key = TABLE_KEY[cfg.tower.arch]
    compute_dtype = torch_dtype(cfg.tower.compute_dtype)
    mp = mesh.shape["model"]
    coll = cfg.mesh.collective_dtype
    data_group = mesh.groups["data"]
    loss_of = make_loss(cfg, mesh, impl)

    def loss_from_lookups(dense, lq, ld, batch):
        return loss_of(*towers_from_lookups(cfg, dense, lq, ld, batch, impl),
                       batch)

    def loss_from_joint_lookups(dense, lq, ld, batch):
        return loss_from_lookups(dense, lq.to(compute_dtype),
                                 ld.to(compute_dtype), batch)

    def loss_from_compacts(dense, cq, cd, batch):
        return loss_from_lookups(dense, *side_lookups(cfg, cq, cd, batch,
                                                      impl), batch)

    def gather(table, uniq, scale=None):
        group = sublane_group(table.dtype)
        if mp > 1:
            c = gather_compact_sharded(table, uniq, group, mesh, impl=impl,
                                       collective_dtype=coll)
        else:
            c = gather_row_groups(table, uniq, group, impl=impl)
        if scale is not None:
            c = dequant_compact(c, scale, uniq, group)
        return c

    def update_table(table, uniq, vals, seed, scale=None):
        if mp == 1:
            apply_table_update(table, uniq, vals, seed, scale,
                               cfg.train.table_stochastic_round, impl)
            return
        group = sublane_group(table.dtype)
        if table.dtype == torch.int8:
            raise ValueError("an int8 table trains at model_parallel=1 only "
                             "(config.validate)")
        if table.dtype == torch.bfloat16 and cfg.train.table_stochastic_round:
            scatter_sr_groups_sharded(table, uniq, vals.float(), group, seed,
                                      mesh, impl=impl)
        else:
            scatter_add_groups_sharded(table, uniq, vals.to(table.dtype),
                                       group, mesh, impl=impl)

    def dense_update_(state, dense, g_dense):
        optimizer_step_(cfg.train, dense,
                        all_reduce_tree(g_dense, data_group), state.opt_state)

    def joint_body(state: TrainState, batch: Batch) -> Dict:
        params = state.params
        if "shared" not in params:
            raise ValueError(
                "joint-dedup batches (`uniq`) require shared_weights")
        dense = _dense_subtree(params, table_key)
        table = params["shared"][table_key]
        scale = params["shared"].get(f"{table_key}_scale")
        with torch.no_grad():
            c = gather(table, batch["uniq"], scale)
        if "sel_local" in batch:
            sl = batch["sel_local"]
            if sl.dim() != 2 or sl.shape[0] != 1:
                raise ValueError(
                    f"sel_local shape {tuple(sl.shape)}: a rank holds one "
                    "data shard's slot space, [1, cap]")
            basis = rows2_from_compact(c, batch["sel"], coll)
            fields = joint_fields(batch, sl[0])
        else:
            basis = c
            fields = joint_fields(batch, batch["sel"])
        with torch.no_grad():
            lq, ld = joint_lookup(basis, *fields, impl=impl)
        aux, g_dense, (g_lq, g_ld) = grads_of(
            loss_from_joint_lookups, dense, [lq, ld], batch)
        g_basis = joint_lookup_bwd(*fields, g_lq.contiguous(),
                                   g_ld.contiguous(), basis.shape[0],
                                   impl=impl).to(basis.dtype)
        with torch.no_grad():
            g_basis = all_reduce(g_basis, data_group)
            if basis is c:
                g_c = g_basis
            else:
                # The take's transpose: each slot's gradient into its
                # compact row (padding slots carry zeros).
                g_c = torch.zeros_like(c).index_add_(
                    0, batch["sel"].long(), g_basis.to(c.dtype))
            dense_update_(state, dense, g_dense)
            update_table(table, batch["uniq"], table_update_vals(cfg, g_c, c),
                         scatter_seed(state.step, 0), scale)
            state.step.add_(1)
        return aux

    def side_body(state: TrainState, batch: Batch) -> Dict:
        params = state.params
        dense = _dense_subtree(params, table_key)

        def tower_of(side):
            return params["shared" if "shared" in params else (
                "query" if side == "q" else "doc")]

        with torch.no_grad():
            cq, cd = (gather(tower_of(s)[table_key], batch[f"{s}_uniq"],
                             tower_of(s).get(f"{table_key}_scale"))
                      for s in "qd")
        aux, g_dense, (g_cq, g_cd) = grads_of(loss_from_compacts, dense,
                                              [cq, cd], batch)
        with torch.no_grad():
            g_cq = all_reduce(g_cq, data_group)
            g_cd = all_reduce(g_cd, data_group)
            dense_update_(state, dense, g_dense)
            scatter_ix = 0  # the scatter's seed offset within the step
            for tower in params:
                table = params[tower][table_key]
                scale = params[tower].get(f"{table_key}_scale")
                for side in {"shared": "qd", "query": "q", "doc": "d"}[tower]:
                    g_c, compact = (g_cq, cq) if side == "q" else (g_cd, cd)
                    update_table(table, batch[f"{side}_uniq"],
                                 table_update_vals(cfg, g_c, compact),
                                 scatter_seed(state.step, scatter_ix), scale)
                    scatter_ix += 1
            state.step.add_(1)
        return aux

    def body(state: TrainState, batch: Batch) -> Dict:
        if "uniq" in batch:
            return joint_body(state, batch)
        if "q_uniq" in batch:
            return side_body(state, batch)
        raise ValueError("the parallel sparse step takes dedupe batches "
                         "(raw-index batches take the dense parallel step)")

    return body


def make_parallel_sparse_train_step(cfg: RunConfig, mesh,
                                    impl: str = "auto") -> CompiledStep:
    """(state, local batch) -> (state, aux): the parallel sparse step,
    compiled (train/compiled.py: a replayed CUDA graph with its NCCL
    collectives on a CUDA state, eager on a CPU state)."""
    check_graph_safe()
    return CompiledStep(make_parallel_sparse_step_body(cfg, mesh, impl),
                        collectives=True)
