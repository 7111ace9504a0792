"""Sparse-gradient embedding update: the row-wise table update.

A naive gradient over the whole parameter tree would materialize a dense
[V, H] gradient of the embedding table every step. This step keeps the
table out of the differentiated function:

  1. the compact row groups a batch touches are gathered OUTSIDE autograd
     (gather kernel); the compact block is the differentiation boundary
  2. lookups, towers and loss run under autograd over the compact block and
     the dense parameters, giving g_compact [U, H] plus the dense gradients
     (a joint-dedupe batch instead runs both sides' lookups outside
     autograd too, as one fused gather + lookup kernel on an f32 or bf16
     table, differentiates at the two lookup outputs, and forms g_compact
     with the joint lookup's backward kernel)
  3. the table update is one row-group scatter of the compact update
     values, IN PLACE on the table tensor: an add for an f32 table, a
     stochastically rounded read-modify-write for a bf16 or an int8 table
     (scatter kernels); the dense parameters take an sgd / momentum / adam
     step.

A joint batch with one per-shard slot space (`sel_local` [1, cap],
data/loader.reslot_local; the multihost preset) reads its rows through
sel[sel_local[0]] (joint_row_sel).

A batch without dedupe fields (data.dedup_lookup=False, f32 tables) takes
the raw-index branch: both sides' lookups run outside autograd through the
embedding-bag kernel, the lookup outputs are the differentiation boundary,
and the table takes -lr * wgt * g rows by one index_add_ per side
(scatter_table_update), in place.

A bf16 table's compact block is bf16, so its compact gradient is rounded to
bf16 (the f32 sum rounded to nearest) and, under the sgd table
optimizer, -lr * g is formed in bf16 with lr rounded to bf16, as the
reference forms it; only then is the update widened to f32 for the scatter.
An int8 table's compact block is dequantized to f32 against the per-row
scale parameter `<table>_scale`, which passes through the step unchanged.
The scatters' random streams are seeded with step * 4 (+ the scatter's
index within the step), computed on the device from the step counter.

The step body updates the whole state in place (the table always was; the
dense parameters, the optimizer state and the step counter too), as
dssm_tpu's donated state is updated, and reads nothing back to the host;
make_sparse_train_step compiles it (train/compiled.py: a replayed CUDA
graph on the card, the body run eagerly on the CPU). Every kernel of it is
a hand-written CUDA kernel on CUDA tensors and its plain version on CPU
tensors.

Mathematically identical to dense SGD (modulo float summation order).
Counterpart of dssm_tpu/train/sparse_update.py for one device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.kernels.dedup_embed import (
    dequant_compact, gather_compact, gather_scale_rows, lookup_from_compact)
from dssm_tpu_torch.kernels.gather import (
    scatter_add_row_groups, sublane_group)
from dssm_tpu_torch.kernels.joint import (
    fused_gather_joint_lookup, joint_lookup, joint_lookup_bwd)
from dssm_tpu_torch.kernels.scatter_sr import (
    scatter_sr_int8_row_groups, scatter_sr_row_groups)
from dssm_tpu_torch.loss.cosine_softmax import in_batch_loss, rotate_loss
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.models.base import TABLE_KEY, torch_dtype
from dssm_tpu_torch.train.compiled import CompiledStep
from dssm_tpu_torch.train.state import TrainState, optimizer_step_

Batch = Dict[str, torch.Tensor]


def uses_sparse_update(cfg: RunConfig) -> bool:
    # Sparse table updates need a self-contained row update rule: plain SGD
    # (matching the dense optimizer) or row-wise AdaGrad (its accumulator
    # travels inside the table: table_update_vals).
    return cfg.train.sparse_embed_update and (
        cfg.train.optimizer == "sgd" or cfg.train.table_optimizer == "adagrad"
    )


def logical_table_width(cfg: RunConfig) -> int:
    """Columns of the table that hold real weights (before padding)."""
    tower = cfg.tower
    return {
        "mlp": tower.embed_width,
        "cnn": tower.conv_window * tower.conv_channels,
        "lstm": tower.embed_width,
    }[tower.arch]


def table_update_vals(cfg: RunConfig, g_compact: torch.Tensor,
                      compact: torch.Tensor) -> torch.Tensor:
    """Scatter-ADD values for one side's compact table rows.

    sgd:     vals = -lr * g
    adagrad: row-wise AdaGrad. acc rides in the LAST (padding) column of
             the table, gathered with the weights and updated by the same
             scatter: vals[:, :W] = -lr * g / sqrt(acc + g2 + eps),
             vals[:, ACC] = g2 where g2 = mean(g[:, :W]^2) per row.
    """
    lr = cfg.train.learning_rate
    if cfg.train.table_optimizer == "sgd":
        # -lr meets g in g's dtype (bf16 for a bf16 table), as in dssm_tpu.
        return float(torch.tensor(-lr, dtype=g_compact.dtype)) * g_compact
    if cfg.train.table_optimizer != "adagrad":
        raise ValueError(cfg.train.table_optimizer)
    width = logical_table_width(cfg)
    h_pad = compact.shape[1]
    if h_pad <= width:
        raise ValueError(
            "adagrad table optimizer needs a spare padding column; "
            f"table width {h_pad} == logical width {width}")
    acc_col = h_pad - 1
    g32 = g_compact.float()
    g2 = torch.mean(g32[:, :width] ** 2, dim=1, keepdim=True)  # [U, 1]
    acc_old = compact[:, acc_col:acc_col + 1].float()
    scale = lr / torch.sqrt(acc_old + g2 + cfg.train.table_adagrad_eps)
    vals = -scale * g32
    # Column layout: [0, W) weights, (W, ACC) dead padding, ACC accumulator.
    vals[:, width:] = 0.0
    vals[:, acc_col:acc_col + 1] = g2
    return vals


def _dense_subtree(params: Dict, table_key: str) -> Dict:
    # The table and its int8 per-row scale (non-differentiable state) are
    # excluded from the densely-optimized subtree.
    drop = (table_key, f"{table_key}_scale")
    return {
        tower: {k: v for k, v in tp.items() if k not in drop}
        for tower, tp in params.items()
    }


def scatter_table_update(table: torch.Tensor, idx: torch.Tensor,
                         wgt: torch.Tensor, g_lookup: torch.Tensor,
                         lr: float) -> torch.Tensor:
    """table[idx[..., k]] -= lr * wgt[..., k] * g_lookup[...], one f32
    index_add_ IN PLACE (dssm_tpu's .at[].add). idx / wgt [..., K],
    g_lookup [..., H]. Padding entries carry weight 0 and add zero into
    row 0. On the card the adds of a row are atomics: the last bits depend
    on their order."""
    h = g_lookup.shape[-1]
    vals = wgt.float()[..., None] * g_lookup.float()[..., None, :]
    flat_vals = ((-lr) * vals).reshape(-1, h).to(table.dtype)
    return table.index_add_(0, idx.reshape(-1).long(), flat_vals)


def apply_table_update(table: torch.Tensor, uniq: torch.Tensor,
                       vals: torch.Tensor, seed: int,
                       scale: Optional[torch.Tensor] = None,
                       stochastic_round: bool = True,
                       impl: str = "auto") -> torch.Tensor:
    """One row-group scatter update of the table, in place: stochastic
    rounding onto each row's grid for an int8 table (`scale` is its [V, 1]
    parameter), stochastic rounding for a bf16 table (a rounded-to-nearest
    bf16 add with stochastic_round=False), a plain add otherwise. Sentinel
    slots are skipped."""
    group = sublane_group(table.dtype)
    if table.dtype == torch.int8:
        sc = gather_scale_rows(scale, uniq, group)
        vals_grid = torch.where(sc > 0, vals.float() / sc.clamp_min(1e-30),
                                0.0)
        return scatter_sr_int8_row_groups(table, uniq, vals_grid, group, seed,
                                          impl=impl)
    if table.dtype == torch.bfloat16 and stochastic_round:
        return scatter_sr_row_groups(table, uniq, vals.float(), group, seed,
                                     impl=impl)
    return scatter_add_row_groups(table, uniq, vals.to(table.dtype), group,
                                  impl=impl)


def joint_row_sel(batch: Batch) -> torch.Tensor:
    """The compact row of each unique-row slot a joint batch's lookups
    read, int32: `sel`, or with a per-shard slot space (`sel_local` [1,
    cap], data/loader.reslot_local) sel[sel_local[0]], the one shard's
    slots composed with the batch's (the same rows the parallel step
    selects, parallel/sparse_step.py)."""
    sel = batch["sel"].to(torch.int32)
    if "sel_local" in batch:
        sl = batch["sel_local"]
        if sl.dim() != 2 or sl.shape[0] != 1:
            raise ValueError(
                f"sel_local shape {tuple(sl.shape)}: the single-device step "
                "needs local_sel_shards=1 (multi-shard slot spaces run "
                "under the parallel step, one shard a process)")
        sel = sel[sl[0].long()]
    return sel.contiguous()


def default_loss(cfg: RunConfig, impl: str = "auto") -> Callable:
    """(q, d, batch) -> (loss, aux) on one device: the in-batch loss, or
    the rotate loss over the batch's rot_offsets."""
    def loss_of(q, d, batch):
        if cfg.loss.mode == "rotate":
            return rotate_loss(q, d, batch["rot_offsets"], cfg.loss.gamma)
        return in_batch_loss(q, d, cfg.loss.gamma, impl=impl)

    return loss_of


def towers_from_lookups(cfg: RunConfig, dense: Dict, lq: torch.Tensor,
                        ld: torch.Tensor, batch: Batch, impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, d) unit vectors from the two sides' first-layer lookups."""
    if cfg.tower.shared_weights and cfg.tower.arch == "mlp":
        # Shared MLP towers: both sides go through one stacked tower call,
        # one fused tower kernel on [2B] rows instead of two on [B]. The MLP
        # tower ignores batch/prefix, so stacking is exact; the sequence
        # towers read each side's word mask.
        b = lq.shape[0]
        qd = model_base.embed_from_lookup(
            dense, cfg.tower, "q", batch, torch.cat([lq, ld], dim=0),
            impl=impl)
        return qd[:b], qd[b:]
    q = model_base.embed_from_lookup(dense, cfg.tower, "q", batch, lq,
                                     impl=impl)
    d = model_base.embed_from_lookup(dense, cfg.tower, "d", batch, ld,
                                     impl=impl)
    return q, d


def side_lookups(cfg: RunConfig, cq: torch.Tensor, cd: torch.Tensor,
                 batch: Batch, impl: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A per-side batch's two lookups from its compact blocks, in the
    compute dtype."""
    compute_dtype = torch_dtype(cfg.tower.compute_dtype)
    lq = lookup_from_compact(cq, batch["q_inv"], batch["q_wgt"],
                             compute_dtype, batch.get("q_sel"),
                             impl=impl).to(compute_dtype)
    ld = lookup_from_compact(cd, batch["d_inv"], batch["d_wgt"],
                             compute_dtype, batch.get("d_sel"),
                             impl=impl).to(compute_dtype)
    return lq, ld


def grads_of(loss_fn: Callable, dense: Dict, tensors, batch: Batch):
    """loss_fn(dense, *tensors, batch) -> (loss, aux), differentiated in
    the dense parameters and in `tensors` (compact blocks or lookups):
    (aux, g_dense, g_tensors)."""
    dense = {tower: {k: v.detach().requires_grad_(True)
                     for k, v in tp.items()}
             for tower, tp in dense.items()}
    tensors = [c.detach().requires_grad_(True) for c in tensors]
    loss, aux = loss_fn(dense, *tensors, batch)
    leaves = [v for tp in dense.values() for v in tp.values()]
    grads = torch.autograd.grad(loss, tensors + leaves)
    g_tensors, g_leaves = grads[:len(tensors)], grads[len(tensors):]
    it = iter(g_leaves)
    g_dense = {tower: {k: next(it) for k in tp}
               for tower, tp in dense.items()}
    return aux, g_dense, g_tensors


def joint_fields(batch: Batch, row_sel: torch.Tensor) -> Tuple:
    """(row_sel, q_inv, q_wgt, d_inv, d_wgt) as the joint lookup kernels
    take them: int32 slots, f32 weights, contiguous."""
    return (row_sel.to(torch.int32).contiguous(),
            batch["q_inv"].to(torch.int32).contiguous(),
            batch["q_wgt"].float().contiguous(),
            batch["d_inv"].to(torch.int32).contiguous(),
            batch["d_wgt"].float().contiguous())


def scatter_seed(step: torch.Tensor, scatter_ix: int) -> torch.Tensor:
    """The stochastic-rounding seed of a step's scatter_ix-th table scatter,
    step * 4 + scatter_ix as dssm_tpu forms it, an int32 computed on the
    device from the step counter (a graph replay reads its own)."""
    return step * 4 + scatter_ix


def make_sparse_train_step_body(cfg: RunConfig, impl: str = "auto"
                                ) -> Callable:
    """(state, batch) -> aux: one SGD step with sparse table updates, IN
    PLACE: the table, the dense parameters, the optimizer state and the
    step counter take their new values in the tensors they live in, and
    nothing is read back to the host. The batch's fields are on the
    parameters' device (bridge.batch_to_torch). train/compiled.py captures
    it; on the CPU it runs eagerly."""
    table_key = TABLE_KEY[cfg.tower.arch]
    compute_dtype = torch_dtype(cfg.tower.compute_dtype)
    loss_of = default_loss(cfg, impl)

    def loss_from_lookups(dense, lq, ld, batch):
        return loss_of(*towers_from_lookups(cfg, dense, lq, ld, batch, impl),
                       batch)

    def loss_from_compacts(dense, cq, cd, batch):
        return loss_from_lookups(dense, *side_lookups(cfg, cq, cd, batch,
                                                      impl), batch)

    def loss_from_joint_lookups(dense, lq, ld, batch):
        # The joint lookup's f32 outputs, cast to the compute dtype inside
        # the differentiated function, as joint_lookup_from_compact casts.
        return loss_from_lookups(dense, lq.to(compute_dtype),
                                 ld.to(compute_dtype), batch)

    def body(state: TrainState, batch: Batch) -> Dict:
        params = state.params
        dense = _dense_subtree(params, table_key)

        if "uniq" in batch:
            # Union dedupe (shared table): one gather, one scatter.
            if "shared" not in params:
                raise ValueError(
                    "joint-dedup batches (`uniq`) require shared_weights")
            table = params["shared"][table_key]
            scale = params["shared"].get(f"{table_key}_scale")
            group = sublane_group(table.dtype)
            fields = joint_fields(batch, joint_row_sel(batch))
            with torch.no_grad():
                if table.dtype == torch.int8:
                    # int8: the compact block is dequantized before the
                    # lookup, so the gather and the lookup stay apart.
                    c = gather_compact(table, batch["uniq"], group, impl=impl)
                    c = dequant_compact(c, scale, batch["uniq"], group)
                    lq, ld = joint_lookup(c, *fields, impl=impl)
                else:
                    lq, ld, c = fused_gather_joint_lookup(
                        table, batch["uniq"], *fields, group, impl=impl)
            aux, g_dense, (g_lq, g_ld) = grads_of(
                loss_from_joint_lookups, dense, [lq, ld], batch)
            # Both sides' gradients in one compact gradient: one scatter
            # updates the table for both towers.
            g_c = joint_lookup_bwd(*fields, g_lq.contiguous(),
                                   g_ld.contiguous(), c.shape[0],
                                   impl=impl).to(c.dtype)
            with torch.no_grad():
                optimizer_step_(cfg.train, dense, g_dense, state.opt_state)
                vals = table_update_vals(cfg, g_c, c)
                apply_table_update(
                    table, batch["uniq"], vals, scatter_seed(state.step, 0),
                    scale, cfg.train.table_stochastic_round, impl)
                state.step.add_(1)
            return aux

        if "q_uniq" not in batch:
            return raw_body(state, batch)

        # Per-side dedupe: differentiate at each side's compact block; the
        # table update is then a U-row scatter per side.
        def gather_side(side):
            tp_side = params["shared" if "shared" in params else (
                "query" if side == "q" else "doc")]
            table = tp_side[table_key]
            group = sublane_group(table.dtype)
            c = gather_compact(table, batch[f"{side}_uniq"], group, impl=impl)
            scale = tp_side.get(f"{table_key}_scale")
            if scale is not None:
                c = dequant_compact(c, scale, batch[f"{side}_uniq"], group)
            return c

        with torch.no_grad():
            cq, cd = gather_side("q"), gather_side("d")
        aux, g_dense, (g_cq, g_cd) = grads_of(loss_from_compacts, dense,
                                              [cq, cd], batch)
        with torch.no_grad():
            optimizer_step_(cfg.train, dense, g_dense, state.opt_state)
            scatter_ix = 0  # the scatter's seed offset within the step
            for tower in params:
                table = params[tower][table_key]
                scale = params[tower].get(f"{table_key}_scale")
                sides = {"shared": ("q", "d"), "query": ("q",),
                         "doc": ("d",)}[tower]
                for side in sides:
                    g_c, compact = (g_cq, cq) if side == "q" else (g_cd, cd)
                    vals = table_update_vals(cfg, g_c, compact)
                    apply_table_update(
                        table, batch[f"{side}_uniq"], vals,
                        scatter_seed(state.step, scatter_ix), scale,
                        cfg.train.table_stochastic_round, impl)
                    scatter_ix += 1
            state.step.add_(1)
        return aux

    def raw_body(state: TrainState, batch: Batch) -> Dict:
        # Raw indices: the lookups are the differentiation boundary; each
        # side's table update is a B*K-row index_add_.
        if cfg.train.table_optimizer == "adagrad":
            raise ValueError("table_optimizer='adagrad' requires dedup "
                             "batches (data.dedup_lookup)")
        params = state.params
        dense = _dense_subtree(params, table_key)
        with torch.no_grad():
            lq, ld = (model_base.embed_table_lookup(params, cfg.tower, s,
                                                    batch, impl=impl)
                      for s in "qd")
        aux, g_dense, (g_lq, g_ld) = grads_of(loss_from_lookups, dense,
                                              [lq, ld], batch)
        lr = cfg.train.learning_rate
        with torch.no_grad():
            optimizer_step_(cfg.train, dense, g_dense, state.opt_state)
            for tower in params:
                table = params[tower][table_key]
                sides = {"shared": "qd", "query": "q", "doc": "d"}[tower]
                for side in sides:
                    scatter_table_update(
                        table, batch[f"{side}_idx"], batch[f"{side}_wgt"],
                        g_lq if side == "q" else g_ld, lr)
            state.step.add_(1)
        return aux

    return body


def make_sparse_train_step(cfg: RunConfig, impl: str = "auto"
                           ) -> CompiledStep:
    """(state, batch) -> (state, aux): the sparse step, compiled
    (train/compiled.py: a replayed CUDA graph on a CUDA state, eager on a
    CPU state); the state is updated in place and returned."""
    return CompiledStep(make_sparse_train_step_body(cfg, impl))
