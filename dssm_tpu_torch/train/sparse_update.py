"""Sparse-gradient embedding update: the row-wise table update.

A naive gradient over the whole parameter tree would materialize a dense
[V, H] gradient of the embedding table every step. This step keeps the
table out of the differentiated function:

  1. the compact row groups a batch touches are gathered OUTSIDE autograd
     (gather kernel); the compact block is the differentiation boundary
  2. lookups, towers and loss run under autograd over the compact block and
     the dense parameters, giving g_compact [U, H] plus the dense gradients
  3. the table update is one row-group scatter-add of the compact update
     values, IN PLACE on the table tensor (scatter kernel); the dense
     parameters take an sgd / momentum / adam step.

Mathematically identical to dense SGD (modulo float summation order).
Counterpart of dssm_tpu/train/sparse_update.py for one device; the step is
eager PyTorch, every kernel of it a hand-written CUDA kernel on CUDA tensors
and its plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.kernels.dedup_embed import (
    gather_compact, joint_lookup_from_compact, lookup_from_compact)
from dssm_tpu_torch.kernels.gather import (
    scatter_add_row_groups, sublane_group)
from dssm_tpu_torch.loss.cosine_softmax import in_batch_loss, rotate_loss
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.models.base import TABLE_KEY, torch_dtype
from dssm_tpu_torch.train.state import (
    TrainState, apply_updates, optimizer_update)

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
        return (-lr) * g_compact
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


def apply_table_update(table: torch.Tensor, uniq: torch.Tensor,
                       vals: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """One row-group scatter-add into the table, in place; sentinel slots
    are skipped."""
    if table.dtype != torch.float32:
        raise NotImplementedError(
            f"a {table.dtype} table's stochastic-rounding scatter is not "
            "ported yet (ROADMAP.md, Queue 1: the bf16 and int8 tables)")
    return scatter_add_row_groups(table, uniq, vals.to(table.dtype),
                                  sublane_group(table.dtype), impl=impl)


def make_sparse_train_step(cfg: RunConfig, impl: str = "auto") -> Callable:
    """(state, batch) -> (state, aux): one SGD step with sparse table
    updates. The batch is on the parameters' device (bridge.batch_to_torch).
    The table is updated in place: the returned state holds the same table
    tensor as the state passed in."""
    if cfg.tower.arch != "mlp":
        raise NotImplementedError(
            f"{cfg.tower.arch} towers are not ported yet (ROADMAP.md, "
            "Queue 1: cnn/lstm)")
    table_key = TABLE_KEY[cfg.tower.arch]
    compute_dtype = torch_dtype(cfg.tower.compute_dtype)

    def loss_from_lookups(dense, lq, ld, batch):
        if cfg.tower.shared_weights:
            # Shared MLP towers: both sides go through one stacked tower
            # call, one fused tower kernel on [2B] rows instead of two on
            # [B]. The MLP tower ignores batch/prefix, so stacking is exact.
            b = lq.shape[0]
            qd = model_base.embed_from_lookup(
                dense, cfg.tower, "q", batch, torch.cat([lq, ld], dim=0),
                impl=impl)
            q, d = qd[:b], qd[b:]
        else:
            q = model_base.embed_from_lookup(dense, cfg.tower, "q", batch,
                                             lq, impl=impl)
            d = model_base.embed_from_lookup(dense, cfg.tower, "d", batch,
                                             ld, impl=impl)
        if cfg.loss.mode == "rotate":
            return rotate_loss(q, d, batch["rot_offsets"], cfg.loss.gamma)
        return in_batch_loss(q, d, cfg.loss.gamma, impl=impl)

    def loss_from_compacts(dense, cq, cd, batch):
        lq = lookup_from_compact(cq, batch["q_inv"], batch["q_wgt"],
                                 compute_dtype, batch.get("q_sel"),
                                 impl=impl).to(compute_dtype)
        ld = lookup_from_compact(cd, batch["d_inv"], batch["d_wgt"],
                                 compute_dtype, batch.get("d_sel"),
                                 impl=impl).to(compute_dtype)
        return loss_from_lookups(dense, lq, ld, batch)

    def loss_from_compact_joint(dense, c, batch):
        # Shared table, union dedupe: one row selection serves both towers,
        # and autograd gives the COMBINED compact gradient (both sides) in
        # one array, so one scatter updates the table for both.
        lq, ld = joint_lookup_from_compact(
            c, batch["sel"], batch["q_inv"], batch["q_wgt"], batch["d_inv"],
            batch["d_wgt"], compute_dtype, impl=impl)
        return loss_from_lookups(dense, lq, ld, batch)

    def grads_of(loss_fn, dense, compacts, batch):
        """loss_fn(dense, *compacts, batch) differentiated in the dense
        parameters and the compact blocks."""
        dense = {tower: {k: v.detach().requires_grad_(True)
                         for k, v in tp.items()}
                 for tower, tp in dense.items()}
        compacts = [c.detach().requires_grad_(True) for c in compacts]
        loss, aux = loss_fn(dense, *compacts, batch)
        leaves = [v for tp in dense.values() for v in tp.values()]
        grads = torch.autograd.grad(loss, compacts + leaves)
        g_compacts, g_leaves = grads[:len(compacts)], grads[len(compacts):]
        it = iter(g_leaves)
        g_dense = {tower: {k: next(it) for k in tp}
                   for tower, tp in dense.items()}
        return aux, g_dense, g_compacts

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        params = state.params
        dense = _dense_subtree(params, table_key)

        if "uniq" in batch:
            # Union dedupe (shared table): one gather, one scatter.
            if "shared" not in params:
                raise ValueError(
                    "joint-dedup batches (`uniq`) require shared_weights")
            if "sel_local" in batch:
                raise NotImplementedError(
                    "per-shard slot spaces (`sel_local`) belong to the "
                    "multi-device path (ROADMAP.md, Queue 1: multi-device)")
            table = params["shared"][table_key]
            group = sublane_group(table.dtype)
            with torch.no_grad():
                c = gather_compact(table, batch["uniq"], group, impl=impl)
            aux, g_dense, (g_c,) = grads_of(loss_from_compact_joint, dense,
                                            [c], batch)
            with torch.no_grad():
                updates, new_opt = optimizer_update(cfg.train, g_dense,
                                                    state.opt_state)
                new_dense = apply_updates(dense, updates)
                vals = table_update_vals(cfg, g_c, c)
                table = apply_table_update(table, batch["uniq"], vals, impl)
            tp = dict(new_dense["shared"])
            tp[table_key] = table
            return TrainState(step=state.step + 1, params={"shared": tp},
                              opt_state=new_opt), aux

        if "q_uniq" not in batch:
            raise NotImplementedError(
                "the raw-index train step (batches without dedup fields) "
                "needs the embedding-bag kernel, not ported yet (ROADMAP.md, "
                "Queue 2: embedding_bag_pallas); use data.dedup_lookup=True")

        # Per-side dedupe: differentiate at each side's compact block; the
        # table update is then a U-row scatter per side.
        def tab(side):
            tower = "shared" if "shared" in params else (
                "query" if side == "q" else "doc")
            return params[tower][table_key]

        with torch.no_grad():
            cq, cd = (gather_compact(tab(s), batch[f"{s}_uniq"],
                                     sublane_group(tab(s).dtype), impl=impl)
                      for s in ("q", "d"))
        aux, g_dense, (g_cq, g_cd) = grads_of(loss_from_compacts, dense,
                                              [cq, cd], batch)
        with torch.no_grad():
            updates, new_opt = optimizer_update(cfg.train, g_dense,
                                                state.opt_state)
            new_dense = apply_updates(dense, updates)
            new_params = {}
            for tower in params:
                tp = dict(new_dense[tower])
                table = params[tower][table_key]
                sides = {"shared": ("q", "d"), "query": ("q",),
                         "doc": ("d",)}[tower]
                for side in sides:
                    g_c, compact = (g_cq, cq) if side == "q" else (g_cd, cd)
                    vals = table_update_vals(cfg, g_c, compact)
                    table = apply_table_update(table, batch[f"{side}_uniq"],
                                               vals, impl)
                tp[table_key] = table
                new_params[tower] = tp
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=new_opt), aux

    return step
