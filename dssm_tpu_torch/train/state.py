"""TrainState and the dense optimizers.

The dense parameters (everything but the embedding table under sparse
updates) are optimized by sgd, sgd with momentum, or adam, written as plain
functions on tensors that reproduce optax.sgd(lr), optax.sgd(lr, momentum)
and optax.adam(lr) step for step, so a state carried over from dssm_tpu
continues identically. Counterpart of dssm_tpu/train/state.py.

opt_state layout (trees mirror the optimized parameter tree):
    sgd       {}
    momentum  {"trace": tree}
    adam      {"count": int, "mu": tree, "nu": tree}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from dssm_tpu_torch.config import RunConfig, TrainConfig

Tree = Dict[str, Dict[str, torch.Tensor]]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclass
class TrainState:
    step: int
    params: Tree
    opt_state: Dict[str, Any]


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """fn over the leaves of two-level {tower: {name: tensor}} trees."""
    first = trees[0]
    return {tower: {k: fn(*[t[tower][k] for t in trees]) for k in tp}
            for tower, tp in first.items()}


def init_opt_state(cfg: TrainConfig, tree: Tree) -> Dict[str, Any]:
    zeros = lambda: tree_map(torch.zeros_like, tree)  # noqa: E731
    if cfg.optimizer == "sgd":
        return {}
    if cfg.optimizer == "momentum":
        return {"trace": zeros()}
    if cfg.optimizer == "adam":
        return {"count": 0, "mu": zeros(), "nu": zeros()}
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def optimizer_update(cfg: TrainConfig, grads: Tree, opt_state: Dict[str, Any],
                     ) -> Tuple[Tree, Dict[str, Any]]:
    """(updates, new opt_state); new params = params + updates."""
    lr = cfg.learning_rate
    if cfg.optimizer == "sgd":
        return tree_map(lambda g: -lr * g, grads), {}
    if cfg.optimizer == "momentum":
        trace = tree_map(lambda g, t: g + cfg.momentum * t, grads,
                         opt_state["trace"])
        return tree_map(lambda t: -lr * t, trace), {"trace": trace}
    if cfg.optimizer == "adam":
        count = opt_state["count"] + 1
        mu = tree_map(lambda g, m: ADAM_B1 * m + (1 - ADAM_B1) * g, grads,
                      opt_state["mu"])
        nu = tree_map(lambda g, v: ADAM_B2 * v + (1 - ADAM_B2) * g * g, grads,
                      opt_state["nu"])
        bc1, bc2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count
        updates = tree_map(
            lambda m, v: -lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)),
            mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def create_run_state(cfg: RunConfig, params: Tree) -> TrainState:
    """Fresh state for a run: under sparse table updates the optimizer state
    covers only the dense subtree (the table's optimizer state, if any,
    rides inside the table: train/sparse_update.table_update_vals)."""
    from dssm_tpu_torch.models.base import TABLE_KEY
    from dssm_tpu_torch.train.sparse_update import (
        _dense_subtree, uses_sparse_update)

    if not uses_sparse_update(cfg):
        raise NotImplementedError(
            "the dense-table train step (train.sparse_embed_update=False, or "
            "momentum/adam with the sgd table optimizer) is not ported yet "
            "(ROADMAP.md, Queue 1: the dense-table train step)")
    tree = _dense_subtree(params, TABLE_KEY[cfg.tower.arch])
    return TrainState(step=0, params=params,
                      opt_state=init_opt_state(cfg.train, tree))
