"""TrainState and the dense optimizers.

The densely optimized parameters (everything but the embedding table under
sparse updates; the whole tree, table included, on the dense-table step)
are optimized by sgd, sgd with momentum, or adam, written as plain
functions on tensors that reproduce optax.sgd(lr), optax.sgd(lr, momentum)
and optax.adam(lr) step for step, so a state carried over from dssm_tpu
continues identically. Counterpart of dssm_tpu/train/state.py.

The step counter and adam's count are int32 scalars on the parameters'
device, as dssm_tpu's are: the steps read them there (the stochastic-rounding
seeds, adam's bias correction), so a replayed CUDA graph of a step sees each
step's own values. TrainState.host_step mirrors the counter on the host for
logging and checkpoints; the step functions advance both.

optimizer_step_ is the in-place update every train step takes, the
single-device and the parallel ones (the donated state of dssm_tpu's jitted
step): the parameters and the optimizer state are written into the tensors
they live in. optimizer_update / apply_updates are the same arithmetic as
new tensors (bit-equal), the reference the tests hold the in-place update
to.

opt_state layout (trees mirror the optimized parameter tree):
    sgd       {}
    momentum  {"trace": tree}
    adam      {"count": int32 [], "mu": tree, "nu": tree}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from dssm_tpu_torch.config import RunConfig, TrainConfig

Tree = Dict[str, Dict[str, torch.Tensor]]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def counter(value: Union[int, torch.Tensor],
            device: torch.device) -> torch.Tensor:
    """A step counter or adam count as the int32 scalar the steps read, on
    `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(value), dtype=torch.int32, device=device)


@dataclass
class TrainState:
    """step: int32 [] on the parameters' device (an int is converted);
    host_step: its host mirror, read back from `step` when not given."""
    step: torch.Tensor
    params: Tree
    opt_state: Dict[str, Any]
    host_step: Optional[int] = None

    def __post_init__(self):
        dev = next(iter(next(iter(self.params.values())).values())).device
        if self.host_step is None:
            self.host_step = int(self.step)
        self.step = counter(self.step, dev)
        if "count" in self.opt_state:
            self.opt_state = dict(self.opt_state,
                                  count=counter(self.opt_state["count"], dev))


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
        dev = next(iter(next(iter(tree.values())).values())).device
        return {"count": counter(0, dev), "mu": zeros(), "nu": zeros()}
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _adam_mu(g, m):
    return ADAM_B1 * m + (1 - ADAM_B1) * g


def _adam_nu(g, v):
    return ADAM_B2 * v + (1 - ADAM_B2) * g * g


def _adam_update(lr: float, m, v, bc1, bc2):
    return -lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))


def _bias_corrections(count: torch.Tensor):
    """1 - b ** count for b1 and b2, f32 on the count's device, as optax's
    tree_bias_correction computes them."""
    return 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count


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
        mu = tree_map(_adam_mu, grads, opt_state["mu"])
        nu = tree_map(_adam_nu, grads, opt_state["nu"])
        bc1, bc2 = _bias_corrections(count)
        updates = tree_map(lambda m, v: _adam_update(lr, m, v, bc1, bc2),
                           mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _add_(p: torch.Tensor, u: torch.Tensor) -> None:
    """p <- (p + u) in p's dtype, in place: apply_updates' arithmetic."""
    if p.dtype == u.dtype:
        p.add_(u)
    else:
        p.copy_(p + u)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def optimizer_step_(cfg: TrainConfig, params: Tree, grads: Tree,
                    opt_state: Dict[str, Any]) -> None:
    """optimizer_update + apply_updates IN PLACE: params and opt_state's
    tensors take their new values, bit-equal to the functional pair's."""
    lr = cfg.learning_rate
    if cfg.optimizer == "sgd":
        tree_map(lambda p, g: _add_(p, -lr * g), params, grads)
        return
    if cfg.optimizer == "momentum":
        def momentum_(p, g, t):
            t.mul_(cfg.momentum).add_(g)  # g + momentum * t
            _add_(p, -lr * t)

        tree_map(momentum_, params, grads, opt_state["trace"])
        return
    if cfg.optimizer == "adam":
        opt_state["count"].add_(1)
        bc1, bc2 = _bias_corrections(opt_state["count"])

        def adam_(p, g, m, v):
            # _adam_mu / _adam_nu's roundings in place: b * m, then the sum
            # with (1 - b) * g (times g).
            m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
            v.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
            _add_(p, _adam_update(lr, m, v, bc1, bc2))

        tree_map(adam_, params, grads, opt_state["mu"], opt_state["nu"])
        return
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def create_run_state(cfg: RunConfig, params: Tree) -> TrainState:
    """Fresh state for a run: under sparse table updates the optimizer state
    covers only the dense subtree (the table's optimizer state, if any,
    rides inside the table: train/sparse_update.table_update_vals); off the
    sparse path it covers the whole tree, so momentum's trace and adam's
    moments include [V, H] tensors for the table."""
    from dssm_tpu_torch.models.base import TABLE_KEY
    from dssm_tpu_torch.train.sparse_update import (
        _dense_subtree, uses_sparse_update)

    key = TABLE_KEY[cfg.tower.arch]
    if uses_sparse_update(cfg):
        tree = _dense_subtree(params, key)
    else:
        check_dense_table(params, key)
        tree = params
    return TrainState(step=0, params=params,
                      opt_state=init_opt_state(cfg.train, tree))


def check_dense_table(params: Tree, table_key: str) -> None:
    """The dense-table step differentiates the table, in f32 only: bf16 and
    int8 tables train on the sparse path (config.validate asks
    train.sparse_embed_update of them, as dssm_tpu's does)."""
    for tower, tp in params.items():
        if tp[table_key].dtype != torch.float32:
            raise ValueError(
                f"the dense-table step trains an f32 table; {tower}/"
                f"{table_key} is {tp[table_key].dtype} (a bf16 or int8 table "
                "trains on the sparse path: train.optimizer=sgd or "
                "train.table_optimizer=adagrad, with "
                "train.sparse_embed_update)")
