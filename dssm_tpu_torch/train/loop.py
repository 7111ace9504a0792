"""Single-device train steps and loop.

make_train_step routes a config to its step: the sparse-table-update step
(train/sparse_update.py) under sgd or the row-wise AdaGrad table optimizer
with train.sparse_embed_update, else the dense-table step, which
differentiates the whole parameter tree, table included, and runs the dense
optimizer over all of it (momentum's trace and adam's moments cover the
table). Both are compiled (train/compiled.py): on a CUDA state the step is
a replayed CUDA graph over the state's own tensors, updated in place, as
dssm_tpu's jitted step donates its state; on a CPU state the same body runs
eagerly. make_eager_train_step is the body run eagerly on any device (the
reference the compiled step is held to). train drives a step over a stream
of numpy batches, moving each to the parameters' device.

train.steps_per_call = K > 1 dispatches blocks of K steps:
make_multi_train_step takes a batch whose every field has a leading [K]
axis (stack_batches) and runs the step body K times on views of it,
returning the aux values stacked [K]. dssm_tpu compiles the K steps into
one executable with lax.scan; on the card the port captures them into one
CUDA graph of K bodies, one replay a block, with the same results as K
single steps. train runs full blocks while K steps remain, then single
steps, and reports a block's last step.
Counterpart of dssm_tpu/train/loop.py.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dssm_tpu_torch.bridge import batch_to_device
from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.train.compiled import CompiledStep, eager_step
from dssm_tpu_torch.train.sparse_update import (
    default_loss, make_sparse_train_step_body, uses_sparse_update)
from dssm_tpu_torch.train.state import (
    TrainState, check_dense_table, optimizer_step_)


def rotation_offsets(batch_size: int, num_negatives: int,
                     seed: int = 0) -> np.ndarray:
    """NEG distinct rotation offsets in [1, B), deterministic in the seed. A
    copy of dssm_tpu/oracle/numpy_oracle.py::rotation_offsets."""
    rng = np.random.default_rng(seed + 17)
    if num_negatives >= batch_size:
        raise ValueError("need num_negatives < batch_size")
    return rng.choice(np.arange(1, batch_size), size=num_negatives,
                      replace=False)


def make_loss_fn(cfg: RunConfig, impl: str = "auto",
                 loss_of: Optional[Callable] = None) -> Callable:
    """(params, batch) -> (loss, aux): both towers from the table on, each
    side its own tower call, then the loss (loss_of(q, d, batch), by
    default the in-batch or rotate loss on one device). Differentiable in
    every parameter, the table included. With train.remat each side's
    embed is recomputed in the backward pass instead of keeping its
    activations."""
    if loss_of is None:
        loss_of = default_loss(cfg, impl)

    def embed(params, side, batch):
        lookup = model_base.embed_table_lookup(params, cfg.tower, side, batch,
                                               impl=impl)
        return model_base.embed_from_lookup(params, cfg.tower, side, batch,
                                            lookup, impl=impl)

    def loss_fn(params, batch):
        if cfg.train.remat:
            # No random op runs in a tower, so no RNG state to keep (and a
            # CUDA generator's state cannot be read under graph capture).
            q = checkpoint(embed, params, "q", batch, use_reentrant=False,
                           preserve_rng_state=False)
            d = checkpoint(embed, params, "d", batch, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            q, d = embed(params, "q", batch), embed(params, "d", batch)
        return loss_of(q, d, batch)

    return loss_fn


def make_dense_train_step_body(cfg: RunConfig, impl: str = "auto"
                               ) -> Callable:
    """(state, batch) -> aux: one step of the dense optimizer over the whole
    parameter tree, IN PLACE (the table, the dense parameters, the
    optimizer state over both and the step counter). The batch is a
    raw-index batch on the parameters' device (bridge.batch_to_torch), as
    cli.train builds it off the sparse path; the table must be f32. The
    table's gradient is the embedding bag's d_table, a dense [V, H] f32
    segment sum."""
    table_key = model_base.TABLE_KEY[cfg.tower.arch]
    loss_fn = make_loss_fn(cfg, impl)

    def body(state: TrainState, batch: Dict) -> Dict:
        if "uniq" in batch or "q_uniq" in batch:
            raise ValueError(
                "the dense-table step takes raw-index batches: dedupe "
                "batches (data.dedup_lookup) belong to the sparse path")
        check_dense_table(state.params, table_key)
        params = {tower: {k: v.detach().requires_grad_(True)
                          for k, v in tp.items()}
                  for tower, tp in state.params.items()}
        loss, aux = loss_fn(params, batch)
        leaves = [v for tp in params.values() for v in tp.values()]
        it = iter(torch.autograd.grad(loss, leaves))
        grads = {tower: {k: next(it) for k in tp}
                 for tower, tp in params.items()}
        with torch.no_grad():
            optimizer_step_(cfg.train, state.params, grads, state.opt_state)
            state.step.add_(1)
        return aux

    return body


def make_train_step_body(cfg: RunConfig, impl: str = "auto") -> Callable:
    """(state, batch) -> aux, in place: SGD (or the AdaGrad table
    optimizer) with sparse_embed_update, the default, is the
    sparse-table-update step's body; the rest is the dense-table step's."""
    if uses_sparse_update(cfg):
        return make_sparse_train_step_body(cfg, impl)
    return make_dense_train_step_body(cfg, impl)


def make_train_step(cfg: RunConfig, impl: str = "auto") -> CompiledStep:
    """(state, batch) -> (state, aux): the config's step, compiled
    (train/compiled.py): a replayed CUDA graph on a CUDA state, eager on a
    CPU state; the state is updated in place and returned. batch: a
    bridge.WireBatch or fields on the state's device."""
    return CompiledStep(make_train_step_body(cfg, impl))


def make_multi_train_step(cfg: RunConfig, impl: str = "auto"
                          ) -> CompiledStep:
    """(state, stacked batch) -> (state, aux stacked [K]): the step body K
    times over the [K, ...] fields of a stacked batch, step j on the views
    [j] of every field, compiled as one CUDA graph of K bodies on a CUDA
    state (dssm_tpu's lax.scan). The same K steps as K calls of
    make_train_step's step (a bf16 or int8 table's scatter seeds come from
    each body's own device step counter, as in dssm_tpu's scan)."""
    return CompiledStep(make_train_step_body(cfg, impl), multi=True)


def make_eager_train_step(cfg: RunConfig, impl: str = "auto",
                          multi: bool = False) -> Callable:
    """make_train_step's (or, with multi, make_multi_train_step's) body run
    eagerly on any device: what the compiled step is held to."""
    return eager_step(make_train_step_body(cfg, impl), multi)


def stack_batches(batches: Iterable[Dict]) -> Dict:
    """Stack K host batch dicts into one dict of [K, ...] arrays for
    make_multi_train_step. All batches must share keys (same loader config).
    A copy of dssm_tpu/train/loop.py::stack_batches."""
    batches = list(batches)
    keys = batches[0].keys()
    for b in batches[1:]:
        if b.keys() != keys:
            raise ValueError("cannot stack batches with differing keys")
    return {k: np.stack([np.asarray(b[k]) for b in batches]) for k in keys}


def add_rotation_offsets(batch: Dict, cfg: RunConfig, step: int) -> Dict:
    """Rotate mode: attach deterministic per-step rotation offsets."""
    if cfg.loss.mode == "rotate":
        # Size from q_wgt: it survives compress_wire, which drops q_idx.
        b = batch["q_wgt"].shape[0]
        batch = dict(batch)
        batch["rot_offsets"] = np.asarray(
            rotation_offsets(b, cfg.loss.num_negatives, cfg.train.seed + step),
            dtype=np.int32,
        )
    return batch


def state_device(state: TrainState) -> torch.device:
    tower = next(iter(state.params.values()))
    return next(iter(tower.values())).device


def train(
    cfg: RunConfig,
    state: TrainState,
    batches: Iterator[Dict],
    num_steps: int,
    metrics_cb: Optional[Callable[[int, Dict], None]] = None,
) -> TrainState:
    """Drive num_steps steps from a stream of numpy batches. The rotation
    offsets of step i use seed train.seed + i (i counted from 0 here). At
    train.steps_per_call = K > 1, full blocks of K steps run while K steps
    remain, then single steps; metrics_cb gets a block's last step, i + K -
    1, with that step's aux when i % log_every < K, and nothing of the
    single steps of the ragged tail (dssm_tpu's train)."""
    dev = state_device(state)
    # A raw batch's live lookups must lie in the table (bridge.check_raw_rows).
    rows = next(iter(state.params.values()))[
        model_base.TABLE_KEY[cfg.tower.arch]].shape[0]
    k = cfg.train.steps_per_call
    if k > 1:
        multi_fn = make_multi_train_step(cfg)
        single_fn = make_train_step(cfg)
        i = 0
        while i < num_steps:
            if num_steps - i >= k:
                stacked = stack_batches(
                    add_rotation_offsets(next(batches), cfg, i + j)
                    for j in range(k))
                t0 = time.perf_counter()
                state, auxes = multi_fn(
                    state, batch_to_device(stacked, dev, vocab_size=rows))
                if metrics_cb is not None and (i % cfg.train.log_every < k):
                    aux = {key: float(v[-1]) for key, v in auxes.items()}
                    aux["step_ms"] = (time.perf_counter() - t0) * 1e3 / k
                    metrics_cb(i + k - 1, aux)
                i += k
            else:
                batch = add_rotation_offsets(next(batches), cfg, i)
                state, _ = single_fn(
                    state, batch_to_device(batch, dev, vocab_size=rows))
                i += 1
        return state
    step_fn = make_train_step(cfg)
    for i in range(num_steps):
        batch = add_rotation_offsets(next(batches), cfg, i)
        t0 = time.perf_counter()
        state, aux = step_fn(state, batch_to_device(batch, dev,
                                                    vocab_size=rows))
        if metrics_cb is not None and (i % cfg.train.log_every == 0):
            aux = {k: float(v) for k, v in aux.items()}  # waits for the step
            aux["step_ms"] = (time.perf_counter() - t0) * 1e3
            metrics_cb(i, aux)
    return state
