"""Single-device train step and loop.

make_train_step routes a config to its step; train drives it over a batch
stream, moving each numpy batch to the parameters' device. PyTorch runs the
step eagerly, so there is no compiled K-steps-per-dispatch variant:
train.steps_per_call > 1 runs the single step K times in a Python loop, with
the same semantics as dssm_tpu's scanned multi-step. Counterpart of
dssm_tpu/train/loop.py.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.train.sparse_update import (
    make_sparse_train_step, uses_sparse_update)
from dssm_tpu_torch.train.state import TrainState


def rotation_offsets(batch_size: int, num_negatives: int,
                     seed: int = 0) -> np.ndarray:
    """NEG distinct rotation offsets in [1, B), deterministic in the seed. A
    copy of dssm_tpu/oracle/numpy_oracle.py::rotation_offsets."""
    rng = np.random.default_rng(seed + 17)
    if num_negatives >= batch_size:
        raise ValueError("need num_negatives < batch_size")
    return rng.choice(np.arange(1, batch_size), size=num_negatives,
                      replace=False)


def make_train_step(cfg: RunConfig, impl: str = "auto") -> Callable:
    """(state, batch) -> (state, aux). SGD + sparse_embed_update (the
    default) is the sparse-table-update step."""
    if uses_sparse_update(cfg):
        return make_sparse_train_step(cfg, impl)
    raise NotImplementedError(
        "the dense-table train step (train.sparse_embed_update=False, or "
        "momentum/adam with the sgd table optimizer) is not ported yet "
        "(ROADMAP.md, Queue 1: the dense-table train step)")


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
    offsets of step i use seed train.seed + i (i counted from 0 here)."""
    step_fn = make_train_step(cfg)
    dev = state_device(state)
    for i in range(num_steps):
        batch = add_rotation_offsets(next(batches), cfg, i)
        t0 = time.perf_counter()
        state, aux = step_fn(state, batch_to_torch(batch, dev))
        if metrics_cb is not None and (i % cfg.train.log_every == 0):
            aux = {k: float(v) for k, v in aux.items()}  # waits for the step
            aux["step_ms"] = (time.perf_counter() - t0) * 1e3
            metrics_cb(i, aux)
    return state
