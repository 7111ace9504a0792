"""Carry weights, train states and batches across from numpy to the port.

params_from_jax takes dssm_tpu's parameter pytree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side) and returns the port's
parameters with the same keys and padded shapes; state_from_jax does the
same for a whole TrainState (step, params, the optax state of the dense
subtree), and params_to_numpy is the way back. batch_to_torch moves a numpy
batch from the loader onto a device, widening the compressed wire fields
there as dssm_tpu's lookup does.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.models.base import Params, pad_table_cols
from dssm_tpu_torch.train.state import TrainState

# Batch fields that are lookup slots or indices (widened to int32) and
# lookup weights (widened to f32).
_INDEX_SUFFIXES = ("_inv", "_idx", "_uniq", "_sel")
_INDEX_FIELDS = ("uniq", "sel")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _expected_shapes(cfg: TowerConfig) -> Dict[str, tuple]:
    dims = (cfg.embed_width, *cfg.hidden_dims, cfg.semantic_dim)
    width = pad_table_cols(np.zeros((1, cfg.embed_width), np.float32)).shape[1]
    shapes = {"W0": (cfg.vocab_size, width), "b0": (cfg.embed_width,)}
    for l in range(1, len(dims)):
        shapes[f"W{l}"] = (dims[l - 1], dims[l])
        shapes[f"b{l}"] = (dims[l],)
    return shapes


def params_from_jax(np_params: Mapping[str, Mapping[str, np.ndarray]],
                    cfg: TowerConfig, device: DeviceLike = "cuda") -> Params:
    """{"shared"|"query"|"doc": {"W0", "b0", "W1", ...}} numpy -> tensors
    on `device`, checked against the MLP config's padded shapes."""
    dev = as_device(device)
    if cfg.arch != "mlp":
        raise NotImplementedError(
            f"{cfg.arch} towers are not ported yet (ROADMAP.md, Queue 1: "
            "cnn/lstm)")
    want = _expected_shapes(cfg)
    out: Params = {}
    for tower, tp in np_params.items():
        if tower not in ("shared", "query", "doc"):
            raise KeyError(f"unexpected tower {tower!r}")
        if set(tp) != set(want):
            raise KeyError(f"tower {tower!r} has keys {sorted(tp)}, "
                           f"expected {sorted(want)}")
        out[tower] = {}
        for k, v in tp.items():
            if tuple(v.shape) != want[k]:
                raise ValueError(f"{tower}/{k}: shape {tuple(v.shape)}, "
                                 f"expected {want[k]}")
            out[tower][k] = _to_tensor(v).to(dev)
    return out


def batch_to_torch(batch: Mapping[str, np.ndarray],
                   device: DeviceLike) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on `device`. Index fields (int16 on the
    compressed wire) become int32 and weights (uint8 counts) f32."""
    dev = as_device(device)
    out = {}
    for k, v in batch.items():
        # Move the (possibly compressed) field first, widen on the device.
        t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        if k in _INDEX_FIELDS or k.endswith(_INDEX_SUFFIXES):
            t = t.to(torch.int32)
        elif k.endswith("_wgt"):
            t = t.to(torch.float32)
        out[k] = t
    return out


def optax_field(opt_state: Any, name: str) -> Any:
    """The first optax sub-state (a namedtuple in a tuple chain) that has
    field `name`, e.g. `trace` or `mu`."""
    if name in getattr(opt_state, "_fields", ()):
        return getattr(opt_state, name)
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = optax_field(sub, name)
            if found is not None:
                return found
    return None


def state_from_jax(step: int, np_params: Mapping, np_opt_state: Any,
                   cfg, device: DeviceLike = "cuda") -> TrainState:
    """dssm_tpu's TrainState as numpy (``jax.tree.map(np.asarray, state)``:
    its step, params and opt_state) -> the port's TrainState on `device`.
    The optax state of sgd is empty, of sgd-with-momentum a trace tree, of
    adam a count and the mu / nu trees, each over the dense subtree."""
    dev = as_device(device)

    def tree(t):
        return {tower: {k: _to_tensor(np.asarray(v)).to(dev)
                        for k, v in tp.items()} for tower, tp in t.items()}

    opt = cfg.train.optimizer
    if opt == "sgd":
        opt_state: Dict[str, Any] = {}
    elif opt == "momentum":
        opt_state = {"trace": tree(optax_field(np_opt_state, "trace"))}
    elif opt == "adam":
        opt_state = {"count": int(optax_field(np_opt_state, "count")),
                     "mu": tree(optax_field(np_opt_state, "mu")),
                     "nu": tree(optax_field(np_opt_state, "nu"))}
    else:
        raise ValueError(f"unknown optimizer {opt!r}")
    return TrainState(step=int(step),
                      params=params_from_jax(np_params, cfg.tower, dev),
                      opt_state=opt_state)


def params_to_numpy(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's parameters as float32 numpy arrays (bf16 widened)."""
    return {tower: {k: v.detach().float().cpu().numpy()
                    for k, v in tp.items()} for tower, tp in params.items()}
