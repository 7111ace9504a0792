"""Carry weights and batches across from numpy to the port.

params_from_jax takes dssm_tpu's parameter pytree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)`` on the JAX side) and returns the port's
parameters with the same keys and padded shapes. batch_to_torch moves a
numpy batch from the loader onto a device, widening the compressed wire
fields as dssm_tpu's lookup does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.models.base import Params, pad_table_cols

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
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in _INDEX_FIELDS or k.endswith(_INDEX_SUFFIXES):
            t = t.to(torch.int32)
        elif k.endswith("_wgt"):
            t = t.to(torch.float32)
        out[k] = t.to(dev)
    return out
