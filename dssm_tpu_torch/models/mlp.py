"""MLP-DSSM towers (the `tiny` and `full` presets).

Bag-of-trigrams input -> V x embed_width sparse first layer (the table
lookup) -> dense hidden layers -> semantic_dim, activation at every layer,
unit-norm output. Counterpart of dssm_tpu/models/mlp.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.kernels.tower import activate, dense_tower, l2_normalize
from dssm_tpu_torch.models import init
from dssm_tpu_torch.models.base import bag_lookup, pad_table_cols, torch_dtype


def layer_dims(cfg: TowerConfig):
    return (cfg.embed_width, *cfg.hidden_dims, cfg.semantic_dim)


def init_tower(cfg: TowerConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One tower's parameters as numpy arrays, W0 padded to 128 columns."""
    np_params = init.init_params(cfg.vocab_size, layer_dims(cfg), seed=seed)
    np_params["W0"] = pad_table_cols(np_params["W0"])
    return np_params


def table_lookup(params: Dict[str, torch.Tensor], cfg: TowerConfig,
                 batch: Dict[str, torch.Tensor], prefix: str, *,
                 impl: str = "auto") -> torch.Tensor:
    """First-layer embedding bag: [B, K] sparse text -> [B, H_pad] in the
    compute dtype. The table is gathered at its storage dtype and only the
    small result is cast."""
    return bag_lookup(params["W0"], cfg, batch, prefix, impl=impl)


def tower_from_lookup(params: Dict[str, torch.Tensor], cfg: TowerConfig,
                      batch: Dict[str, torch.Tensor], prefix: str,
                      lookup: torch.Tensor, *,
                      impl: str = "auto") -> torch.Tensor:
    """Rest of the tower given the table lookup output. `params` may be the
    dense subtree without W0 (the sparse-update step), so the layers are
    enumerated by key presence. Differentiable in lookup and params."""
    cd = torch_dtype(cfg.compute_dtype)
    lookup = lookup[..., : cfg.embed_width]  # drop padding columns
    # Layer 0's bias and activation run outside the dense tower.
    h = activate(lookup + params["b0"].to(cd), cfg.activation)
    layers = []
    l = 1
    while f"W{l}" in params:
        layers.append((params[f"W{l}"].to(cd), params[f"b{l}"].to(cd)))
        l += 1
    if layers:
        y = dense_tower(h.to(cd).contiguous(), layers, cfg.activation,
                        normalize=False, impl=impl)
    else:
        y = h
    # Normalize in f32 for stable cosine geometry even under bf16 compute.
    return l2_normalize(y.float())


class MLPTower(nn.Module):
    """One tower over a parameter dict {W0 (table), b0, W1, b1, ...}, for
    serving: the tensors are held as frozen parameters without a copy.
    Training calls table_lookup / tower_from_lookup on plain dicts, whose
    tensors may require grad."""

    def __init__(self, cfg: TowerConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, t in params.items():
            self.register_parameter(
                name, nn.Parameter(t.detach(), requires_grad=False))

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def table_lookup(self, batch: Dict[str, torch.Tensor], prefix: str, *,
                     impl: str = "auto") -> torch.Tensor:
        return table_lookup(self._params(), self.cfg, batch, prefix,
                            impl=impl)

    def tower_from_lookup(self, batch: Dict[str, torch.Tensor], prefix: str,
                          lookup: torch.Tensor, *,
                          impl: str = "auto") -> torch.Tensor:
        return tower_from_lookup(self._params(), self.cfg, batch, prefix,
                                 lookup, impl=impl)

    def forward(self, batch: Dict[str, torch.Tensor], prefix: str, *,
                impl: str = "auto") -> torch.Tensor:
        lookup = self.table_lookup(batch, prefix, impl=impl)
        return self.tower_from_lookup(batch, prefix, lookup, impl=impl)
