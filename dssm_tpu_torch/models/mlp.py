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


class MLPTower(nn.Module):
    """One tower over a parameter dict {W0 (table), b0, W1, b1, ...}.

    The tensors are held as frozen parameters without a copy. The table
    lookup is the differentiation boundary of sparse training, so it is
    split from the rest of the tower as in dssm_tpu.
    """

    def __init__(self, cfg: TowerConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        self.num_dense = 0
        while f"W{self.num_dense + 1}" in params:
            self.num_dense += 1
        for name, t in params.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def table_lookup(self, batch: Dict[str, torch.Tensor], prefix: str, *,
                     impl: str = "auto") -> torch.Tensor:
        """First-layer embedding bag: [B, K] sparse text -> [B, H_pad] in
        the compute dtype. The table is gathered at its storage dtype and
        only the small result is cast."""
        return bag_lookup(self.W0, self.cfg, batch, prefix, impl=impl)

    def tower_from_lookup(self, batch: Dict[str, torch.Tensor], prefix: str,
                          lookup: torch.Tensor, *,
                          impl: str = "auto") -> torch.Tensor:
        cd = self.compute_dtype
        lookup = lookup[..., : self.cfg.embed_width]  # drop padding columns
        # Layer 0's bias and activation run outside the dense tower.
        h = activate(lookup + self.b0.to(cd), self.cfg.activation)
        layers = [(getattr(self, f"W{l}").to(cd), getattr(self, f"b{l}").to(cd))
                  for l in range(1, self.num_dense + 1)]
        if layers:
            y = dense_tower(h.to(cd).contiguous(), layers, self.cfg.activation,
                            normalize=False, impl=impl)
        else:
            y = h
        # Normalize in f32 for stable cosine geometry even under bf16 compute.
        return l2_normalize(y.float())

    def forward(self, batch: Dict[str, torch.Tensor], prefix: str, *,
                impl: str = "auto") -> torch.Tensor:
        lookup = self.table_lookup(batch, prefix, impl=impl)
        return self.tower_from_lookup(batch, prefix, lookup, impl=impl)
