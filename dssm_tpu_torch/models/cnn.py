"""CNN-DSSM (CLSM) towers (the `cnn` preset).

A sliding window of `conv_window` word-trigram vectors is projected to
`conv_channels` feature maps with tanh, max-pooled over the words, then a
dense semantic layer. Counterpart of dssm_tpu/models/cnn.py, in its
formulation: the convolution over window-concatenated trigram vectors is one
weighted embedding bag per word through a position-blocked table
Wc [V, window * C] (slot p holds the V -> C map of the word at window
offset p), followed by shifted adds. The bag is the first-layer lookup of
models/base.bag_lookup; the rest is eager PyTorch (no TPU kernel of the
reference covers it: XLA ran it there).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.kernels.tower import activate, l2_normalize
from dssm_tpu_torch.models.base import (
    LANE, Tower, bag_lookup, pad_table_cols, torch_dtype)


def param_shapes(cfg: TowerConfig) -> Dict[str, tuple]:
    """Keys and (padded) shapes of one tower's parameters."""
    v, w, c, d = (cfg.vocab_size, cfg.conv_window, cfg.conv_channels,
                  cfg.semantic_dim)
    return {"Wc": (v, -(-w * c // LANE) * LANE), "bc": (c,), "Ws": (c, d),
            "bs": (d,)}


def init_tower(cfg: TowerConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One tower's parameters as numpy arrays, bit-identical to dssm_tpu's
    (the same rng calls in the same order); Wc padded to 128 columns."""
    rng = np.random.default_rng(seed)
    v, w, c, d = (cfg.vocab_size, cfg.conv_window, cfg.conv_channels,
                  cfg.semantic_dim)

    def uniform(nin, nout, shape):
        r = np.sqrt(6.0 / (nin + nout))
        return rng.uniform(-r, r, size=shape).astype(cfg.param_dtype)

    return {
        "Wc": pad_table_cols(uniform(v * w, c, (v, w * c))),
        "bc": uniform(v * w, c, (c,)),
        "Ws": uniform(c, d, (c, d)),
        "bs": uniform(c, d, (d,)),
    }


def table_lookup(params: Dict[str, torch.Tensor], cfg: TowerConfig,
                 batch: Dict[str, torch.Tensor], prefix: str, *,
                 impl: str = "auto") -> torch.Tensor:
    """Per-word window-blocked projection: [B, T, Kw] -> [B, T, Wc's
    padded width] in the compute dtype."""
    return bag_lookup(params["Wc"], cfg, batch, prefix, impl=impl,
                      scale=params.get("Wc_scale"))


def tower_from_lookup(params: Dict[str, torch.Tensor], cfg: TowerConfig,
                      batch: Dict[str, torch.Tensor], prefix: str,
                      lookup: torch.Tensor, *,
                      impl: str = "auto") -> torch.Tensor:
    """Window combine, bias and activation, masked max-pool over the words,
    semantic layer, unit norm. Differentiable in lookup and params (which
    may lack Wc). Roundings fall where the reference's do: under bf16
    compute the shifted adds, the pool and the semantic product are bf16."""
    mask = batch[f"{prefix}_mask"]  # [B, T]
    b, t, _ = lookup.shape
    w, c = cfg.conv_window, cfg.conv_channels
    cd = torch_dtype(cfg.compute_dtype)

    feat = lookup[..., : w * c].reshape(b, t, w, c)  # drop padding columns
    # h[:, t] = sum_p feat[:, t + p - w//2, p], summed from p = 0 as the
    # reference's Python sum; padding words have all-zero weights, so
    # out-of-sentence slots contribute zeros.
    half = w // 2
    pad = feat.new_zeros((b, half, w, c))
    fp = torch.cat([pad, feat, pad], dim=1)  # [B, T + 2*half, w, C]
    h = sum(fp[:, p: p + t, p, :] for p in range(w))
    h = activate(h + params["bc"].to(cd), cfg.activation)
    # Masked max-pool over time (CLSM section 3.3). A text with no words
    # pools to -1e9, as in the reference.
    h = h.masked_fill(mask[..., None] <= 0, -1e9)
    pooled = h.amax(dim=1)  # [B, C]
    y = activate(pooled @ params["Ws"].to(cd) + params["bs"].to(cd),
                 cfg.activation)
    return l2_normalize(y.float())


class CNNTower(Tower):
    """One CNN tower over {Wc (table), bc, Ws, bs} for serving (models/base.
    Tower)."""

    lookup_fn = staticmethod(table_lookup)
    rest_fn = staticmethod(tower_from_lookup)
