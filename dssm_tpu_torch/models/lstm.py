"""LSTM-DSSM towers (the `lstm` preset).

An LSTM reads the word sequence (each word a letter-trigram bag); the
hidden state at the last real word is the sentence embedding. Counterpart
of dssm_tpu/models/lstm.py: each word's trigrams are projected by the
first-layer lookup (models/base.bag_lookup), all input projections are one
matmul over [B*T, E], and the recurrence is a Python loop over the T
time-major steps in the compute dtype (the reference's lax.scan). Padding
steps carry the state through, so the final state is each row's state at
its last real word. No TPU kernel of the reference covers the recurrence
(XLA ran it there); its products are torch.matmul here.
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
    v, e, h, d = (cfg.vocab_size, cfg.embed_width, cfg.lstm_hidden,
                  cfg.semantic_dim)
    return {"Win": (v, -(-e // LANE) * LANE), "bin": (e,), "Wx": (e, 4 * h),
            "Wh": (h, 4 * h), "bh": (4 * h,), "Ws": (h, d), "bs": (d,)}


def init_tower(cfg: TowerConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """One tower's parameters as numpy arrays, bit-identical to dssm_tpu's
    (the same rng calls in the same order); Win padded to 128 columns."""
    rng = np.random.default_rng(seed)
    v, e, h, d = (cfg.vocab_size, cfg.embed_width, cfg.lstm_hidden,
                  cfg.semantic_dim)

    def uniform(nin, nout, shape):
        r = np.sqrt(6.0 / (nin + nout))
        return rng.uniform(-r, r, size=shape).astype(cfg.param_dtype)

    return {
        "Win": pad_table_cols(uniform(v, e, (v, e))),
        "bin": uniform(v, e, (e,)),
        "Wx": uniform(e, 4 * h, (e, 4 * h)),
        "Wh": uniform(h, 4 * h, (h, 4 * h)),
        "bh": np.zeros((4 * h,), dtype=cfg.param_dtype),
        "Ws": uniform(h, d, (h, d)),
        "bs": uniform(h, d, (d,)),
    }


def table_lookup(params: Dict[str, torch.Tensor], cfg: TowerConfig,
                 batch: Dict[str, torch.Tensor], prefix: str, *,
                 impl: str = "auto") -> torch.Tensor:
    """Per-word trigram projection: [B, T, Kw] -> [B, T, Win's padded
    width] in the compute dtype."""
    return bag_lookup(params["Win"], cfg, batch, prefix, impl=impl,
                      scale=params.get("Win_scale"))


def tower_from_lookup(params: Dict[str, torch.Tensor], cfg: TowerConfig,
                      batch: Dict[str, torch.Tensor], prefix: str,
                      lookup: torch.Tensor, *,
                      impl: str = "auto") -> torch.Tensor:
    """Input activation, the recurrence, semantic layer, unit norm.
    Differentiable in lookup and params (which may lack Win). Gates and
    states are computed in the compute dtype, products returned in it, as
    the reference's preferred_element_type=compute_dtype."""
    mask = batch[f"{prefix}_mask"]  # [B, T]
    b, t, _ = lookup.shape
    hdim = cfg.lstm_hidden
    cd = torch_dtype(cfg.compute_dtype)

    lookup = lookup[..., : cfg.embed_width]  # drop padding columns
    x = activate(lookup + params["bin"].to(cd), cfg.activation)  # [B, T, E]
    wx, wh, bh = (params[k].to(cd) for k in ("Wx", "Wh", "bh"))
    # All input projections in one matmul: [B*T, 4H], then time-major.
    xp = (x.reshape(b * t, -1) @ wx).reshape(b, t, 4 * hdim).transpose(0, 1)
    mask_t = mask.T[..., None].to(cd)  # [T, B, 1]

    h = lookup.new_zeros((b, hdim), dtype=cd)
    c = lookup.new_zeros((b, hdim), dtype=cd)
    for s in range(t):
        gates = xp[s] + h @ wh + bh
        i, f, g, o = gates.split(hdim, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        # Padding steps (m = 0) carry the state through.
        m = mask_t[s]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c

    y = activate(h @ params["Ws"].to(cd) + params["bs"].to(cd),
                 cfg.activation)
    return l2_normalize(y.float())


class LSTMTower(Tower):
    """One LSTM tower over {Win (table), bin, Wx, Wh, bh, Ws, bs} for
    serving (models/base.Tower)."""

    lookup_fn = staticmethod(table_lookup)
    rest_fn = staticmethod(tower_from_lookup)
