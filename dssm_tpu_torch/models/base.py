"""Two-tower model interface, counterpart of dssm_tpu/models/base.py.

    init_params(tower_cfg, seed, device)    -> {"shared": {W0, b0, ...}}
    embed(params, tower_cfg, side, batch)   -> [B, semantic_dim] unit vectors

for every model family: mlp (models/mlp.py), cnn (models/cnn.py) and lstm
(models/lstm.py), each with one sparse first-layer table (TABLE_KEY) read by
bag_lookup. `side` is "q" or "d". With shared_weights=True both sides read
params["shared"]; otherwise params["query"] / params["doc"]. Parameters are
plain dicts of tensors with dssm_tpu's keys and padded shapes, so weights
carry across (bridge.params_from_jax).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.kernels.dedup_embed import dedup_embedding_bag
from dssm_tpu_torch.kernels.sparse_embed import embedding_bag
from dssm_tpu_torch.kernels.gather import sublane_group

Params = Dict[str, Dict[str, torch.Tensor]]

# The single sparse first-layer table of each model family.
TABLE_KEY = {"mlp": "W0", "cnn": "Wc", "lstm": "Win"}

LANE = 128  # table columns are padded to a multiple of this

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r} (one of {sorted(_DTYPES)})")
    return _DTYPES[name]


def pad_table_cols(arr: np.ndarray, lane: int = LANE) -> np.ndarray:
    """Pad a [V, H] numpy table to H_pad = ceil(H/lane)*lane with zero
    columns. The port keeps dssm_tpu's padded shape so both packages take
    identical weights; the lookup output is sliced back to H."""
    v, h = arr.shape
    pad = (-h) % lane
    if pad == 0:
        return arr
    return np.concatenate([arr, np.zeros((v, pad), dtype=arr.dtype)], axis=1)


def arch_module(cfg: TowerConfig):
    """The model module of cfg.arch: init_tower, param_shapes, table_lookup,
    tower_from_lookup and its Tower class."""
    from dssm_tpu_torch.models import cnn, lstm, mlp

    mods = {"mlp": mlp, "cnn": cnn, "lstm": lstm}
    if cfg.arch not in mods:
        raise ValueError(f"unknown tower.arch {cfg.arch!r}")
    return mods[cfg.arch]


class Tower(nn.Module):
    """One tower over a parameter dict, for serving: the tensors are held
    as frozen parameters without a copy. A model family's subclass names
    its table_lookup / tower_from_lookup functions (lookup_fn, rest_fn).
    Training calls those functions on plain dicts, whose tensors may
    require grad."""

    lookup_fn = None
    rest_fn = None

    def __init__(self, cfg: TowerConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, t in params.items():
            self.register_parameter(
                name, nn.Parameter(t.detach(), requires_grad=False))

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    @property
    def table(self) -> torch.Tensor:
        return getattr(self, TABLE_KEY[self.cfg.arch])

    def table_lookup(self, batch: Dict[str, torch.Tensor], prefix: str, *,
                     impl: str = "auto") -> torch.Tensor:
        return self.lookup_fn(self._params(), self.cfg, batch, prefix,
                              impl=impl)

    def tower_from_lookup(self, batch: Dict[str, torch.Tensor], prefix: str,
                          lookup: torch.Tensor, *,
                          impl: str = "auto") -> torch.Tensor:
        return self.rest_fn(self._params(), self.cfg, batch, prefix, lookup,
                            impl=impl)

    def forward(self, batch: Dict[str, torch.Tensor], prefix: str, *,
                impl: str = "auto") -> torch.Tensor:
        lookup = self.table_lookup(batch, prefix, impl=impl)
        return self.tower_from_lookup(batch, prefix, lookup, impl=impl)


def tower_params(params: Params, side: str) -> Dict[str, torch.Tensor]:
    if "shared" in params:
        return params["shared"]
    return params["query" if side == "q" else "doc"]


def init_params(cfg: TowerConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Seeded fresh parameters on `device`, bit-identical to dssm_tpu's
    init_params for the same config and seed. The table may have a storage
    dtype of its own (tower.table_dtype): bf16 is a cast; int8 is
    round-to-nearest onto a per-row grid, scale = row absmax * headroom /
    127 kept as the f32 [V, 1] parameter `<table>_scale` (a zero row gets
    scale 0 and dequantizes to exact zero). Training then updates the table
    with stochastic rounding."""
    init_tower = arch_module(cfg).init_tower
    dev = as_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    key = TABLE_KEY[cfg.arch]
    table_dtype = torch_dtype(cfg.table_dtype_resolved)

    def one(s):
        tp = {k: torch.from_numpy(v).to(device=dev, dtype=dtype)
              for k, v in init_tower(cfg, s).items()}
        if table_dtype == torch.int8:
            w = tp[key].float()
            absmax = w.abs().amax(dim=1, keepdim=True)
            scale = absmax * (cfg.table_int8_headroom / 127.0)
            q = torch.where(scale > 0,
                            torch.round(w / scale.clamp_min(1e-30)), 0.0)
            tp[key] = q.clamp(-127, 127).to(torch.int8)
            tp[f"{key}_scale"] = scale
        elif table_dtype != dtype:
            tp[key] = tp[key].to(table_dtype)
        return tp

    if cfg.shared_weights:
        return {"shared": one(seed)}
    return {"query": one(seed), "doc": one(seed + 1)}


def tower_module(params: Params, cfg: TowerConfig, side: str):
    """The nn.Module of one side's tower over `params` (no copy)."""
    arch = arch_module(cfg)
    return getattr(arch, f"{cfg.arch.upper()}Tower")(
        cfg, tower_params(params, side))


def bag_lookup(table: torch.Tensor, cfg: TowerConfig,
               batch: Dict[str, torch.Tensor], prefix: str,
               impl: str = "auto",
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-layer lookup, output in the compute dtype: the dedup compact
    gather + count lookup when the batch carries dedupe fields, else the
    raw-index embedding bag over {prefix}_idx / _wgt. `scale`: an int8
    table's per-row scale (dedupe path only, as config.validate requires)."""
    compute_dtype = torch_dtype(cfg.compute_dtype)
    if "uniq" not in batch and f"{prefix}_uniq" not in batch:
        out = embedding_bag(table, batch[f"{prefix}_idx"],
                            batch[f"{prefix}_wgt"], impl=impl)
        return out.to(compute_dtype)
    joint = "uniq" in batch
    out = dedup_embedding_bag(
        table,
        batch["uniq"] if joint else batch[f"{prefix}_uniq"],
        batch[f"{prefix}_inv"],
        batch[f"{prefix}_wgt"],
        compute_dtype,
        group=sublane_group(table.dtype),
        impl=impl,
        row_sel=batch["sel"] if joint else batch.get(f"{prefix}_sel"),
        scale=scale,
    )
    return out.to(compute_dtype)


def embed(params: Params, cfg: TowerConfig, side: str,
          batch: Dict[str, torch.Tensor], *, impl: str = "auto") -> torch.Tensor:
    """batch carries {side}'s lookup fields, dedupe or raw (+ {side}_mask
    for cnn/lstm), as bridge.batch_to_torch moves them."""
    return tower_module(params, cfg, side)(batch, side, impl=impl)


def embed_table_lookup(params: Params, cfg: TowerConfig, side: str,
                       batch: Dict[str, torch.Tensor], *,
                       impl: str = "auto") -> torch.Tensor:
    """The first-layer embedding bag only, before bias and activation."""
    return arch_module(cfg).table_lookup(tower_params(params, side), cfg,
                                         batch, side, impl=impl)


def embed_from_lookup(params: Params, cfg: TowerConfig, side: str,
                      batch: Dict[str, torch.Tensor], lookup: torch.Tensor, *,
                      impl: str = "auto") -> torch.Tensor:
    """Rest of the tower given the table lookup output; touches no table, so
    `params` may be the dense subtree (no table) and may require grad."""
    return arch_module(cfg).tower_from_lookup(tower_params(params, side), cfg,
                                              batch, side, lookup, impl=impl)
