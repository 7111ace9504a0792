"""Two-tower model interface, counterpart of dssm_tpu/models/base.py.

    init_params(tower_cfg, seed, device)    -> {"shared": {W0, b0, ...}}
    embed(params, tower_cfg, side, batch)   -> [B, semantic_dim] unit vectors

`side` is "q" or "d". With shared_weights=True both sides read
params["shared"]; otherwise params["query"] / params["doc"]. Parameters are
plain dicts of tensors with dssm_tpu's keys and padded shapes, so weights
carry across (bridge.params_from_jax).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dssm_tpu_torch.config import TowerConfig
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.kernels.dedup_embed import dedup_embedding_bag
from dssm_tpu_torch.kernels.gather import sublane_group

Params = Dict[str, Dict[str, torch.Tensor]]

# The single sparse first-layer table of each model family.
TABLE_KEY = {"mlp": "W0", "cnn": "Wc", "lstm": "Win"}

LANE = 128  # table columns are padded to a multiple of this

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype {name!r} is not ported yet (ROADMAP.md, Queue 1: the "
            "bf16 and int8 tables)")
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


def _check_ported(cfg: TowerConfig) -> None:
    if cfg.arch != "mlp":
        raise NotImplementedError(
            f"{cfg.arch} towers are not ported yet (ROADMAP.md, Queue 1: "
            "cnn/lstm)")
    if cfg.table_dtype_resolved != cfg.param_dtype:
        raise NotImplementedError(
            f"table_dtype {cfg.table_dtype_resolved!r} is not ported yet "
            "(ROADMAP.md, Queue 1: the bf16 and int8 tables)")


def tower_params(params: Params, side: str) -> Dict[str, torch.Tensor]:
    if "shared" in params:
        return params["shared"]
    return params["query" if side == "q" else "doc"]


def init_params(cfg: TowerConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Params:
    """Seeded fresh parameters on `device`, bit-identical to dssm_tpu's
    init_params for the same config and seed."""
    from dssm_tpu_torch.models import mlp

    _check_ported(cfg)
    dev = as_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def one(s):
        return {k: torch.from_numpy(v).to(device=dev, dtype=dtype)
                for k, v in mlp.init_tower(cfg, s).items()}

    if cfg.shared_weights:
        return {"shared": one(seed)}
    return {"query": one(seed), "doc": one(seed + 1)}


def tower_module(params: Params, cfg: TowerConfig, side: str):
    """The nn.Module of one side's tower over `params` (no copy)."""
    from dssm_tpu_torch.models import mlp

    _check_ported(cfg)
    return mlp.MLPTower(cfg, tower_params(params, side))


def bag_lookup(table: torch.Tensor, cfg: TowerConfig,
               batch: Dict[str, torch.Tensor], prefix: str,
               impl: str = "auto") -> torch.Tensor:
    """First-layer lookup through the dedup compact gather + count lookup,
    output in the compute dtype."""
    compute_dtype = torch_dtype(cfg.compute_dtype)
    if "uniq" not in batch and f"{prefix}_uniq" not in batch:
        raise NotImplementedError(
            "raw-index batches (no dedup fields) need the sparse_embed / "
            "pallas_embed lookup, not ported yet (ROADMAP.md, Queue 2: "
            "embedding_bag_pallas); use data.dedup_lookup=True")
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
    )
    return out.to(compute_dtype)


def embed(params: Params, cfg: TowerConfig, side: str,
          batch: Dict[str, torch.Tensor], *, impl: str = "auto") -> torch.Tensor:
    """batch carries the dedup fields of {side} (bridge.batch_to_torch)."""
    return tower_module(params, cfg, side)(batch, side, impl=impl)


def embed_table_lookup(params: Params, cfg: TowerConfig, side: str,
                       batch: Dict[str, torch.Tensor], *,
                       impl: str = "auto") -> torch.Tensor:
    """The first-layer embedding bag only, before bias and activation."""
    from dssm_tpu_torch.models import mlp

    _check_ported(cfg)
    return mlp.table_lookup(tower_params(params, side), cfg, batch, side,
                            impl=impl)


def embed_from_lookup(params: Params, cfg: TowerConfig, side: str,
                      batch: Dict[str, torch.Tensor], lookup: torch.Tensor, *,
                      impl: str = "auto") -> torch.Tensor:
    """Rest of the tower given the table lookup output; touches no table, so
    `params` may be the dense subtree (no W0) and may require grad."""
    from dssm_tpu_torch.models import mlp

    _check_ported(cfg)
    return mlp.tower_from_lookup(tower_params(params, side), cfg, batch,
                                 side, lookup, impl=impl)
