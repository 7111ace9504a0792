"""Seeded numpy initialisation of one MLP tower's parameters.

A copy of dssm_tpu/oracle/numpy_oracle.py::init_params, so both packages
start from bit-identical weights for the same seed.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

Params = Dict[str, np.ndarray]


def init_params(
    vocab_size: int,
    layer_dims: Sequence[int],
    seed: int = 0,
    dtype=np.float32,
) -> Params:
    """Uniform fan-in/fan-out init:
    U(-sqrt(6/(nin+nout)), +sqrt(6/(nin+nout))).

    layer_dims e.g. (300, 300, 128) builds V->300->300->128.
    """
    rng = np.random.default_rng(seed)
    dims = [vocab_size, *layer_dims]
    params: Params = {}
    for l in range(len(dims) - 1):
        nin, nout = dims[l], dims[l + 1]
        r = np.sqrt(6.0 / (nin + nout))
        params[f"W{l}"] = rng.uniform(-r, r, size=(nin, nout)).astype(dtype)
        params[f"b{l}"] = rng.uniform(-r, r, size=(nout,)).astype(dtype)
    return params
