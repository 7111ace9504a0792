"""Dense tower layers: matmul + bias + activation (+ final L2 normalize).

`dense_tower` dispatches to the fused CUDA forward (csrc/tower.cu), the
counterpart of dssm_tpu/kernels/pallas_tower.py::dense_tower_pallas.
`dense_tower_plain` repeats that kernel's arithmetic in plain PyTorch: f32
accumulation, f32 bias and activation, the activation cast back to the input
dtype between layers, and f32 on the last layer. (dssm_tpu's
dense_tower_xla differs: its bf16 products return bf16.)
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "dense_tower"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"tanh": 0, "relu": 1}
_MAX_LAYERS = 8  # DSSM_TOWER_MAX_LAYERS in csrc/tower.cu
EPS = 1e-12

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def activate(z: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "tanh":
        return torch.tanh(z)
    if activation == "relu":
        return torch.clamp_min(z, 0.0)
    raise ValueError(activation)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def dense_tower_plain(x: torch.Tensor, layers: Layers,
                      activation: str = "tanh",
                      normalize: bool = True) -> torch.Tensor:
    """x [B, H0] -> activated dense layers -> [B, D] f32."""
    h = x
    for i, (w, b) in enumerate(layers):
        a = activate(h.float() @ w.float() + b.float(), activation)
        h = a.to(x.dtype) if i + 1 < len(layers) else a
    h = h.float()
    return l2_normalize(h) if normalize else h


def dense_tower(x: torch.Tensor, layers: Layers, activation: str = "tanh",
                normalize: bool = True, *, impl: str = "auto") -> torch.Tensor:
    """Fused forward of the whole tower; y [B, D] f32."""
    if _build.resolve_impl(impl, x, _NAME) == "plain":
        return dense_tower_plain(x, layers, activation, normalize)
    if x.dtype not in _DTYPE_CODE or x.dim() != 2:
        raise ValueError(f"{_NAME}: x must be 2-D f32 or bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 1 <= len(layers) <= _MAX_LAYERS:
        raise ValueError(f"{_NAME}: 1 to {_MAX_LAYERS} layers, got "
                         f"{len(layers)}")
    if activation not in _ACT_CODE:
        raise ValueError(activation)
    dims = [x.shape[1]]
    for w, b in layers:
        if (w.dtype != x.dtype or b.dtype != x.dtype or w.dim() != 2
                or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],)):
            raise ValueError(f"{_NAME}: layer {len(dims) - 1} has W "
                             f"{w.dtype} {tuple(w.shape)}, b {b.dtype} "
                             f"{tuple(b.shape)} after width {dims[-1]} "
                             f"{x.dtype}")
        dims.append(w.shape[1])
    _build.check_cuda(_NAME, x.device, x, *[t for layer in layers
                                            for t in layer])
    y = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32,
                    device=x.device)
    if x.shape[0] == 0:
        return y
    n = len(layers)
    ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in layers])
    bs = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
    cdims = (ctypes.c_int * (n + 1))(*dims)
    _build.launch(_NAME, "dssm_dense_tower", x.device, x.data_ptr(),
                  y.data_ptr(), ws, bs, cdims, n, x.shape[0],
                  _DTYPE_CODE[x.dtype], _ACT_CODE[activation],
                  int(normalize), EPS)
    return y
