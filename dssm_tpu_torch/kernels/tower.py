"""Dense tower layers: matmul + bias + activation (+ final L2 normalize).

`dense_tower` dispatches to the fused CUDA forward (csrc/tower.cu), the
counterpart of dssm_tpu/kernels/pallas_tower.py::dense_tower_pallas.
`dense_tower_plain` repeats that kernel's arithmetic in plain PyTorch: f32
accumulation, f32 bias and activation, the activation cast back to the input
dtype between layers, and f32 on the last layer. (dssm_tpu's
dense_tower_xla differs: its bf16 products return bf16.)

Under autograd both run inside one autograd.Function, as the reference's
custom VJP: the forward (kernel or plain) also returns every layer's f32
activation as a residual, and the backward is the reference's _tower_bwd,
plain matmuls over those residuals with no forward recompute. It reads the
f32 activations, not the rounded copies that fed the next layer.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "dense_tower"
_RESIDUALS = "dense_tower_residuals"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"tanh": 0, "relu": 1}
_MAX_LAYERS = 8  # DSSM_TOWER_MAX_LAYERS in csrc/tower.cu
# The widest layer input (bytes a row) the kernel keeps in shared memory
# (kTileBytes in csrc/tower.cu). A wider one is read back from the layers'
# f32 residuals, so the kernel is then always given them.
_TILE_BYTES = 6144
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


def dense_tower_residuals_plain(x: torch.Tensor, layers: Layers,
                                activation: str = "tanh",
                                normalize: bool = True):
    """Plain PyTorch version of the residual-writing forward:
    (y [B, D] f32, hs: each layer's f32 activation)."""
    h = x
    hs: List[torch.Tensor] = []
    for i, (w, b) in enumerate(layers):
        a = activate(h.float() @ w.float() + b.float(), activation)
        hs.append(a)
        h = a.to(x.dtype) if i + 1 < len(layers) else a
    h = h.float()
    return (l2_normalize(h) if normalize else h), hs


def dense_tower_plain(x: torch.Tensor, layers: Layers,
                      activation: str = "tanh",
                      normalize: bool = True) -> torch.Tensor:
    """x [B, H0] -> activated dense layers -> [B, D] f32 (forward only)."""
    return dense_tower_residuals_plain(x, layers, activation, normalize)[0]


def _check(x: torch.Tensor, layers: Layers, activation: str) -> List[int]:
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
    return dims


def _forward_kernel(x: torch.Tensor, layers: Layers, activation: str,
                    normalize: bool, residuals: bool):
    """One launch of the fused forward; with `residuals` it also writes
    each layer's f32 activation (counted as dense_tower_residuals)."""
    dims = _check(x, layers, activation)
    rows = x.shape[0]
    y = torch.empty((rows, dims[-1]), dtype=torch.float32, device=x.device)
    wide = max(dims[:-1]) * x.element_size() > _TILE_BYTES
    hs = [torch.empty((rows, d), dtype=torch.float32, device=x.device)
          for d in dims[1:]] if residuals or wide else []
    if rows == 0:
        return y, hs if residuals else []
    n = len(layers)
    ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w, _ in layers])
    bs = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
    hp = (ctypes.c_void_p * n)(*[t.data_ptr() for t in hs]) if hs else None
    cdims = (ctypes.c_int * (n + 1))(*dims)
    try:
        _build.launch(_RESIDUALS if residuals else _NAME, "dssm_dense_tower",
                      x.device, x.data_ptr(), y.data_ptr(), ws, bs, hp, cdims,
                      n, rows, _DTYPE_CODE[x.dtype], _ACT_CODE[activation],
                      int(normalize), EPS)
    except RuntimeError as err:  # a shape the kernel does not take
        raise RuntimeError(f"{err}: x {tuple(x.shape)} {x.dtype}, widths "
                           f"{dims}") from None
    return y, hs if residuals else []


def dense_tower_residuals(x: torch.Tensor, layers: Layers,
                          activation: str = "tanh", normalize: bool = True,
                          *, impl: str = "auto"):
    """The training forward, without autograd: (y [B, D] f32, hs), hs[l] the
    f32 activation of layer l before the cast that feeds layer l + 1."""
    if _build.resolve_impl(impl, x, _RESIDUALS) == "plain":
        return dense_tower_residuals_plain(x, layers, activation, normalize)
    return _forward_kernel(x, layers, activation, normalize, True)


def _act_grad(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "tanh":
        return 1.0 - h * h
    return (h > 0.0).to(h.dtype)


class _DenseTower(torch.autograd.Function):
    """forward(x, *flat_layers) -> y; the residual-reusing analytic backward
    of dssm_tpu's _tower_bwd."""

    @staticmethod
    def forward(ctx, activation, normalize, kernel, x, *flat):
        layers = list(zip(flat[0::2], flat[1::2]))
        y, hs = dense_tower_residuals(x, layers, activation, normalize,
                                      impl="kernel" if kernel else "plain")
        ctx.activation, ctx.normalize = activation, normalize
        ctx.save_for_backward(x, y, *flat[0::2], *hs)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, *rest = ctx.saved_tensors
        n = len(rest) // 2
        ws, hs = rest[:n], rest[n:]
        g = g.float()
        if ctx.normalize:
            # y = h_L / norm; dh_L = (g - (g.y) y) / norm
            norm = torch.clamp_min(
                torch.sqrt(torch.sum(hs[-1] * hs[-1], dim=-1, keepdim=True)),
                EPS)
            dh = (g - torch.sum(g * y, dim=-1, keepdim=True) * y) / norm
        else:
            dh = g
        d_flat = [None] * (2 * n)
        for l in reversed(range(n)):
            dz = dh * _act_grad(hs[l], ctx.activation)
            h_prev = x.float() if l == 0 else hs[l - 1]
            d_flat[2 * l] = (h_prev.T @ dz).to(ws[l].dtype)
            d_flat[2 * l + 1] = dz.sum(dim=0).to(ws[l].dtype)
            dh = dz @ ws[l].float().T
        return (None, None, None, dh.to(x.dtype), *d_flat)


def dense_tower(x: torch.Tensor, layers: Layers, activation: str = "tanh",
                normalize: bool = True, *, impl: str = "auto") -> torch.Tensor:
    """Fused forward of the whole tower; y [B, D] f32. Differentiable in x
    and the layers (the residual-writing forward runs when a gradient can be
    asked for; a serving call writes y only)."""
    kernel = _build.resolve_impl(impl, x, _NAME) == "kernel"
    if activation not in _ACT_CODE:
        raise ValueError(activation)
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for l in layers for t in l))
    if needs_grad:
        flat = [t for layer in layers for t in layer]
        return _DenseTower.apply(activation, normalize, kernel, x, *flat)
    if kernel:
        return _forward_kernel(x, layers, activation, normalize, False)[0]
    return dense_tower_plain(x, layers, activation, normalize)
