"""Count lookup: out[..., :] = sum_k wgt[..., k] * compact2[inv[..., k]].

Counterpart of dssm_tpu/kernels/pallas_count.py::count_lookup_pallas, forward
and backward; the CUDA kernels are in csrc/count.cu: a direct
gather-accumulate that never builds the count matrix, and for the gradient in
compact2 a counting sort of the live lookups by compact row followed by a
segmented sum in a fixed order. The plain versions repeat the reference's
formulation, count_matrix(inv, wgt) @ compact2 and its transpose.
"""

from __future__ import annotations

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "count_lookup"
_BWD = "count_lookup_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def count_matrix(inv: torch.Tensor, wgt: torch.Tensor, u: int) -> torch.Tensor:
    """cnt[row, j] = sum_k wgt[row, k] * (inv[row, k] == j), f32
    [prod(...), u]; lookups with inv outside [0, u) count nowhere."""
    k = inv.shape[-1]
    inv2 = inv.reshape(-1, k).long()
    w2 = wgt.reshape(-1, k).float()
    valid = (inv2 >= 0) & (inv2 < u)
    cnt = torch.zeros((inv2.shape[0], u), dtype=torch.float32,
                      device=inv.device)
    return cnt.scatter_add_(1, torch.where(valid, inv2, 0),
                            torch.where(valid, w2, 0.0))


def count_lookup_plain(compact2: torch.Tensor, inv: torch.Tensor,
                       wgt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the count matrix, cast to compact2's dtype as
    the reference casts it, times compact2 with f32 accumulation."""
    u2, h = compact2.shape
    cnt = count_matrix(inv, wgt, u2).to(compact2.dtype).float()
    out = cnt @ compact2.float()
    return out.reshape(*inv.shape[:-1], h)


def count_lookup_bwd_plain(inv: torch.Tensor, wgt: torch.Tensor,
                           g: torch.Tensor, u2: int) -> torch.Tensor:
    """Plain PyTorch version of the backward: count_matrix^T @ g, f32."""
    h = g.shape[-1]
    return count_matrix(inv, wgt, u2).T @ g.reshape(-1, h).float()


def _check_lookup(name: str, inv: torch.Tensor, wgt: torch.Tensor) -> None:
    if inv.dtype != torch.int32 or wgt.dtype != torch.float32:
        raise ValueError(f"{name}: inv must be int32 and wgt f32, got "
                         f"{inv.dtype} and {wgt.dtype}")
    if inv.shape != wgt.shape or inv.dim() < 1:
        raise ValueError(f"{name}: inv {tuple(inv.shape)} and wgt "
                         f"{tuple(wgt.shape)} differ")


def count_lookup_bwd(inv: torch.Tensor, wgt: torch.Tensor, g: torch.Tensor,
                     u2: int, *, impl: str = "auto") -> torch.Tensor:
    """d_compact2 [U2, H] f32 = sum over lookups of wgt * g at row inv.

    inv/wgt [..., K], g [..., H] f32 or bf16. The kernel sorts the live
    lookups by compact row and sums each row in a fixed order, with no float
    atomics: two calls give the same bits. It writes every row of
    d_compact2 (zero where no live lookup names it) and takes its scratch
    from one workspace allocated here.
    """
    if _build.resolve_impl(impl, g, _BWD) == "plain":
        return count_lookup_bwd_plain(inv, wgt, g, u2)
    _check_lookup(_BWD, inv, wgt)
    if g.dtype not in _DTYPE_CODE or g.shape[:-1] != inv.shape[:-1]:
        raise ValueError(f"{_BWD}: g must be f32 or bf16 [..., H] over inv's "
                         f"rows, got {g.dtype} {tuple(g.shape)}")
    _build.check_cuda(_BWD, g.device, inv, wgt, g)
    h = g.shape[-1]
    k = inv.shape[-1]
    rows = inv.numel() // k if k else 0
    if rows == 0 or h == 0 or k == 0 or u2 == 0:
        return torch.zeros((u2, h), dtype=torch.float32, device=g.device)
    nbytes = _build.query("dssm_count_lookup_bwd_workspace", rows, k, u2, h)
    if nbytes < 0:
        raise ValueError(f"{_BWD}: shapes the kernel does not take: {rows} "
                         f"rows, K {k}, u2 {u2}, H {h}")
    dc2 = torch.empty((u2, h), dtype=torch.float32, device=g.device)
    work = torch.empty((nbytes,), dtype=torch.uint8, device=g.device)
    _build.launch(_BWD, "dssm_count_lookup_bwd", g.device, inv.data_ptr(),
                  wgt.data_ptr(), g.data_ptr(), dc2.data_ptr(),
                  work.data_ptr(), nbytes, rows, k, u2, h,
                  _DTYPE_CODE[g.dtype])
    return dc2


def _forward_kernel(compact2: torch.Tensor, inv: torch.Tensor,
                    wgt: torch.Tensor) -> torch.Tensor:
    u2, h = compact2.shape
    k = inv.shape[-1]
    rows = inv.numel() // k if k else 0
    out = torch.empty((*inv.shape[:-1], h), dtype=torch.float32,
                      device=compact2.device)
    if rows == 0 or h == 0:
        return out
    if k == 0:
        return out.zero_()
    _build.launch(_NAME, "dssm_count_lookup", compact2.device,
                  compact2.data_ptr(), inv.data_ptr(), wgt.data_ptr(),
                  out.data_ptr(), rows, k, u2, h, _DTYPE_CODE[compact2.dtype])
    return out


class _CountLookup(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient in
    compact2 (inv and wgt are data)."""

    @staticmethod
    def forward(ctx, compact2, inv, wgt):
        ctx.save_for_backward(inv, wgt)
        ctx.u2, ctx.dtype = compact2.shape[0], compact2.dtype
        return _forward_kernel(compact2, inv, wgt)

    @staticmethod
    def backward(ctx, g):
        inv, wgt = ctx.saved_tensors
        dc2 = count_lookup_bwd(inv, wgt, g.contiguous(), ctx.u2,
                               impl="kernel")
        return dc2.to(ctx.dtype), None, None


def count_lookup(compact2: torch.Tensor, inv: torch.Tensor,
                 wgt: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """compact2 [U2, H] f32/bf16, inv [..., K] int32, wgt [..., K] f32
    -> [..., H] f32; differentiable in compact2."""
    if _build.resolve_impl(impl, compact2, _NAME) == "plain":
        return count_lookup_plain(compact2, inv, wgt)
    if compact2.dtype not in _DTYPE_CODE or compact2.dim() != 2:
        raise ValueError(f"{_NAME}: compact2 must be 2-D f32 or bf16, got "
                         f"{compact2.dtype} {tuple(compact2.shape)}")
    _check_lookup(_NAME, inv, wgt)
    _build.check_cuda(_NAME, compact2.device, compact2, inv, wgt)
    if compact2.requires_grad and torch.is_grad_enabled():
        return _CountLookup.apply(compact2, inv, wgt)
    return _forward_kernel(compact2, inv, wgt)
