"""Fused in-batch cosine-softmax loss rows: for unit vectors q [B, D] and
d [B', D],

    logits = gamma * q @ d.T
    nll[i] = logsumexp(logits[i]) - logits[i, labels[i]]

with the positive logit and hit[i] = (positive >= row max) as metrics.

Counterpart of dssm_tpu/kernels/pallas_loss.py::in_batch_loss_pallas; the
CUDA kernels (forward, dq, dd) are in csrc/loss.cu and, like the Pallas
kernels, never write the [B, B'] logits to device memory. Ties count as
hits, as in the reference kernel (its XLA composition's argmax counts only
the first maximum: loss/cosine_softmax.in_batch_loss_composed). No gradient
flows through pos or hit. The plain version composes the same function from
matmul and logsumexp; its gradient is autograd's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "in_batch_loss"
_DQ = "in_batch_loss_dq"
_DD = "in_batch_loss_dd"
# The widest D taken (csrc/loss.cu's shared memory does not grow with D;
# the GPU tests hold the kernels to their plain versions up to it).
_MAX_DIM = 680


def in_batch_nll_plain(q: torch.Tensor, d: torch.Tensor,
                       labels: torch.Tensor, gamma: float,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """(nll, lse, pos, hit), each [B] f32."""
    logits = gamma * (q.float() @ d.float().T)
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.long()
    valid = (lab >= 0) & (lab < d.shape[0])
    pos = logits.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
    pos = pos * valid.float()
    hit = (pos >= logits.max(dim=-1).values).float()
    return lse - pos, lse, pos, hit


def in_batch_loss_grads_plain(q, d, labels, gamma, lse, g):
    """Plain PyTorch version of the two backward kernels: (dq, dd)."""
    logits = gamma * (q.float() @ d.float().T)
    cols = torch.arange(d.shape[0], device=q.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dlog = (torch.exp(logits - lse[:, None]) - onehot) * g.float()[:, None]
    return gamma * (dlog @ d.float()), gamma * (dlog.T @ q.float())


def _check(name, q, d, labels):
    if (q.dtype != torch.float32 or d.dtype != torch.float32 or q.dim() != 2
            or d.dim() != 2 or q.shape[1] != d.shape[1]):
        raise ValueError(f"{name}: q and d must be f32 [B, D] and [B', D], "
                         f"got {q.dtype} {tuple(q.shape)} and {d.dtype} "
                         f"{tuple(d.shape)}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (q.shape[0],):
        raise ValueError(f"{name}: labels must be int32 [B], got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if not 0 < q.shape[1] <= _MAX_DIM or q.shape[0] == 0 or d.shape[0] == 0:
        raise ValueError(f"{name}: needs B, B' > 0 and 0 < D <= {_MAX_DIM}, "
                         f"got {tuple(q.shape)} and {tuple(d.shape)}")
    _build.check_cuda(name, q.device, q, d, labels)
    if q.shape[1] % 4 == 0 and (q.data_ptr() % 16 or d.data_ptr() % 16):
        raise ValueError(f"{name}: q and d must be 16-byte aligned when D is "
                         "a multiple of 4 (the kernel loads 16-byte vectors)")


def in_batch_nll_kernel(q, d, labels, gamma):
    """One launch of the forward kernel: (nll, lse, pos, hit)."""
    _check(_NAME, q, d, labels)
    b, dim = q.shape
    out = torch.empty((4, b), dtype=torch.float32, device=q.device)
    nll, lse, pos, hit = out.unbind(0)
    _build.launch(_NAME, "dssm_in_batch_loss_fwd", q.device, q.data_ptr(),
                  d.data_ptr(), labels.data_ptr(), nll.data_ptr(),
                  lse.data_ptr(), pos.data_ptr(), hit.data_ptr(), b,
                  d.shape[0], dim, float(gamma))
    return nll, lse, pos, hit


def in_batch_loss_dq(q, d, labels, gamma, lse, g, *, impl="auto"):
    """dq [B, D] f32 = gamma * dlog @ d, the logits recomputed tile by
    tile from q, d and the saved lse."""
    if _build.resolve_impl(impl, q, _DQ) == "plain":
        return in_batch_loss_grads_plain(q, d, labels, gamma, lse, g)[0]
    return _grad_kernel(_DQ, "dssm_in_batch_loss_dq", q, d, labels, gamma,
                        lse, g, q.shape[0])


def in_batch_loss_dd(q, d, labels, gamma, lse, g, *, impl="auto"):
    """dd [B', D] f32 = gamma * dlog^T @ q."""
    if _build.resolve_impl(impl, q, _DD) == "plain":
        return in_batch_loss_grads_plain(q, d, labels, gamma, lse, g)[1]
    return _grad_kernel(_DD, "dssm_in_batch_loss_dd", q, d, labels, gamma,
                        lse, g, d.shape[0])


def _grad_kernel(name, fn, q, d, labels, gamma, lse, g, out_rows):
    _check(name, q, d, labels)
    b, dim = q.shape
    for t, what in ((lse, "lse"), (g, "g")):
        if t.dtype != torch.float32 or tuple(t.shape) != (b,):
            raise ValueError(f"{name}: {what} must be f32 [B], got "
                             f"{t.dtype} {tuple(t.shape)}")
    _build.check_cuda(name, q.device, lse, g)
    out = torch.empty((out_rows, dim), dtype=torch.float32, device=q.device)
    _build.launch(name, fn, q.device, q.data_ptr(), d.data_ptr(),
                  labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                  out.data_ptr(), b, d.shape[0], dim, float(gamma))
    return out


class _InBatchNLL(torch.autograd.Function):
    """forward -> (nll, pos, hit); backward: the dq and dd kernels from the
    saved lse and the gradient of nll alone."""

    @staticmethod
    def forward(ctx, q, d, labels, gamma):
        nll, lse, pos, hit = in_batch_nll_kernel(q, d, labels, gamma)
        ctx.save_for_backward(q, d, labels, lse)
        ctx.gamma = gamma
        ctx.mark_non_differentiable(pos, hit)
        return nll, pos, hit

    @staticmethod
    def backward(ctx, g_nll, _g_pos, _g_hit):
        q, d, labels, lse = ctx.saved_tensors
        g = g_nll.float().contiguous()
        dq = dd = None
        if ctx.needs_input_grad[0]:
            dq = in_batch_loss_dq(q, d, labels, ctx.gamma, lse, g,
                                  impl="kernel")
        if ctx.needs_input_grad[1]:
            dd = in_batch_loss_dd(q, d, labels, ctx.gamma, lse, g,
                                  impl="kernel")
        return dq, dd, None, None


def in_batch_nll(q: torch.Tensor, d: torch.Tensor, labels: torch.Tensor,
                 gamma: float, *, impl: str = "auto",
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll, pos, hit), each [B] f32; differentiable in q and d through
    nll. labels [B] int32: the column of each row's positive."""
    if _build.resolve_impl(impl, q, _NAME) == "plain":
        nll, _, pos, hit = in_batch_nll_plain(q, d, labels, gamma)
        return nll, pos.detach(), hit
    q, d = q.contiguous(), d.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or d.requires_grad):
        return _InBatchNLL.apply(q, d, labels, float(gamma))
    nll, _, pos, hit = in_batch_nll_kernel(q, d, labels, gamma)
    return nll, pos, hit
