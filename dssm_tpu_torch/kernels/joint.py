"""Joint lookup: both towers' lookups from one compact block and one row
selection (the union-dedupe batch layout of shared-table towers).

    q_out[r] = sum_k q_wgt[r, k] * compact[sel[q_inv[r, k]]]
    d_out[r] = sum_k d_wgt[r, k] * compact[sel[d_inv[r, k]]]

Counterpart of dssm_tpu/kernels/pallas_count.py::joint_lookup_pallas with
its custom VJP; the CUDA kernels are in csrc/joint.cu. The arithmetic is the
Pallas kernel's: selection and products in compact's own dtype (f32 for an
f32 table) with f32 accumulation, f32 outputs, weights as given; the
gradient in compact is summed in f32 over both sides and rounded once to
compact's dtype. The plain version repeats the reference's formulation: the
selected rows, then count_matrix @ rows per side; its gradient is
autograd's.

fused_gather_joint_lookup: the row-group gather and the joint lookup in one
launch, straight from the table (f32 or bf16), returning both sides' outputs
and the compact block. Counterpart of pallas_count.py::
fused_gather_joint_lookup; its plain version is gather_row_groups_plain
followed by joint_lookup_plain, and the kernel's outputs are bit-equal to the
two kernels run one after the other. Not differentiable, as the reference's:
a caller differentiates at the outputs and forms the compact gradient with
joint_lookup_bwd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.kernels.count import count_lookup_plain, count_matrix
from dssm_tpu_torch.kernels.gather import gather_row_groups_plain

_NAME = "joint_lookup"
_BWD = "joint_lookup_bwd"
_FUSED = "fused_gather_joint_lookup"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def select_rows_plain(compact: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """compact[sel] with zero rows where sel is outside [0, gr): the exact
    selection the reference forms as a one-hot matmul."""
    gr = compact.shape[0]
    sel = sel.long()
    valid = (sel >= 0) & (sel < gr)
    rows = compact.index_select(0, torch.where(valid, sel, 0))
    return rows * valid[:, None].to(rows.dtype)


def joint_lookup_plain(compact: torch.Tensor, sel: torch.Tensor,
                       q_inv: torch.Tensor, q_wgt: torch.Tensor,
                       d_inv: torch.Tensor, d_wgt: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    # In f32 whatever compact's dtype, as the kernel: autograd then sums both
    # sides' gradients in f32 and rounds once to compact's dtype.
    compact2 = select_rows_plain(compact.float(), sel)
    return (count_lookup_plain(compact2, q_inv, q_wgt),
            count_lookup_plain(compact2, d_inv, d_wgt))


def joint_lookup_bwd_plain(sel: torch.Tensor, q_inv: torch.Tensor,
                           q_wgt: torch.Tensor, d_inv: torch.Tensor,
                           d_wgt: torch.Tensor, g_q: torch.Tensor,
                           g_d: torch.Tensor, gr: int) -> torch.Tensor:
    """Plain PyTorch version of the backward: d_compact [gr, H] f32 =
    onehot(sel)^T (cnt_q^T g_q + cnt_d^T g_d), the selection transposed as an
    index_add so padded sel slots (all 0) add and never overwrite."""
    u2 = sel.shape[0]
    h = g_q.shape[-1]
    dc2 = (count_matrix(q_inv, q_wgt, u2).T @ g_q.reshape(-1, h).float()
           + count_matrix(d_inv, d_wgt, u2).T @ g_d.reshape(-1, h).float())
    sel = sel.long()
    valid = (sel >= 0) & (sel < gr)
    dc = torch.zeros((gr, h), dtype=torch.float32, device=g_q.device)
    return dc.index_add_(0, torch.where(valid, sel, 0),
                         dc2 * valid[:, None].float())


def _check(name, sel, q_inv, q_wgt, d_inv, d_wgt):
    if sel.dtype != torch.int32 or sel.dim() != 1:
        raise ValueError(f"{name}: sel must be 1-D int32, got {sel.dtype} "
                         f"{tuple(sel.shape)}")
    for side, inv, wgt in (("q", q_inv, q_wgt), ("d", d_inv, d_wgt)):
        if inv.dtype != torch.int32 or wgt.dtype != torch.float32:
            raise ValueError(f"{name}: {side}_inv must be int32 and "
                             f"{side}_wgt f32, got {inv.dtype}, {wgt.dtype}")
        if inv.shape != wgt.shape or inv.dim() < 1 or inv.shape[-1] == 0:
            raise ValueError(f"{name}: {side}_inv {tuple(inv.shape)} and "
                             f"{side}_wgt {tuple(wgt.shape)}")
    if q_inv.shape[:-1] != d_inv.shape[:-1]:
        raise ValueError(f"{name}: the two sides have different rows: "
                         f"{tuple(q_inv.shape)} and {tuple(d_inv.shape)}")


def joint_lookup_bwd(sel: torch.Tensor, q_inv: torch.Tensor,
                     q_wgt: torch.Tensor, d_inv: torch.Tensor,
                     d_wgt: torch.Tensor, g_q: torch.Tensor,
                     g_d: torch.Tensor, gr: int, *,
                     impl: str = "auto") -> torch.Tensor:
    """d_compact [gr, H] f32 from both sides' output gradients (f32 or
    bf16). The kernel adds with f32 atomics: the last bits depend on the
    order of the adds."""
    if _build.resolve_impl(impl, g_q, _BWD) == "plain":
        return joint_lookup_bwd_plain(sel, q_inv, q_wgt, d_inv, d_wgt, g_q,
                                      g_d, gr)
    _check(_BWD, sel, q_inv, q_wgt, d_inv, d_wgt)
    if (g_q.dtype not in _DTYPE_CODE or g_d.dtype != g_q.dtype
            or g_q.shape[:-1] != q_inv.shape[:-1]
            or g_d.shape != g_q.shape):
        raise ValueError(f"{_BWD}: g_q {g_q.dtype} {tuple(g_q.shape)} and "
                         f"g_d {g_d.dtype} {tuple(g_d.shape)} must be f32 or "
                         "bf16 [..., H] over the lookup rows")
    _build.check_cuda(_BWD, g_q.device, sel, q_inv, q_wgt, d_inv, d_wgt, g_q,
                      g_d)
    h = g_q.shape[-1]
    rows = q_inv.numel() // q_inv.shape[-1]
    dc = torch.zeros((gr, h), dtype=torch.float32, device=g_q.device)
    if rows == 0 or h == 0 or gr == 0:
        return dc
    _build.launch(_BWD, "dssm_joint_lookup_bwd", g_q.device, sel.data_ptr(),
                  q_inv.data_ptr(), q_wgt.data_ptr(), d_inv.data_ptr(),
                  d_wgt.data_ptr(), g_q.data_ptr(), g_d.data_ptr(),
                  dc.data_ptr(), rows, q_inv.shape[-1], d_inv.shape[-1],
                  sel.shape[0], gr, h, _DTYPE_CODE[g_q.dtype])
    return dc


def _forward_kernel(compact, sel, q_inv, q_wgt, d_inv, d_wgt):
    gr, h = compact.shape
    rows = q_inv.numel() // q_inv.shape[-1]
    q_out = torch.empty((*q_inv.shape[:-1], h), dtype=torch.float32,
                        device=compact.device)
    d_out = torch.empty_like(q_out)
    if rows == 0 or h == 0:
        return q_out, d_out
    _build.launch(_NAME, "dssm_joint_lookup", compact.device,
                  compact.data_ptr(), sel.data_ptr(), q_inv.data_ptr(),
                  q_wgt.data_ptr(), d_inv.data_ptr(), d_wgt.data_ptr(),
                  q_out.data_ptr(), d_out.data_ptr(), rows, q_inv.shape[-1],
                  d_inv.shape[-1], sel.shape[0], gr, h,
                  _DTYPE_CODE[compact.dtype])
    return q_out, d_out


class _JointLookup(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient in
    compact (sel, inv and wgt are data). No residual is kept but the batch
    fields themselves."""

    @staticmethod
    def forward(ctx, compact, sel, q_inv, q_wgt, d_inv, d_wgt):
        ctx.save_for_backward(sel, q_inv, q_wgt, d_inv, d_wgt)
        ctx.gr, ctx.dtype = compact.shape[0], compact.dtype
        return _forward_kernel(compact, sel, q_inv, q_wgt, d_inv, d_wgt)

    @staticmethod
    def backward(ctx, g_q, g_d):
        sel, q_inv, q_wgt, d_inv, d_wgt = ctx.saved_tensors
        dc = joint_lookup_bwd(sel, q_inv, q_wgt, d_inv, d_wgt,
                              g_q.contiguous(), g_d.contiguous(), ctx.gr,
                              impl="kernel")
        return dc.to(ctx.dtype), None, None, None, None, None


def joint_lookup(compact: torch.Tensor, sel: torch.Tensor,
                 q_inv: torch.Tensor, q_wgt: torch.Tensor,
                 d_inv: torch.Tensor, d_wgt: torch.Tensor, *,
                 impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """compact [gr, H] f32/bf16, sel [U2] int32, {q,d}_inv [..., K] int32,
    {q,d}_wgt [..., K] f32 -> (q_out, d_out) [..., H] f32; differentiable
    in compact."""
    if _build.resolve_impl(impl, compact, _NAME) == "plain":
        return joint_lookup_plain(compact, sel, q_inv, q_wgt, d_inv, d_wgt)
    if compact.dtype not in _DTYPE_CODE or compact.dim() != 2:
        raise ValueError(f"{_NAME}: compact must be 2-D f32 or bf16, got "
                         f"{compact.dtype} {tuple(compact.shape)}")
    _check(_NAME, sel, q_inv, q_wgt, d_inv, d_wgt)
    _build.check_cuda(_NAME, compact.device, compact, sel, q_inv, q_wgt,
                      d_inv, d_wgt)
    if compact.requires_grad and torch.is_grad_enabled():
        return _JointLookup.apply(compact, sel, q_inv, q_wgt, d_inv, d_wgt)
    return _forward_kernel(compact, sel, q_inv, q_wgt, d_inv, d_wgt)


def fused_gather_joint_lookup_plain(
        table: torch.Tensor, uniq: torch.Tensor, sel: torch.Tensor,
        q_inv: torch.Tensor, q_wgt: torch.Tensor, d_inv: torch.Tensor,
        d_wgt: torch.Tensor, group: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    compact = gather_row_groups_plain(table, uniq, group)
    return (*joint_lookup_plain(compact, sel, q_inv, q_wgt, d_inv, d_wgt),
            compact)


@torch.no_grad()
def fused_gather_joint_lookup(
        table: torch.Tensor, uniq: torch.Tensor, sel: torch.Tensor,
        q_inv: torch.Tensor, q_wgt: torch.Tensor, d_inv: torch.Tensor,
        d_wgt: torch.Tensor, group: int, *, impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """table [V, H] f32 or bf16, uniq [G] int32 group ids (ids outside
    [0, V / group), such as the dedupe's sentinel, are empty slots), sel [U2]
    int32, {q,d}_inv [..., K] int32, {q,d}_wgt [..., K] f32 ->
    (q_out, d_out [..., H] f32, compact [G * group, H] of the table's dtype,
    empty slots' rows zero). An int8 table is refused: its compact block is
    dequantized against the row scales before the lookup (the split path)."""
    if table.dtype not in _DTYPE_CODE:
        raise ValueError(f"{_FUSED}: the table must be f32 or bf16, got "
                         f"{table.dtype} (an int8 table takes the gather, "
                         "dequant_compact and joint_lookup)")
    if _build.resolve_impl(impl, table, _FUSED) == "plain":
        return fused_gather_joint_lookup_plain(table, uniq, sel, q_inv, q_wgt,
                                               d_inv, d_wgt, group)
    v, h = table.shape
    if v % group:
        raise ValueError(f"{_FUSED}: vocab {v} not divisible by group {group}")
    if uniq.dtype != torch.int32 or uniq.dim() != 1:
        raise ValueError(f"{_FUSED}: uniq must be 1-D int32, got "
                         f"{uniq.dtype} {tuple(uniq.shape)}")
    _check(_FUSED, sel, q_inv, q_wgt, d_inv, d_wgt)
    _build.check_cuda(_FUSED, table.device, table, uniq, sel, q_inv, q_wgt,
                      d_inv, d_wgt)
    group_bytes = group * h * table.element_size()
    if group_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{_FUSED}: a row group must be a whole number of "
                         f"16-byte vectors ({group_bytes} bytes)")
    g = uniq.shape[0]
    rows = q_inv.numel() // q_inv.shape[-1]
    compact = torch.empty((g * group, h), dtype=table.dtype,
                          device=table.device)
    q_out = torch.empty((*q_inv.shape[:-1], h), dtype=torch.float32,
                        device=table.device)
    d_out = torch.empty_like(q_out)
    if h == 0 or rows + g == 0:
        return q_out, d_out, compact
    _build.launch(_FUSED, "dssm_fused_gather_joint_lookup", table.device,
                  table.data_ptr(), uniq.data_ptr(), sel.data_ptr(),
                  q_inv.data_ptr(), q_wgt.data_ptr(), d_inv.data_ptr(),
                  d_wgt.data_ptr(), q_out.data_ptr(), d_out.data_ptr(),
                  compact.data_ptr(), rows, q_inv.shape[-1], d_inv.shape[-1],
                  sel.shape[0], g, group, v // group, h,
                  _DTYPE_CODE[table.dtype])
    return q_out, d_out, compact
