"""Raw-index embedding bag: out[..., :] = sum_k wgt[..., k] * table[idx[..., k]].

The first-layer lookup of a batch that carries raw per-example indices (no
dedupe fields: data.dedup_lookup=False). Counterpart of
dssm_tpu/kernels/pallas_embed.py::embedding_bag_pallas with its custom VJP;
the CUDA kernels are in csrc/embed.cu:

  embedding_bag       the forward, a direct gather-accumulate (f32 out);
  embedding_bag_dwgt  the gradient in the weights,
                      d_wgt[r, k] = g[r] . table[idx[r, k]] (f32 out).

Under autograd (_EmbeddingBag) the forward kernel's backward launches the
d_wgt kernel only when the weights need a gradient, and forms d_table as
the reference does outside its kernel: the plain segment-sum, an index_add_
into a zeroed [V, H] f32 buffer cast to the table's dtype. The sparse-update
training step never differentiates through the table (it updates the table
from the gradient at the lookup output), and no step asks for d_wgt: the
weights are data.

A live lookup (weight not 0) must name a row of the table. On CPU tensors
the wrapper raises otherwise (check_rows). On the card it reads nothing
back: the entry points check a numpy raw batch on the host before moving it
(bridge.check_raw_rows), and a lookup outside the table that reaches the
kernel anyway reads nothing and adds nothing, as in the plain version.
Lookups of weight 0 contribute nothing.
"""

from __future__ import annotations

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "embedding_bag"
_BWD = "embedding_bag_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _in_range(idx: torch.Tensor, v: int) -> torch.Tensor:
    return (idx >= 0) & (idx < v)


def check_rows(idx: torch.Tensor, wgt: torch.Tensor, v: int) -> None:
    """Raise when a live lookup names no row of a [v, H] table. On CUDA
    tensors this reads a flag back (a synchronisation), so the wrapper
    checks only CPU tensors."""
    bad = (wgt != 0) & ~_in_range(idx, v)
    if bool(bad.any()):
        first = int(idx[bad].reshape(-1)[0])
        raise IndexError(f"{_NAME}: a lookup of nonzero weight names row "
                         f"{first}, outside the table's {v} rows")


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor,
                        wgt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (dssm_tpu's embedding_bag_xla): the rows, then
    the weighted sum, in f32 as the kernel sums. Lookups outside the table
    read row 0 at weight 0: they add nothing, as in the kernel."""
    ok = _in_range(idx, table.shape[0])
    rows = table[torch.where(ok, idx, 0).long()].float()
    return torch.einsum("...k,...kh->...h", wgt.float() * ok, rows)


def embedding_bag_dwgt_plain(table: torch.Tensor, idx: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight gradient: d_wgt [..., K] f32 =
    g . table[idx] per lookup; 0 for a lookup outside the table."""
    v = table.shape[0]
    ok = _in_range(idx, v)
    rows = table[torch.where(ok, idx, 0).long()].float()
    return (rows * g.float()[..., None, :]).sum(-1) * ok


def embedding_bag_grad_plain(g: torch.Tensor, idx: torch.Tensor,
                             wgt: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The table gradient as dssm_tpu forms it (segment sum, f32):
    dT[v] = sum over lookups with idx == v of wgt * g."""
    h = g.shape[-1]
    ok = _in_range(idx, vocab_size)
    contrib = ((wgt.float() * ok)[..., None] * g.float()[..., None, :])
    d_table = torch.zeros((vocab_size, h), dtype=torch.float32,
                          device=g.device)
    return d_table.index_add_(0, torch.where(ok, idx, 0).reshape(-1).long(),
                              contrib.reshape(-1, h))


def _check(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dtype not in _DTYPE_CODE or table.dim() != 2:
        raise ValueError(f"{name}: the table must be 2-D f32 or bf16, got "
                         f"{table.dtype} {tuple(table.shape)}")
    vec = 16 // table.element_size()
    if table.shape[1] % vec or table.data_ptr() % 16:
        raise ValueError(f"{name}: table rows must be whole 16-byte vectors "
                         f"({table.shape[1]} columns of {table.dtype})")
    if idx.dtype != torch.int32 or idx.dim() < 1 or idx.shape[-1] == 0:
        raise ValueError(f"{name}: idx must be int32 [..., K], got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def _forward_kernel(table: torch.Tensor, idx: torch.Tensor,
                    wgt: torch.Tensor) -> torch.Tensor:
    v, h = table.shape
    k = idx.shape[-1]
    rows = idx.numel() // k
    out = torch.empty((*idx.shape[:-1], h), dtype=torch.float32,
                      device=table.device)
    if rows == 0 or h == 0:
        return out
    _build.launch(_NAME, "dssm_embedding_bag", table.device,
                  table.data_ptr(), idx.data_ptr(), wgt.data_ptr(),
                  out.data_ptr(), rows, k, v, h, _DTYPE_CODE[table.dtype])
    return out


def embedding_bag_dwgt(table: torch.Tensor, idx: torch.Tensor,
                       g: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """d_wgt [..., K] f32 from the output gradient g [..., H] (f32 or bf16)
    of embedding_bag over table [V, H] (f32 or bf16) and idx [..., K]."""
    if _build.resolve_impl(impl, table, _BWD) == "plain":
        return embedding_bag_dwgt_plain(table, idx, g)
    _check(_BWD, table, idx)
    v, h = table.shape
    if g.dtype not in _DTYPE_CODE or tuple(g.shape) != (*idx.shape[:-1], h):
        raise ValueError(f"{_BWD}: g must be f32 or bf16 {(*idx.shape[:-1], h)}"
                         f", got {g.dtype} {tuple(g.shape)}")
    _build.check_cuda(_BWD, table.device, table, idx, g)
    if g.data_ptr() % 16:  # the kernel reads g in 16-byte (8 bf16) vectors
        g = g.clone()
    k = idx.shape[-1]
    rows = idx.numel() // k
    dwgt = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    if rows == 0:
        return dwgt
    _build.launch(_BWD, "dssm_embedding_bag_dwgt", table.device,
                  table.data_ptr(), idx.data_ptr(), g.data_ptr(),
                  dwgt.data_ptr(), rows, k, v, h, _DTYPE_CODE[table.dtype],
                  _DTYPE_CODE[g.dtype])
    return dwgt


class _EmbeddingBag(torch.autograd.Function):
    """The forward kernel; backward: d_table by the plain segment sum (as
    the reference), d_wgt by the kernel, each only when asked for."""

    @staticmethod
    def forward(ctx, table, idx, wgt):
        ctx.save_for_backward(table, idx, wgt)
        return _forward_kernel(table, idx, wgt)

    @staticmethod
    def backward(ctx, g):
        table, idx, wgt = ctx.saved_tensors
        d_table = d_wgt = None
        if ctx.needs_input_grad[0]:
            d_table = embedding_bag_grad_plain(
                g, idx, wgt, table.shape[0]).to(table.dtype)
        if ctx.needs_input_grad[2]:
            d_wgt = embedding_bag_dwgt(table, idx, g.contiguous(),
                                       impl="kernel").to(wgt.dtype)
        return d_table, None, d_wgt


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                  *, impl: str = "auto") -> torch.Tensor:
    """table [V, H] f32/bf16, idx [..., K] int32, wgt [..., K] f32 ->
    [..., H] f32; differentiable in table and wgt."""
    if not table.is_cuda:
        check_rows(idx, wgt, table.shape[0])
    if _build.resolve_impl(impl, table, _NAME) == "plain":
        return embedding_bag_plain(table, idx, wgt)
    _check(_NAME, table, idx)
    if wgt.dtype != torch.float32 or wgt.shape != idx.shape:
        raise ValueError(f"{_NAME}: wgt must be f32 of idx's shape "
                         f"{tuple(idx.shape)}, got {wgt.dtype} "
                         f"{tuple(wgt.shape)}")
    _build.check_cuda(_NAME, table.device, table, idx, wgt)
    if torch.is_grad_enabled() and (table.requires_grad or wgt.requires_grad):
        return _EmbeddingBag.apply(table, idx, wgt)
    return _forward_kernel(table, idx, wgt)
