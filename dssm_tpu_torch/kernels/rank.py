"""Streaming rank count for retrieval eval.

    rank_i = 1 + #{ j != i, j < ND : q_i . d_j > true_i },
    true_i = sum(q_i * d_i)   (the aligned doc's score, as a row dot)

Counterpart of dssm_tpu/kernels/pallas_rank.py::rank_counts_pallas; the CUDA
kernel is csrc/rank.cu: a tiled f32 product whose scores stay in registers,
compared and counted in place, each block holding a q tile while doc tiles
stream past it. The true score is formed outside the kernel
as the row dot and the self column is excluded by index, so the comparison
cannot be flipped by the product's own rounding of the diagonal entry. A
tie does not count (strict >). The plain version is the reference's default
path, the doc-chunked scan of dssm_tpu/train/eval.py::_rank_all.

Kernel and plain version sum each product in another order: a doc whose
score lies within an f32 rounding of the true score (a duplicate of the
true doc, say) can count in one and not in the other.
"""

from __future__ import annotations

import torch

from dssm_tpu_torch.kernels import _build

_NAME = "rank_counts"
# Ranks are int32 and reach ND. The kernel's grid (one block per resident
# slot, each a share of the tile pairs) puts no limit on N or ND.
_MAX_DOCS = 2**31 - 1


def true_scores(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[N] f32: each query's score against its aligned doc d[i]."""
    return torch.sum(q * d[: q.shape[0]], dim=1)


def rank_counts_plain(q: torch.Tensor, d: torch.Tensor, chunk: int = 1024,
                      dchunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch version: [chunk, dchunk] score blocks by matmul, the
    self column masked by index, compared and summed."""
    n, nd = q.shape[0], d.shape[0]
    true_c = true_scores(q, d)
    counts = torch.zeros((n,), dtype=torch.int32, device=q.device)
    for lo in range(0, n, chunk):
        qc, tc = q[lo:lo + chunk], true_c[lo:lo + chunk, None]
        rows = torch.arange(lo, lo + qc.shape[0], device=q.device)[:, None]
        for c0 in range(0, nd, dchunk):
            db = d[c0:c0 + dchunk]
            cols = torch.arange(c0, c0 + db.shape[0], device=q.device)[None, :]
            above = ((qc @ db.T) > tc) & (cols != rows)
            counts[lo:lo + chunk] += above.sum(dim=1, dtype=torch.int32)
    return 1 + counts


def rank_counts(q: torch.Tensor, d: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """q [N, D], d [ND, D] f32 with ND >= N, the true doc of query i being
    d[i] -> ranks [N] int32."""
    if q.dim() != 2 or d.dim() != 2 or q.shape[1] != d.shape[1]:
        raise ValueError(f"{_NAME}: q {tuple(q.shape)} and d "
                         f"{tuple(d.shape)} must be [N, D] and [ND, D]")
    n, dim = q.shape
    nd = d.shape[0]
    if nd < n:
        raise ValueError(f"{_NAME}: {nd} docs for {n} queries; query i's "
                         "true doc is d[i]")
    if nd > _MAX_DOCS:
        raise ValueError(f"{_NAME}: {nd} docs; int32 ranks take at most "
                         f"{_MAX_DOCS}")
    if _build.resolve_impl(impl, q, _NAME) == "plain":
        return rank_counts_plain(q, d)
    if q.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError(f"{_NAME}: the kernel takes f32 embeddings, got "
                         f"{q.dtype} and {d.dtype}")
    if dim % 4:
        raise ValueError(f"{_NAME}: the kernel takes a width that is a "
                         f"multiple of 4, got {dim}")
    _build.check_cuda(_NAME, q.device, q, d)
    if q.data_ptr() % 16 or d.data_ptr() % 16:
        raise ValueError(f"{_NAME}: q and d must be 16-byte aligned")
    ranks = torch.ones((n,), dtype=torch.int32, device=q.device)
    if n == 0:
        return ranks
    true_c = true_scores(q, d).contiguous()
    _build.launch(_NAME, "dssm_rank_counts", q.device, q.data_ptr(),
                  d.data_ptr(), true_c.data_ptr(), ranks.data_ptr(), n, nd,
                  dim)
    return ranks
