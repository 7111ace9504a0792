"""Cosine-similarity softmax cross-entropy over in-batch negatives.

Towers emit unit-norm embeddings, so cosine == dot and the loss is one
gamma-scaled matmul + log-softmax + gather. `in_batch_loss` scores the full
[B, B'] similarity matrix (positives at `labels`, the diagonal by default)
through the fused kernels of kernels/loss.py; `rotate_loss` scores each
query against its own doc plus rotated copies of the doc batch. Counterpart
of dssm_tpu/loss/cosine_softmax.py (its sharded loss comes with the
multi-device path).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dssm_tpu_torch.kernels.loss import in_batch_nll

Aux = Dict[str, torch.Tensor]


def _labels(qh: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
    if labels is None:
        return torch.arange(qh.shape[0], dtype=torch.int32, device=qh.device)
    return labels.to(torch.int32)


def in_batch_loss_composed(
    qh: torch.Tensor, dh: torch.Tensor, gamma: float,
    labels: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Aux]:
    """The loss composed from matmul, logsumexp and argmax, as dssm_tpu's
    in_batch_loss_xla: recall counts a row only when its positive is the
    FIRST maximum, where the fused kernel counts every tie as a hit."""
    lab = _labels(qh, labels).long()
    logits = gamma * (qh.float() @ dh.float().T)
    logz = torch.logsumexp(logits, dim=-1)
    pos = logits.gather(1, lab[:, None])[:, 0]
    nll = logz - pos
    loss = nll.mean()
    aux = {
        "loss": loss.detach(),
        "in_batch_recall@1": (logits.argmax(dim=-1) == lab).float().mean(),
        "pos_cos": pos.detach().mean() / gamma,
    }
    return loss, aux


def in_batch_loss(
    qh: torch.Tensor, dh: torch.Tensor, gamma: float,
    labels: Optional[torch.Tensor] = None, *, impl: str = "auto",
) -> Tuple[torch.Tensor, Aux]:
    """qh [B, D] and dh [B', D] unit vectors -> (mean NLL, aux metrics)
    through the fused loss kernels (their plain version for CPU tensors)."""
    nll, pos, hit = in_batch_nll(qh.float(), dh.float(), _labels(qh, labels),
                                 gamma, impl=impl)
    loss = nll.mean()
    aux = {
        "loss": loss.detach(),
        "in_batch_recall@1": hit.mean(),
        "pos_cos": pos.mean() / gamma,
    }
    return loss, aux


def rotate_loss(
    qh: torch.Tensor, dh: torch.Tensor, offsets: torch.Tensor, gamma: float,
) -> Tuple[torch.Tensor, Aux]:
    """Candidates for query i: docs (i + r) % B for r in [0, *offsets];
    softmax cross-entropy against candidate 0, as a column gather of the
    full B x B cosine matrix."""
    b = qh.shape[0]
    sims = gamma * (qh.float() @ dh.float().T)
    offsets = offsets.long()
    rs = torch.cat([torch.zeros((1,), dtype=torch.long,
                                device=offsets.device), offsets])
    rows = torch.arange(b, device=qh.device)[:, None]
    cand = (rows + rs[None, :]) % b  # [B, NEG + 1]
    logits = sims.gather(1, cand)
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits[:, 0]
    loss = nll.mean()
    aux = {
        "loss": loss.detach(),
        "in_batch_recall@1": (logits.argmax(dim=-1) == 0).float().mean(),
        "pos_cos": logits[:, 0].detach().mean() / gamma,
    }
    return loss, aux
