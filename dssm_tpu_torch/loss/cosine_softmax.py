"""Cosine-similarity softmax cross-entropy over in-batch negatives.

Towers emit unit-norm embeddings, so cosine == dot and the loss is one
gamma-scaled matmul + log-softmax + gather. `in_batch_loss` scores the full
[B, B'] similarity matrix (positives at `labels`, the diagonal by default)
through the fused kernels of kernels/loss.py; `rotate_loss` scores each
query against its own doc plus rotated copies of the doc batch.
`in_batch_loss_sharded` (and `rotate_loss_sharded`) run on one data shard
of a mesh: the doc embeddings all-gathered over the data group into the
global pool, the local queries scored against it. Counterpart of
dssm_tpu/loss/cosine_softmax.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dssm_tpu_torch.kernels.loss import in_batch_nll
from dssm_tpu_torch.parallel.dist import AllGather, all_reduce

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
    row_offset: int = 0,
) -> Tuple[torch.Tensor, Aux]:
    """Candidates for query i: docs (i + r) % B for r in [0, *offsets];
    softmax cross-entropy against candidate 0, as a column gather of the
    full B x B cosine matrix. row_offset: the queries are rows row_offset
    + [0, len(qh)) of a batch whose B docs are dh (one data shard's)."""
    b = dh.shape[0]
    sims = gamma * (qh.float() @ dh.float().T)
    offsets = offsets.long()
    rs = torch.cat([torch.zeros((1,), dtype=torch.long,
                                device=offsets.device), offsets])
    rows = row_offset + torch.arange(qh.shape[0], device=qh.device)[:, None]
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


def _pmean(loss: torch.Tensor, aux: Aux, mesh) -> Tuple[torch.Tensor, Aux]:
    """The shard's mean loss as a data-parallel objective: its value the
    mean of the shards' losses (a pmean over the data group, as are the aux
    metrics), its gradient the shard's loss / dp, so that the gradients
    summed over the data group are the global mean's."""
    dp = mesh.shape["data"]
    names = list(aux)
    vals = torch.stack([loss.detach().float()]
                       + [aux[k].detach().float() for k in names])
    vals = all_reduce(vals, mesh.groups["data"]) / dp
    local = loss / dp
    out = local + (vals[0] - local.detach())
    return out, {k: vals[i + 1] for i, k in enumerate(names)}


def in_batch_loss_sharded(
    qh: torch.Tensor, dh: torch.Tensor, gamma: float, mesh, *,
    impl: str = "auto", global_pool: bool = True, reduce: str = "pmean",
) -> Tuple[torch.Tensor, Aux]:
    """The global-negative-pool loss on this rank's data shard: qh, dh
    [B_local, D]. The docs are all-gathered over the data group (rank
    order, so shard s holds pool rows [s * B_local, (s + 1) * B_local)) and
    the local queries scored against the pool through the fused loss
    kernels, positives at labels data_rank * B_local + arange(B_local); the
    all-gather's backward reduce-scatters the pool's gradient back to the
    local docs. Equal to in_batch_loss over the whole batch.

    global_pool=False scores each query against its own shard's docs only
    (mesh.global_negatives=False). reduce="pmean": the loss as a
    data-parallel objective (_pmean: the value the global mean, the aux
    metrics pmean-ed); reduce="sum_shards": this shard's NLL and aux SUMS,
    no collective after the gather (the caller divides by B_global)."""
    if reduce not in ("pmean", "sum_shards"):
        raise ValueError(f"unknown reduce {reduce!r}")
    b_local = qh.shape[0]
    if global_pool:
        pool = AllGather.apply(dh, mesh.groups["data"])
        offset = mesh.coords["data"] * b_local
    else:
        pool, offset = dh, 0
    labels = offset + torch.arange(b_local, dtype=torch.int32,
                                   device=qh.device)
    loss, aux = in_batch_loss(qh, pool, gamma, labels, impl=impl)
    if reduce == "sum_shards":
        return loss * b_local, {k: v * b_local for k, v in aux.items()}
    return _pmean(loss, aux, mesh)


def rotate_loss_sharded(
    qh: torch.Tensor, dh: torch.Tensor, offsets: torch.Tensor, gamma: float,
    mesh,
) -> Tuple[torch.Tensor, Aux]:
    """rotate_loss over the whole batch on this rank's data shard: the docs
    all-gathered over the data group, the local queries' candidates taken
    at their global rows."""
    pool = AllGather.apply(dh, mesh.groups["data"])
    loss, aux = rotate_loss(qh, pool, offsets, gamma,
                            row_offset=mesh.coords["data"] * qh.shape[0])
    return _pmean(loss, aux, mesh)
