"""Serving path: embed a document corpus once, retrieve top-k per query.

  build_doc_index: doc-tower forward over the corpus (dedup batches, the
      tail batch padded to the full batch size) -> [N, D] unit-norm f32;
      on the card a batch is one replay of the one-side forward graph
      (train/eval.py::EMBED, dssm_tpu's jitted _embed_fwd).
  top_k: brute-force retrieval, chunked over queries; each chunk's [C, N]
      f32 score block stays on the device and only [Q, k] comes back. On
      the card every chunk and the ragged tail run in one graph (TOPK,
      dssm_tpu's jitted scan _topk_all / _topk_all_approx). Exact by
      default; exact=False is approx_max_k's binned approximation, the
      function dssm_tpu's lax.approx_max_k computes on a TPU.

With eager=True (or impl="plain") the same functions run eagerly on the
card (the reference); on the CPU they always do.

Index file format (shared with dssm_tpu.serve): .npz with `doc_emb` [N, D]
f32 and `titles` [N] (object array of the indexed texts).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dssm_tpu_torch.bridge import batch_to_device
from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.data.loader import eval_batches, hash_pairs, pad_batch
from dssm_tpu_torch.data.remap import apply_remap
from dssm_tpu_torch.data.toy import ToyPairs
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.kernels.gather import sublane_group
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.train.compiled import CompiledForward
from dssm_tpu_torch.train.eval import EMBED

_QUERY_CHUNK = 1024


def _embed_side(
    params: model_base.Params,
    cfg: RunConfig,
    texts: Sequence[str],
    side: str,
    batch_size: int,
    impl: str,
    remap: Optional[np.ndarray],
    device: DeviceLike,
    eager: bool = False,
) -> np.ndarray:
    """Embed raw texts through one tower (padded tail batches), a batch a
    call of EMBED: one replay on the card, cached on the tower config,
    impl, side, parameters and batch layout.

    `remap`: the vocab permutation training applied (data/remap.py) — table
    rows live at remapped positions, so serving inputs go through it too."""
    dev = as_device(device)
    table = model_base.tower_params(params, side)[
        model_base.TABLE_KEY[cfg.tower.arch]]
    if table.device.type != dev.type:
        raise ValueError(f"parameters are on {table.device}, not {dev}")
    # Hash through the standard pipeline, so the batches (and their union
    # dedupe) are the loader's own. The unused side is hashed too, as
    # dssm_tpu's serving path does; hashing only the embedded side would
    # save that host time.
    hashed = hash_pairs(ToyPairs(queries=list(texts), titles=list(texts)),
                        cfg.tower, cfg.data)
    if remap is not None:
        hashed = apply_remap(hashed, remap)
    dedup = cfg.data.dedup_lookup
    out = torch.empty((len(texts), cfg.tower.semantic_dim),
                      dtype=torch.float32, device=table.device)
    lo = 0
    for batch in eval_batches(
        hashed, batch_size,
        dedup_unique=cfg.data.max_unique if dedup else None,
        dedup_group=sublane_group(table.dtype),
        dedup_unique_rows=cfg.data.max_unique_rows if dedup else None,
        dedup_joint=cfg.tower.shared_weights,
        sequence=cfg.tower.is_sequence_model,
    ):
        n = batch["q_wgt"].shape[0]
        wire = batch_to_device(pad_batch(batch, batch_size), table.device,
                               vocab_size=table.shape[0])
        (emb,) = EMBED(params, wire, device=table.device,
                       eager=eager or impl == "plain", tower=cfg.tower,
                       impl=impl, sides=side)
        out[lo:lo + n].copy_(emb[:n])
        lo += n
    return out[:lo].cpu().numpy()


def build_doc_index(
    params: model_base.Params,
    cfg: RunConfig,
    titles: Sequence[str],
    batch_size: int = 256,
    impl: str = "auto",
    remap: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
    eager: bool = False,
) -> np.ndarray:
    """Doc-tower embeddings for the corpus -> [N, D] unit-norm f32."""
    return _embed_side(params, cfg, titles, "d", batch_size, impl, remap,
                       device, eager)


def embed_queries(
    params: model_base.Params,
    cfg: RunConfig,
    queries: Sequence[str],
    batch_size: int = 256,
    impl: str = "auto",
    remap: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
    eager: bool = False,
) -> np.ndarray:
    """Query-tower embeddings -> [Q, D] unit-norm f32."""
    return _embed_side(params, cfg, queries, "q", batch_size, impl, remap,
                       device, eager)


def save_index(path: str, doc_emb: np.ndarray, titles: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, doc_emb=doc_emb.astype(np.float32),
                        titles=np.asarray(list(titles), dtype=object))


def load_index(path: str) -> Tuple[np.ndarray, List[str]]:
    # The titles are a pickled object array: load only index files this
    # package (or dssm_tpu) wrote.
    with np.load(path, allow_pickle=True) as z:
        return z["doc_emb"], list(z["titles"])


def approx_bins(n: int, k: int, recall_target: float = 0.95) -> int:
    """The bin count L of approx_max_k over n scores: the smallest L at
    which the expected recall of the binned top-k, with the top k spread at
    random over the bins, (L / k) * (1 - (1 - 1/L)**k), reaches
    recall_target (Chern et al. 2022, "TPU-KNN"); at least k, at most n."""
    bins = k
    while bins < n and (bins / k) * (1 - (1 - 1 / bins) ** k) < recall_target:
        bins += 1
    return min(bins, n)


def approx_max_k(scores: torch.Tensor, k: int, recall_target: float = 0.95
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of lax.approx_max_k(scores, k, recall_target) with
    aggregate_to_topk, over the last axis: the N scores of a row, padded
    with -inf, fall into L = approx_bins(N, k) bins (score j into bin
    j % L); each bin keeps its best score and its id, and the exact top k
    of the L winners come back, scores descending, ids int64. Two top-k
    scores that share a bin lose the lower one, which is the
    approximation; with L = N every score is its own bin and the result is
    the exact top k."""
    n = scores.shape[-1]
    k = min(k, n)
    bins = approx_bins(n, k, recall_target)
    per_bin = -(-n // bins)
    padded = F.pad(scores, (0, per_bin * bins - n), value=float("-inf"))
    best, row = padded.view(*scores.shape[:-1], per_bin, bins).max(dim=-2)
    top, col = torch.topk(best, k, dim=-1)
    return top, torch.gather(row, -1, col) * bins + col


def _top_k_all(_, q: torch.Tensor, d: torch.Tensor, *, k: int, chunk: int,
               exact: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every query chunk of `chunk` rows and the ragged tail: (scores
    [Q, k], ids [Q, k]). A chunk's [C, N] score block is freed before the
    next one's is made, so a graph's pool holds about one."""
    scores, ids = [], []
    for lo in range(0, q.shape[0], chunk):
        block = q[lo:lo + chunk] @ d.T
        s, i = (torch.topk(block, k, dim=1) if exact
                else approx_max_k(block, k))
        del block
        scores.append(s)
        ids.append(i)
    return torch.cat(scores), torch.cat(ids)


# One graph a (Q, N, D, k, chunk, exact): dssm_tpu's jitted _topk_all and
# _topk_all_approx. An index on the card is read where it lies (the graph
# keyed on its address); one held as numpy (cli.export) is copied into a
# static buffer its graphs share, so it replays on the next call.
TOPK = CompiledForward(_top_k_all)


def top_k(
    query_emb,
    doc_emb,
    k: int = 10,
    chunk: int = _QUERY_CHUNK,
    exact: bool = True,
    device: DeviceLike = "cuda",
    eager: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force retrieval: (scores [Q, k] f32, doc_ids [Q, k] int64),
    scores descending. exact=True: torch.topk of each query's scores.
    exact=False: approx_max_k at recall_target 0.95, as dssm_tpu's
    top_k(exact=False) asks lax.approx_max_k (which runs its binned
    approximation on a TPU and an exact top-k elsewhere). Accepts numpy
    arrays or tensors. On the card one replay of TOPK (eager=True runs the
    same chunks eagerly); pass a doc index that is queried again as a
    tensor on the card, which the graph reads in place."""
    dev = as_device(device)
    q = torch.as_tensor(query_emb, dtype=torch.float32)
    d = torch.as_tensor(doc_emb, dtype=torch.float32)
    k = min(k, d.shape[0])
    if q.shape[0] == 0:
        return (np.zeros((0, k), dtype=np.float32),
                np.zeros((0, k), dtype=np.int64))
    s, i = TOPK({}, q, d, device=dev, eager=eager, k=k,
                chunk=min(chunk, q.shape[0]), exact=exact)
    return s.cpu().numpy(), i.cpu().numpy().astype(np.int64)
