"""Serving path: embed a document corpus once, retrieve top-k per query.

  build_doc_index: doc-tower forward over the corpus (dedup batches, the
      tail batch padded to the full batch size) -> [N, D] unit-norm f32.
  top_k: exact brute-force retrieval, chunked over queries; each chunk's
      [C, N] f32 score block stays on the device and only [C, k] comes back.

Index file format (shared with dssm_tpu.serve): .npz with `doc_emb` [N, D]
f32 and `titles` [N] (object array of the indexed texts).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.data.loader import eval_batches, hash_pairs, pad_batch
from dssm_tpu_torch.data.remap import apply_remap
from dssm_tpu_torch.data.toy import ToyPairs
from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.kernels.gather import sublane_group
from dssm_tpu_torch.models import base as model_base

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
) -> np.ndarray:
    """Embed raw texts through one tower (padded tail batches).

    `remap`: the vocab permutation training applied (data/remap.py) — table
    rows live at remapped positions, so serving inputs go through it too."""
    dev = as_device(device)
    tower = model_base.tower_module(params, cfg.tower, side)
    table = tower.W0
    if table.device.type != dev.type:
        raise ValueError(f"parameters are on {table.device}, not {dev}")
    # Hash through the standard pipeline, so the batches (and their union
    # dedupe) are the loader's own. The unused side is hashed too, which
    # costs host time (ROADMAP.md, Queue 1: hash only the embedded side).
    hashed = hash_pairs(ToyPairs(queries=list(texts), titles=list(texts)),
                        cfg.tower, cfg.data)
    if remap is not None:
        hashed = apply_remap(hashed, remap)
    dedup = cfg.data.dedup_lookup
    outs = []
    with torch.no_grad():
        for batch in eval_batches(
            hashed, batch_size,
            dedup_unique=cfg.data.max_unique if dedup else None,
            dedup_group=sublane_group(table.dtype),
            dedup_unique_rows=cfg.data.max_unique_rows if dedup else None,
            dedup_joint=cfg.tower.shared_weights,
        ):
            n = batch["q_wgt"].shape[0]
            tb = batch_to_torch(pad_batch(batch, batch_size), dev)
            outs.append(tower(tb, side, impl=impl)[:n])
    if not outs:
        return np.zeros((0, cfg.tower.semantic_dim), dtype=np.float32)
    return torch.cat(outs).cpu().numpy()


def build_doc_index(
    params: model_base.Params,
    cfg: RunConfig,
    titles: Sequence[str],
    batch_size: int = 256,
    impl: str = "auto",
    remap: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Doc-tower embeddings for the corpus -> [N, D] unit-norm f32."""
    return _embed_side(params, cfg, titles, "d", batch_size, impl, remap,
                       device)


def embed_queries(
    params: model_base.Params,
    cfg: RunConfig,
    queries: Sequence[str],
    batch_size: int = 256,
    impl: str = "auto",
    remap: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    return _embed_side(params, cfg, queries, "q", batch_size, impl, remap,
                       device)


def save_index(path: str, doc_emb: np.ndarray, titles: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, doc_emb=doc_emb.astype(np.float32),
                        titles=np.asarray(list(titles), dtype=object))


def load_index(path: str) -> Tuple[np.ndarray, List[str]]:
    # The titles are a pickled object array: load only index files this
    # package (or dssm_tpu) wrote.
    with np.load(path, allow_pickle=True) as z:
        return z["doc_emb"], list(z["titles"])


def top_k(
    query_emb,
    doc_emb,
    k: int = 10,
    chunk: int = _QUERY_CHUNK,
    exact: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact brute-force retrieval: (scores [Q, k] f32, doc_ids [Q, k] int64),
    scores descending. Accepts numpy arrays or tensors."""
    if not exact:
        raise NotImplementedError(
            "approximate top-k (dssm_tpu's lax.approx_max_k) is not ported "
            "yet (ROADMAP.md, Queue 1: approximate top-k)")
    dev = as_device(device)
    q = torch.as_tensor(query_emb, dtype=torch.float32, device=dev)
    d = torch.as_tensor(doc_emb, dtype=torch.float32, device=dev)
    k = min(k, d.shape[0])
    if q.shape[0] == 0:
        return (np.zeros((0, k), dtype=np.float32),
                np.zeros((0, k), dtype=np.int64))
    scores, ids = [], []
    for lo in range(0, q.shape[0], chunk):
        s, i = torch.topk(q[lo:lo + chunk] @ d.T, k, dim=1)
        scores.append(s)
        ids.append(i)
    return (torch.cat(scores).cpu().numpy(),
            torch.cat(ids).cpu().numpy().astype(np.int64))
