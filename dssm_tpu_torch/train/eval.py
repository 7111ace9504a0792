"""Retrieval evaluation: Recall@K, NDCG@10 and MRR over the full eval corpus
(every query ranked against every eval doc, the true doc being the aligned
title). Counterpart of dssm_tpu/train/eval.py.

Eval runs the same path as training: batches carry the dedup fields, the
tail batch is padded to the full batch size, both towers embed each batch,
and the embeddings stay on the device. Ranking is the streaming rank-count
kernel on the card (kernels/rank.py): the [N, N] score matrix is never
formed, and only the [N] ranks cross to the host.

The eval corpus is fixed for a run, so its host pipeline (slicing, dedupe,
wire compression) and the host->device copies are paid once: an EvalCache
keeps the prepared batches on the device, and every later evaluate() pays
only the embed forward and the rank. The reference stacks K batches per
device dispatch to amortize a relay round trip; eager PyTorch has none, so
the cache holds plain batches.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.data.loader import (
    HashedPairs, eval_batches, pad_batch, prefetch)
from dssm_tpu_torch.kernels.gather import sublane_group
from dssm_tpu_torch.kernels.rank import rank_counts
from dssm_tpu_torch.models import base as model_base

DeviceBatch = Dict[str, torch.Tensor]


def _host_batches(cfg: RunConfig, hashed: HashedPairs, batch_size: int,
                  group: int, device: torch.device,
                  vocab_size: Optional[int] = None,
                  ) -> Iterator[Tuple[DeviceBatch, int]]:
    """(batch on `device` padded to batch_size rows, live rows) through the
    whole host pipeline: slicing, two-level dedupe, wire compression
    (sequence batches keep their full layout, as in dssm_tpu). As in
    dssm_tpu, the batches are built on a pool of at least 2 threads
    (data.pipeline_workers) and a prefetch thread 4 batches ahead, beside
    the device's work on the batches before. Given the table's vocab_size
    rows, a raw batch's lookups are checked against them on the host."""
    dedup = cfg.data.dedup_lookup
    sequence = cfg.tower.is_sequence_model
    for batch in prefetch(eval_batches(
        hashed, batch_size,
        dedup_unique=cfg.data.max_unique if dedup else None,
        dedup_group=group,
        dedup_unique_rows=cfg.data.max_unique_rows if dedup else None,
        dedup_joint=cfg.tower.shared_weights,
        wire_compress=dedup and not sequence,
        sequence=sequence,
        pipeline_workers=max(2, cfg.data.pipeline_workers),
    ), depth=4):
        n = batch["q_wgt"].shape[0]
        yield batch_to_torch(pad_batch(batch, batch_size), device,
                             vocab_size=vocab_size), n


class EvalCache:
    """The prepared eval batches of one corpus, resident on the device. The
    first eval fills it as it goes; it counts as complete only when the
    pass reached the end of the corpus, so an aborted pass never leaves a
    truncated corpus behind."""

    def __init__(self):
        self.batches: List[Tuple[DeviceBatch, int]] = []
        self.complete = False

    def fill_from(self, src: Iterator[Tuple[DeviceBatch, int]]):
        for item in src:
            self.batches.append(item)
            yield item
        self.complete = True


# [(key, weakref to the corpus, EvalCache)]: a tiny LRU, one eval corpus a
# run as a rule.
_EVAL_CACHES: list = []
_EVAL_CACHE_CAP = 4


def _cache_key(cfg: RunConfig, hashed: HashedPairs, batch_size: int,
               group: int, device: torch.device):
    """The corpus object's identity and every config field that shapes a
    batch's content; the weakref beside it guards against id() reuse."""
    return (id(hashed), batch_size, group, str(device),
            cfg.data.dedup_lookup, cfg.data.max_unique,
            cfg.data.max_unique_rows, cfg.tower.shared_weights,
            cfg.tower.is_sequence_model)


def _registry_get(key, hashed) -> Optional[EvalCache]:
    # An entry whose corpus was collected can never match again but would
    # pin its batches in device memory until the LRU drops it.
    _EVAL_CACHES[:] = [e for e in _EVAL_CACHES if e[1]() is not None]
    for k, ref, cache in _EVAL_CACHES:
        if k == key and ref() is hashed and cache.complete:
            return cache
    return None


def _registry_put(key, hashed, cache: EvalCache) -> None:
    _EVAL_CACHES[:] = [e for e in _EVAL_CACHES
                       if e[0] != key and e[1]() is not None]
    _EVAL_CACHES.append((key, weakref.ref(hashed), cache))
    while len(_EVAL_CACHES) > _EVAL_CACHE_CAP:
        _EVAL_CACHES.pop(0)


def embed_corpus(params: model_base.Params, cfg: RunConfig,
                 hashed: HashedPairs, batch_size: int = 256,
                 impl: str = "auto", *, cache=None,
                 stats: Optional[Dict[str, float]] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only embed of the whole eval corpus -> (Q [N, D], Dm [N, D])
    f32 on the parameters' device.

    cache: an EvalCache, True (use / fill the registry) or None / False (run
    the host pipeline again). stats, when given, receives host_prep_s (time
    spent fetching batches: preparing and moving them, or reading the
    cache) and cache_hit."""
    table = next(iter(params.values()))[model_base.TABLE_KEY[cfg.tower.arch]]
    device = table.device
    group = sublane_group(table.dtype)
    fresh = _host_batches(cfg, hashed, batch_size, group, device,
                          table.shape[0])
    hit = False
    if cache is True:
        key = _cache_key(cfg, hashed, batch_size, group, device)
        found = _registry_get(key, hashed)
        if found is not None:
            batches, hit = iter(found.batches), True
        else:
            new = EvalCache()
            _registry_put(key, hashed, new)
            batches = new.fill_from(fresh)
    elif isinstance(cache, EvalCache):
        if cache.complete:
            batches, hit = iter(cache.batches), True
        else:
            cache.batches.clear()  # a partial list would truncate the corpus
            batches = cache.fill_from(fresh)
    else:
        batches = fresh

    towers = {s: model_base.tower_module(params, cfg.tower, s) for s in "qd"}
    qs, ds = [], []
    host_s = 0.0
    with torch.no_grad():
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            host_s += time.perf_counter() - t0
            if item is None:
                break
            tb, rows = item
            qs.append(towers["q"](tb, "q", impl=impl)[:rows])
            ds.append(towers["d"](tb, "d", impl=impl)[:rows])
    if stats is not None:
        stats["host_prep_s"] = host_s
        stats["cache_hit"] = float(hit)
    if not qs:
        empty = torch.zeros((0, cfg.tower.semantic_dim), device=device)
        return empty, empty.clone()
    return torch.cat(qs), torch.cat(ds)


def compute_ranks(q: torch.Tensor, d: torch.Tensor, *,
                  impl: str = "auto") -> np.ndarray:
    """Per-query rank of the aligned true doc, [N] int32 on the host; the
    scores never leave the device."""
    return rank_counts(q.float().contiguous(), d.float().contiguous(),
                       impl=impl).cpu().numpy()


def metrics_from_ranks(ranks: np.ndarray, ks=(1, 10)) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in ks:
        out[f"recall@{k}"] = float((ranks <= k).mean())
    out["ndcg@10"] = float(
        np.where(ranks <= 10, 1.0 / np.log2(1 + ranks), 0.0).mean())
    out["mrr"] = float((1.0 / ranks).mean())
    out["num_queries"] = float(ranks.shape[0])
    return out


def ranking_metrics(q: torch.Tensor, d: torch.Tensor, ks=(1, 10), *,
                    impl: str = "auto") -> Dict[str, float]:
    """q, d: [N, D] unit vectors, the true doc of query i being d[i].
    rank_i = 1 + the docs scoring strictly higher than the true doc (ties
    break in the model's favour)."""
    return metrics_from_ranks(compute_ranks(q, d, impl=impl), ks)


def evaluate(params: model_base.Params, cfg: RunConfig, hashed: HashedPairs,
             batch_size: int = 256, impl: str = "auto", cache=True,
             stats: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Metrics of `params` on the eval corpus. With `stats` the device is
    waited for between the phases and stats receives host_prep_s, embed_s
    (the pass over the batches less the host prep), rank_s and cache_hit."""
    timed = stats is not None
    dev_wait = (torch.cuda.synchronize
                if timed and torch.cuda.is_available() else lambda: None)
    t0 = time.perf_counter()
    q, d = embed_corpus(params, cfg, hashed, batch_size, impl, cache=cache,
                        stats=stats)
    dev_wait()
    t1 = time.perf_counter()
    metrics = ranking_metrics(q, d, impl=impl)
    if timed:
        stats["embed_s"] = t1 - t0 - stats["host_prep_s"]
        stats["rank_s"] = time.perf_counter() - t1
    return metrics
