"""Retrieval evaluation: Recall@K, NDCG@10 and MRR over the full eval corpus
(every query ranked against every eval doc, the true doc being the aligned
title). Counterpart of dssm_tpu/train/eval.py.

Eval runs the same path as training: batches carry the dedup fields, the
tail batch is padded to the full batch size, both towers embed each batch,
and the embeddings stay on the device. As in dssm_tpu, K = _k_block(N, B)
batches are stacked a block (the tail block padded to K batches by
repeating its last one), so one compiled forward serves every block: on the
card a block is one replay of a CUDA graph of K bodies (EMBED_STACKED,
train/compiled.py::CompiledForward; dssm_tpu's jitted lax.scan,
_embed_fwd_stacked), writing the live rows into the [N, D] embeddings.
Ranking is one more graph, the true scores and the streaming rank-count
kernel (kernels/rank.py): the [N, N] score matrix is never formed, and only
the [N] ranks cross to the host. On the CPU, and with eager=True or
impl="plain", the same bodies run eagerly (the reference).

The eval corpus is fixed for a run, so its host pipeline (slicing, dedupe,
wire compression, stacking) and the host->device copies are paid once: an
EvalCache keeps the stacked, compressed wire blocks on the device, and every
later evaluate() pays only the embed forward and the rank.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dssm_tpu_torch.bridge import WireBatch, batch_to_device
from dssm_tpu_torch.config import RunConfig, TowerConfig
from dssm_tpu_torch.data.loader import (
    HashedPairs, eval_batches, pad_batch, prefetch)
from dssm_tpu_torch.kernels.gather import sublane_group
from dssm_tpu_torch.kernels.rank import rank_counts
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.train.compiled import CompiledForward
from dssm_tpu_torch.train.loop import stack_batches

Block = Tuple[WireBatch, int]


def _embed_sides(params: model_base.Params, fields: Dict[str, torch.Tensor],
                 *, tower: TowerConfig, impl: str, sides: str
                 ) -> Tuple[torch.Tensor, ...]:
    """Each side's tower on one batch: ([B, D] f32, ...) in `sides` order."""
    return tuple(model_base.embed(params, tower, s, fields, impl=impl)
                 for s in sides)


# One batch a call (serving's _embed_side), and K batches a call (an eval
# block): dssm_tpu's _embed_fwd and _embed_fwd_stacked.
EMBED = CompiledForward(_embed_sides)
EMBED_STACKED = CompiledForward(_embed_sides, multi=True)


def _k_block(n_total: int, batch_size: int) -> int:
    """Batches a block: all of them, at most 64 (dssm_tpu's _k_block: at
    the full preset's 65,536 pairs one block a pass)."""
    return max(1, min(64, (n_total + batch_size - 1) // batch_size))


def _host_blocks(cfg: RunConfig, hashed: HashedPairs, batch_size: int,
                 group: int, k_block: int, device: torch.device,
                 vocab_size: Optional[int] = None) -> Iterator[Block]:
    """(K-batch block bound for `device`, live rows) through the whole host
    pipeline: slicing, two-level dedupe, wire compression (sequence batches
    keep their full layout, as in dssm_tpu), the tail batch padded to
    batch_size rows and the tail block to k_block batches by repeating its
    last batch. As in dssm_tpu, the batches are built on a pool of at least
    2 threads (data.pipeline_workers) and a prefetch thread 4 batches
    ahead, beside the device's work on the blocks before. Given the table's
    vocab_size rows, a raw batch's lookups are checked against them on the
    host."""
    dedup = cfg.data.dedup_lookup
    sequence = cfg.tower.is_sequence_model
    batches = prefetch(eval_batches(
        hashed, batch_size,
        dedup_unique=cfg.data.max_unique if dedup else None,
        dedup_group=group,
        dedup_unique_rows=cfg.data.max_unique_rows if dedup else None,
        dedup_joint=cfg.tower.shared_weights,
        wire_compress=dedup and not sequence,
        sequence=sequence,
        pipeline_workers=max(2, cfg.data.pipeline_workers),
    ), depth=4)
    done = False
    while not done:
        block, rows = [], 0
        for batch in batches:
            rows += batch["q_wgt"].shape[0]
            block.append(pad_batch(batch, batch_size))
            if len(block) == k_block:
                break
        else:
            done = True
        if not block:
            break
        block += [block[-1]] * (k_block - len(block))
        yield batch_to_device(stack_batches(block), device, vocab_size), rows


class EvalCache:
    """The stacked wire blocks of one corpus, resident on the device
    (dssm_tpu's EvalCache). The first eval fills it as it goes; it counts as
    complete only when the pass reached the end of the corpus, so an aborted
    pass never leaves a truncated corpus behind."""

    def __init__(self):
        self.blocks: List[Block] = []
        self.complete = False

    def fill_from(self, src: Iterator[Block]) -> Iterator[Block]:
        for wire, rows in src:
            self.blocks.append((wire.to_device(), rows))
            yield wire, rows
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
    # pin its blocks in device memory until the LRU drops it.
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


def _table(params: model_base.Params, cfg: RunConfig) -> torch.Tensor:
    return next(iter(params.values()))[model_base.TABLE_KEY[cfg.tower.arch]]


def embed_corpus(params: model_base.Params, cfg: RunConfig,
                 hashed: HashedPairs, batch_size: int = 256,
                 impl: str = "auto", *, cache=None,
                 stats: Optional[Dict[str, float]] = None,
                 eager: bool = False,
                 out: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only embed of the whole eval corpus -> (Q [N, D], Dm [N, D])
    f32 on the parameters' device: a K-batch block a call of EMBED_STACKED,
    a graph replay on the card, with no wait between blocks.

    cache: an EvalCache, True (use / fill the registry) or None / False (run
    the host pipeline again). stats, when given, receives host_prep_s (time
    spent fetching blocks: preparing and moving them, or reading the cache)
    and cache_hit. eager=True (or impl="plain") runs the blocks' bodies
    eagerly on the card too. out: a [2, N, D] f32 tensor on that device to
    write the embeddings into (default: a new one)."""
    table = _table(params, cfg)
    device = table.device
    group = sublane_group(table.dtype)
    n_total = len(hashed)
    fresh = _host_blocks(cfg, hashed, batch_size, group,
                         _k_block(n_total, batch_size), device, table.shape[0])
    hit = False
    if cache is True:
        key = _cache_key(cfg, hashed, batch_size, group, device)
        found = _registry_get(key, hashed)
        if found is not None:
            blocks, hit = iter(found.blocks), True
        else:
            new = EvalCache()
            _registry_put(key, hashed, new)
            blocks = new.fill_from(fresh)
    elif isinstance(cache, EvalCache):
        if cache.complete:
            blocks, hit = iter(cache.blocks), True
        else:
            cache.blocks.clear()  # a partial list would truncate the corpus
            blocks = cache.fill_from(fresh)
    else:
        blocks = fresh

    dim = cfg.tower.semantic_dim
    if out is None:
        out = torch.empty((2, n_total, dim), dtype=torch.float32,
                          device=device)
    filled, host_s = 0, 0.0
    while True:
        t0 = time.perf_counter()
        item = next(blocks, None)
        host_s += time.perf_counter() - t0
        if item is None:
            break
        wire, rows = item
        embs = EMBED_STACKED(params, wire, device=device,
                             eager=eager or impl == "plain", tower=cfg.tower,
                             impl=impl, sides="qd")
        for side, emb in zip(out, embs):
            side[filled:filled + rows].copy_(emb.reshape(-1, dim)[:rows])
        filled += rows
    if stats is not None:
        stats["host_prep_s"] = host_s
        stats["cache_hit"] = float(hit)
    return out[0, :filled], out[1, :filled]


def _ranks(_, q: torch.Tensor, d: torch.Tensor, *, impl: str
           ) -> torch.Tensor:
    return rank_counts(q, d, impl=impl)


# The rank pass, one graph a (N, ND, D) and the embeddings' addresses:
# dssm_tpu's jitted _rank_all, reading q and d where they lie.
RANK = CompiledForward(_ranks)

# evaluate's embeddings, {(N, D, device): [2, N, D] f32}: the last
# _EVAL_CACHE_CAP shapes' buffers, kept for their next pass, so that the
# pass replays the rank graph of the pass before.
_EVAL_EMB: "collections.OrderedDict[tuple, torch.Tensor]" = (
    collections.OrderedDict())


def _eval_emb(n: int, dim: int, device: torch.device) -> torch.Tensor:
    key = (n, dim, str(device))
    buf = _EVAL_EMB.pop(key, None)
    if buf is None:
        while len(_EVAL_EMB) >= _EVAL_CACHE_CAP:
            _EVAL_EMB.popitem(last=False)  # freed before the next is made
        buf = torch.empty((2, n, dim), dtype=torch.float32, device=device)
    _EVAL_EMB[key] = buf
    return buf


def compute_ranks(q: torch.Tensor, d: torch.Tensor, *,
                  impl: str = "auto", eager: bool = False) -> np.ndarray:
    """Per-query rank of the aligned true doc, [N] int32 on the host; the
    scores never leave the device. On the card one replay of RANK (eager
    with eager=True or impl="plain"), which reads q and d where they lie:
    the graph is keyed on their addresses."""
    q, d = q.float().contiguous(), d.float().contiguous()
    ranks = RANK({}, q, d, device=q.device,
                 eager=eager or impl == "plain" or q.shape[0] == 0, impl=impl)
    return ranks.cpu().numpy()


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
                    impl: str = "auto", eager: bool = False
                    ) -> Dict[str, float]:
    """q, d: [N, D] unit vectors, the true doc of query i being d[i].
    rank_i = 1 + the docs scoring strictly higher than the true doc (ties
    break in the model's favour)."""
    return metrics_from_ranks(compute_ranks(q, d, impl=impl, eager=eager),
                              ks)


def evaluate(params: model_base.Params, cfg: RunConfig, hashed: HashedPairs,
             batch_size: int = 256, impl: str = "auto", cache=True,
             stats: Optional[Dict[str, float]] = None,
             eager: bool = False) -> Dict[str, float]:
    """Metrics of `params` on the eval corpus: embed_corpus, then
    compute_ranks (replayed graphs on the card; eager=True runs both
    eagerly, the reference). With `stats` the device is waited for between
    the phases and stats receives host_prep_s, embed_s (the pass over the
    blocks less the host prep), rank_s and cache_hit. The embeddings go
    into a buffer kept for the next pass of the same shape (_eval_emb)."""
    timed = stats is not None
    dev_wait = (torch.cuda.synchronize
                if timed and torch.cuda.is_available() else lambda: None)
    t0 = time.perf_counter()
    emb = _eval_emb(len(hashed), cfg.tower.semantic_dim,
                    _table(params, cfg).device)
    q, d = embed_corpus(params, cfg, hashed, batch_size, impl, cache=cache,
                        stats=stats, eager=eager, out=emb)
    dev_wait()
    t1 = time.perf_counter()
    metrics = ranking_metrics(q, d, impl=impl, eager=eager)
    if timed:
        stats["embed_s"] = t1 - t0 - stats["host_prep_s"]
        stats["rank_s"] = time.perf_counter() - t1
    return metrics
