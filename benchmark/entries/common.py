"""What the drivers share: the outcome they hand back, the corpus the
benchmark makes, and freeing the program's state before the reference."""

from __future__ import annotations

import gc
import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import gen
from benchmark.core import Stretch
from benchmark.trace import Trace

# Streams of a run's seed (WORDS: gen.word_vocab's).
WORDS, TRAIN, EVAL, INDEX, WEIGHTS, LOADER, REQUESTS, SAMPLE = range(8)


@dataclass
class Outcome:
    metrics: Dict[str, float]        # end to end, by name
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, float]         # compared numbers, by name
    stretch: Optional[Stretch] = None
    trace: Optional[Trace] = None
    notes: List[str] = field(default_factory=list)


class Phases:
    """Seconds since the run's start at each named point of its set-up,
    for the run's notes."""

    def __init__(self, t_start: float):
        self.t_start, self.marks = t_start, []

    def __call__(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t_start))

    def note(self) -> str:
        return "set-up s: " + ", ".join(f"{n} {t:.3f}" for n, t in self.marks)


def n_train(cfg) -> int:
    """The training split of the configuration's toy corpus (its held-out
    share taken away, as the program's train_eval_split cuts it)."""
    n = cfg.data.toy_num_pairs
    return n - max(1, int(n * cfg.data.eval_frac))


def pairs(cell, cfg, n: int, seed: int, stream: int
          ) -> Tuple[List[str], List[str]]:
    """n (query, title) pairs of the configuration's corpus, from one
    stream of the seed."""
    return gen.toy_pairs(n, cfg.data.toy_vocab_words, seed, stream,
                         cell.config.get("corpus"))


def train_corpus(cell, cfg, seed: int) -> Tuple[List[str], List[str]]:
    return pairs(cell, cfg, n_train(cfg), seed, TRAIN)


def reference(cfg):
    """The plain reference of the configuration's tower family."""
    return importlib.import_module(f"benchmark.reference.{cfg.tower.arch}")


def program_params(cfg, tower: Dict, seed: int, device) -> Dict:
    """The benchmark's weights handed to the program, the table in the
    configuration's storage dtype."""
    import torch

    p = reference(cfg).init_params(tower, gen.torch_seed(seed, WEIGHTS),
                                   device)
    dt = cfg.tower.table_dtype_resolved
    if dt == "bfloat16":
        p["W0"] = p["W0"].to(torch.bfloat16)
    elif dt != "float32":
        raise ValueError(f"the benchmark makes f32 and bf16 tables, not {dt}")
    if not cfg.tower.shared_weights:
        raise ValueError("the benchmark's reference shares one tower")
    return {"shared": p}


def reference_params(cfg, tower: Dict, seed: int, device) -> Dict:
    return reference(cfg).init_params(tower, gen.torch_seed(seed, WEIGHTS),
                                      device)


def encoded(cfg, queries, titles, remap: Optional[np.ndarray] = None):
    """The reference's encoding of (queries, titles), ids remapped."""
    from benchmark.reference import text

    v = cfg.tower.vocab_size
    kq = cfg.data.max_trigrams_query or cfg.data.max_trigrams
    q = text.encode(queries, v, kq, cfg.data.normalize_counts)
    d = text.encode(titles, v, cfg.data.max_trigrams,
                    cfg.data.normalize_counts)
    if remap is not None:
        q, d = (remap[q[0]], q[1]), (remap[d[0]], d[1])
    return q, d


def reference_remap(cfg, queries, titles) -> Optional[np.ndarray]:
    """The frequency remap the reference works out from the training
    corpus, as the program's training set-up derives it."""
    from benchmark.reference import text

    if not cfg.data.freq_remap:
        return None
    q, d = encoded(cfg, queries, titles)
    return text.freq_remap(text.doc_freq([q, d], cfg.tower.vocab_size),
                           cfg.mesh.model_parallel)


def settle() -> None:
    """End set-up: collect its garbage and freeze what is left, so that no
    collection walks set-up's millions of objects (texts, hashed corpora)
    inside the window."""
    gc.collect()
    gc.freeze()


@dataclass
class TrainInputs:
    """What the reference needs to follow a training cell's steps: the
    corpus's encoding (ids remapped) and the loader's epoch order, which
    every epoch replays (reshuffle_each_epoch=False)."""
    enc: list          # [(q ids, q weights), (d ids, d weights)]
    perm: np.ndarray   # the epoch's row order
    batch: int

    def rows(self, s: int) -> np.ndarray:
        """The rows of step s, counted from the first epoch's first."""
        s %= len(self.perm) // self.batch
        return self.perm[s * self.batch:(s + 1) * self.batch]


def train_inputs(cfg, queries, titles, loader_seed: int) -> TrainInputs:
    """The reference's own view of a training stream: it hashes and remaps
    the texts itself, and draws the loader's epoch order by its rule
    (data/loader.batch_iterator: default_rng((seed, 0)).permutation(n),
    cut into whole batches, at reshuffle_each_epoch=False)."""
    q, d = encoded(cfg, queries, titles,
                   reference_remap(cfg, queries, titles))
    perm = np.random.default_rng((loader_seed, 0)).permutation(len(queries))
    return TrainInputs([q, d], perm, cfg.train.batch_size)


@dataclass
class RefSteps:
    """The reference's run of a training stream: every step's loss, the
    first step's gradient by leaf ("W0" the table's [V, H0] columns), the
    change's norm by leaf after the first `n_change` steps, and the
    parameters at the end (the program's layout)."""
    losses: List[float]
    grad: Dict
    change: Dict[str, float]
    params: Dict


def reference_steps(cfg, tower: Dict, seed: int, inputs: TrainInputs,
                    steps: int, n_change: int, device,
                    precision: str = "f32", first: int = 0,
                    start: Optional[Dict] = None) -> RefSteps:
    """The reference's `steps` SGD steps of the stream from step `first`:
    from the benchmark's weights, or from the parameters `start` (the
    program's layout, f32)."""
    import torch

    ref = reference(cfg)
    p0 = (reference_params(cfg, tower, seed, device) if start is None
          else start)
    p = {k: v.clone() for k, v in p0.items()}
    # The table's pad columns stay as they were; the view is written back.
    table = ref.table_view(p, tower)
    norm = lambda t: float(torch.linalg.vector_norm(t))
    losses, change = [], {}
    for s in range(first, first + steps):
        r = inputs.rows(s)
        batch = [torch.as_tensor(a[r], device=device)
                 for side in inputs.enc for a in side]
        loss, grads = ref.sgd_step(p, tower, batch, cfg.loss.gamma,
                                   cfg.train.learning_rate, precision,
                                   table=table)
        losses.append(loss)
        if s == first:
            grad = grads
        del grads
        if s + 1 - first == n_change:
            change = {k: norm(p[k] - p0[k]) for k in p0 if k != "W0"}
            change["W0"] = norm(table - p0["W0"][:, :tower["embed_width"]])
    p["W0"][:, :tower["embed_width"]] = table
    return RefSteps(losses, grad, change, p)


def train_checks(losses: List[float], cached: List[float], grad: Dict,
                 change: Dict[str, float], ref: RefSteps,
                 ref_cached: List[float], tower: Dict
                 ) -> Tuple[Dict[str, float], List[str]]:
    """(the compared numbers, notes of each leaf's gaps) of a training
    run's readings against the reference's: `losses` of the first steps,
    `cached` of the second epoch's first steps (`ref_cached` the
    reference's, from the same state at the epoch's end), `grad` the first
    gradient by leaf (the table's padded to the program's layout) and
    `change` the change's norm by leaf."""
    import torch

    from benchmark.reference import check

    h0 = tower["embed_width"]
    norm = lambda t: float(torch.linalg.vector_norm(t))
    g_p = {k: (g[:, :h0] if k == "W0" else g) for k, g in grad.items()}
    grad_p = {k: norm(g) for k, g in g_p.items()}
    grad_r = {k: norm(g) for k, g in ref.grad.items()}
    checks = {
        "loss_gap": check.loss_gap(losses, ref.losses),
        "cached_loss_gap": check.loss_gap(cached, ref_cached),
        "grad_gap": check.norm_gap(grad_p, grad_r),
        "grad_elem_gap": check.elem_gap(g_p, ref.grad, grad_r),
        "update_gap": check.norm_gap(change, ref.change)}
    notes = [f"{what} gap by leaf " + " ".join(
        f"{k} {v:.3g}" for k, v in gaps.items())
        for what, gaps in (
            ("grad", check.leaf_gaps(grad_p, grad_r)),
            ("grad elementwise", check.elem_gaps(g_p, ref.grad, grad_r)),
            ("update", check.leaf_gaps(change, ref.change)))]
    return checks, notes


def free(device) -> None:
    """Collect what the program held and hand its memory back."""
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def live_counts(encs, rows: np.ndarray) -> Tuple[int, int]:
    """(live bag entries, distinct live ids) of the texts `rows` over the
    encodings (one a side)."""
    from benchmark.reference import text

    entries, ids = 0, []
    for idx, wgt in encs:
        w = wgt[rows]
        entries += int((w > 0).sum())
        s, first = text.live_sorted(idx[rows], w)
        ids.append(s[first])
    return entries, int(np.unique(np.concatenate(ids)).size)
