"""The numbers that decide `correct`: each a gap between what the program
produced and what the plain reference computes from the same inputs.

Training: the loss of each checked step (relative gap), in the first
epoch and in the second, which the loader's epoch cache serves; the norm
of the first gradient and of the change after the checked steps, leaf by
leaf, taken by the worst leaf: |norm_program - norm_reference| over the
larger of that leaf's reference norm and the median leaf's; and the first
gradient element by element, by the worst leaf: ||g_program -
g_reference|| over the same. A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left
out. Eval: the widest distance between the program's and
the reference's embedding of a text, and the widest gap in reference score
at the program's rank. Serving: the widest gap between a returned score
and the reference's score of that doc, and the widest deficit of a
returned doc's reference score below the reference's own top k.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

DEAD_LEAF = 1e-3  # of the median leaf's reference norm


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float]
              ) -> Dict[str, float]:
    """Each counted leaf's |norm_p - norm_r| / max(norm_r, median norm_r)."""
    med = float(np.median(list(reference.values())))
    return {k: abs(program[k] - r) / max(r, med)
            for k, r in reference.items() if r >= DEAD_LEAF * med}


def norm_gap(program: Dict[str, float], reference: Dict[str, float]
             ) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(program, reference).values())


def elem_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor], ref_norms: Dict[str, float]
              ) -> Dict[str, float]:
    """Each counted leaf's ||g_p - g_r|| / max(norm_r, median norm_r): the
    same first gradient, element by element, which a lower precision of
    the products moves where the norms alone hardly differ."""
    med = float(np.median(list(ref_norms.values())))
    return {k: float(torch.linalg.vector_norm(
        program[k].float() - reference[k].to(program[k].device)))
        / max(r, med)
        for k, r in ref_norms.items() if r >= DEAD_LEAF * med}


def elem_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor], ref_norms: Dict[str, float]
             ) -> float:
    """The worst leaf's elementwise gap (elem_gaps)."""
    return max(elem_gaps(program, reference, ref_norms).values())


def emb_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest l2 distance between two embeddings of one text."""
    return float(torch.linalg.vector_norm(program.float() - reference,
                                          dim=1).max())


@torch.no_grad()
def rank_gap(q: torch.Tensor, d: torch.Tensor, ranks: np.ndarray,
             block: int = 2048) -> float:
    """The widest reference-score distance at the program's ranks. rank_i
    = 1 + the docs scoring above query i's own doc (d[i]); for each query
    the reference's scores less its own doc's, sorted, give the smallest
    threshold move that makes the reference count rank_i - 1 docs above.
    A rank outside [1, N] reads infinite."""
    n = q.shape[0]
    r = torch.as_tensor(np.asarray(ranks), dtype=torch.int64,
                        device=q.device)
    if r.shape[0] != n or int(r.min()) < 1 or int(r.max()) > d.shape[0]:
        return float("inf")
    worst = 0.0
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s = q[lo:hi] @ d.T
        rows = torch.arange(hi - lo, device=q.device)
        s -= s[rows, rows + lo].clone()[:, None]
        s[rows, rows + lo] = float("-inf")  # the own doc is not counted
        desc = torch.sort(s, dim=1, descending=True).values
        c = r[lo:hi] - 1  # docs the program counted above
        above = (s > 0).sum(dim=1)
        past = desc.gather(1, (c - 1).clamp_min(0)[:, None])[:, 0]
        short = desc.gather(1, c.clamp_max(d.shape[0] - 1)[:, None])[:, 0]
        gap = torch.where(c > above, -past,
                          torch.where(c < above, short,
                                      torch.zeros_like(past)))
        worst = max(worst, float(gap.max()))
    return worst


@torch.no_grad()
def topk_gaps(q: torch.Tensor, index: torch.Tensor, scores: np.ndarray,
              ids: np.ndarray, block: int = 512) -> Dict[str, float]:
    """score_gap: the widest |returned score - the reference's score of the
    returned doc|; topk_gap: the widest deficit of the j-th returned doc's
    reference score below the reference's j-th best. An id out of range
    or returned twice for one query reads infinite."""
    n, k = ids.shape
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=q.device)
    if (int(ids_t.min()) < 0 or int(ids_t.max()) >= index.shape[0]
            or bool((torch.sort(ids_t, 1).values.diff(dim=1) == 0).any())):
        return {"score_gap": float("inf"), "topk_gap": float("inf")}
    sc = torch.as_tensor(scores, dtype=torch.float32, device=q.device)
    score_gap = topk_gap = 0.0
    for lo in range(0, n, block):
        s = q[lo:lo + block] @ index.T
        best = torch.topk(s, k, dim=1).values
        got = s.gather(1, ids_t[lo:lo + block])
        score_gap = max(score_gap, float((got - sc[lo:lo + block]).abs()
                                         .max()))
        topk_gap = max(topk_gap, float((best - got).max()))
    return {"score_gap": score_gap, "topk_gap": topk_gap}
