"""The work a step, an eval pass or a served request needs, counted from
the configuration's shapes and the inputs' own sizes, not from what any
implementation computes or moves.

FLOPs are the model's matrix-shaped operations: 2 a multiply-add, the bag
lookup counted as the sparse product it is, the B^2 loss three products
(the logits and the two gradients; a kernel that forms the logits again
does more than the model needs). Every one is held against the chip's
dense bf16 tensor rate, whatever dtype the program uses, so that no
implementation that passes `correct` can read above 100%.

Bytes are what must cross HBM: each input read once and each output
written once, in f32 (4 bytes) for weights, tables and embeddings and
int32 + f32 for a bag's (id, weight) entries; a table is counted by the
rows a batch reads (its distinct live ids), not whole. Activations between
stages are not counted: a fused implementation need not write them.

A work item is (name, flops, bytes); its least time is max(flops / peak
rate, bytes / bandwidth) and a stretch's least time the sum over its items.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

F32 = 4
ENTRY = 8  # an (int32 id, f32 weight) bag entry

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    PEAKS: Dict = json.load(_f)


@dataclass(frozen=True)
class Item:
    name: str
    flops: float
    bytes: float

    def least_s(self) -> float:
        return max(self.flops / PEAKS["matmul_flops_per_s"],
                   self.bytes / PEAKS["hbm_bytes_per_s"])


def tower_dims(tower: dict) -> List[int]:
    return [tower["embed_width"], *tower["hidden_dims"],
            tower["semantic_dim"]]


def _dense_flops(tower: dict, rows: float) -> float:
    d = tower_dims(tower)
    return sum(2.0 * rows * a * b for a, b in zip(d[:-1], d[1:]))


def _dense_param_bytes(tower: dict) -> float:
    d = tower_dims(tower)
    return F32 * sum(a * b + b for a, b in zip(d[:-1], d[1:])) + F32 * d[0]


def lookup(tower: dict, entries: float, rows: float, out_rows: float,
           name: str = "lookup") -> Item:
    """A bag lookup: `entries` live (id, weight) entries of `out_rows` texts
    over `rows` distinct table rows."""
    h = tower["embed_width"]
    return Item(name, 2.0 * entries * h,
                ENTRY * entries + F32 * h * rows + F32 * h * out_rows)


def train_step(tower: dict, batch: int, entries: float, rows: float
               ) -> List[Item]:
    """One SGD step on `batch` pairs (both sides share one table and one
    tower): `entries` live bag entries of both sides, `rows` distinct
    table rows."""
    d = tower["semantic_dim"]
    h = tower["embed_width"]
    params = _dense_param_bytes(tower)
    return [
        lookup(tower, entries, rows, 2 * batch),
        Item("towers", 3 * _dense_flops(tower, 2 * batch),
             2 * params + 2 * F32 * 2 * batch * h),
        Item("loss", 3 * 2.0 * batch * batch * d, 4 * F32 * batch * d),
        Item("lookup_grad", 2.0 * entries * h,
             ENTRY * entries + F32 * h * 2 * batch + F32 * h * rows),
        Item("table_update", 0.0, 2 * F32 * h * rows),
    ]


def eval_pass(tower: dict, n: int, entries: float,
              rows_per_batch: Sequence[float]) -> List[Item]:
    """One pass over n held-out pairs: both sides embedded, then every
    query scored against every title to count its rank."""
    d = tower["semantic_dim"]
    return [
        lookup(tower, entries, sum(rows_per_batch), 2 * n),
        Item("towers", _dense_flops(tower, 2 * n),
             _dense_param_bytes(tower) + F32 * 2 * n * d),
        Item("rank", 2.0 * n * n * d, 2 * F32 * n * d + F32 * n),
    ]


def serve_request(tower: dict, queries: int, entries: float, rows: float,
                  index: int, k: int) -> List[Item]:
    """One request: its queries embedded, scored against an index of
    `index` titles, the top k of each returned."""
    d = tower["semantic_dim"]
    return [
        lookup(tower, entries, rows, queries),
        Item("towers", _dense_flops(tower, queries),
             _dense_param_bytes(tower) + F32 * queries * d),
        Item("score_topk", 2.0 * queries * index * d,
             F32 * index * d + F32 * queries * d + 12 * queries * k),
    ]


def flops(items: Sequence[Item]) -> float:
    return sum(i.flops for i in items)


def least_s(items: Sequence[Item]) -> float:
    return sum(i.least_s() for i in items)
