"""File-backed query-title corpora: TSV / JSONL readers and chunked hashing.

  - ``.tsv`` / ``.txt``: one pair per line, ``query<TAB>title``. Extra
    columns (click counts etc.) are ignored; malformed lines are skipped.
  - ``.jsonl``: one JSON object per line with ``"query"`` and ``"title"``
    (or ``"doc"``) string fields.

``load_file_corpus`` is what cli/train.py and cli/eval.py call when
``--data.path=...`` is set: read, a seeded train / eval split, then hashing
in chunks through the C++ host data plane (data/native.py). A copy of
dssm_tpu/data/corpus.py, bit-identical to it (tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from dssm_tpu_torch.config import DataConfig, TowerConfig
from dssm_tpu_torch.data.loader import HashedPairs, hash_pairs
from dssm_tpu_torch.data.toy import ToyPairs, train_eval_split

# The pair container is format-agnostic; ToyPairs is just (queries, titles).
Pairs = ToyPairs


def iter_pairs(path: str) -> Iterator[Tuple[str, str]]:
    """Stream (query, title) pairs from a TSV or JSONL file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".jsonl":
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                q = obj.get("query")
                t = obj.get("title", obj.get("doc"))
                if isinstance(q, str) and isinstance(t, str):
                    yield q, t
    elif ext in (".tsv", ".txt", ""):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and parts[0] and parts[1]:
                    yield parts[0], parts[1]
    else:
        raise ValueError(
            f"unsupported corpus format {ext!r} for {path!r} "
            "(use .tsv/.txt or .jsonl)"
        )


def read_pairs(path: str, max_pairs: int = 0) -> Pairs:
    """Materialize a corpus file as a Pairs container.

    max_pairs > 0 truncates (useful for smoke runs on huge files).
    """
    queries, titles = [], []
    for q, t in iter_pairs(path):
        queries.append(q)
        titles.append(t)
        if max_pairs and len(queries) >= max_pairs:
            break
    if not queries:
        raise ValueError(f"no (query, title) pairs found in {path!r}")
    return Pairs(queries=queries, titles=titles)


def hash_pairs_chunked(
    pairs: Pairs,
    tower: TowerConfig,
    data: DataConfig,
    chunk_size: int = 16384,
) -> HashedPairs:
    """hash_pairs in chunks of chunk_size pairs (the hashing's text buffers
    stay a chunk's size), bit-identical to hashing the corpus at once."""
    n = len(pairs)
    if n <= chunk_size:
        return hash_pairs(pairs, tower, data)
    chunks = [hash_pairs(Pairs(queries=pairs.queries[lo:lo + chunk_size],
                               titles=pairs.titles[lo:lo + chunk_size]),
                         tower, data)
              for lo in range(0, n, chunk_size)]
    first = chunks[0]
    return HashedPairs(**{
        name: (np.concatenate([getattr(c, name) for c in chunks])
               if getattr(first, name) is not None else None)
        for name in first.__dataclass_fields__})


def load_file_corpus(
    tower: TowerConfig,
    data: DataConfig,
    path: Optional[str] = None,
) -> Tuple[HashedPairs, HashedPairs, Pairs, Pairs]:
    """Read, split and hash a corpus file (path, or data.path): returns
    (hashed_train, hashed_eval, train_pairs, eval_pairs). The split is the
    toy corpus's seeded permutation (data.eval_frac, data.seed), so the
    train and eval CLIs see the same held-out pairs."""
    path = path or data.path
    if not path:
        raise ValueError("data.path is empty; nothing to load")
    pairs = read_pairs(path, data.max_pairs)
    train_pairs, eval_pairs = train_eval_split(
        pairs, eval_frac=data.eval_frac, seed=data.seed)
    return (hash_pairs_chunked(train_pairs, tower, data),
            hash_pairs_chunked(eval_pairs, tower, data),
            train_pairs, eval_pairs)


def write_tsv(pairs: Pairs, path: str) -> None:
    """The inverse of read_pairs for a .tsv file."""
    with open(path, "w", encoding="utf-8") as f:
        for q, t in zip(pairs.queries, pairs.titles):
            f.write(f"{q}\t{t}\n")
