"""File-backed query-title corpora (TSV / JSONL readers).

  - ``.tsv`` / ``.txt``: one pair per line, ``query<TAB>title``. Extra
    columns (click counts etc.) are ignored; malformed lines are skipped.
  - ``.jsonl``: one JSON object per line with ``"query"`` and ``"title"``
    (or ``"doc"``) string fields.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Tuple

from dssm_tpu_torch.data.toy import ToyPairs

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
