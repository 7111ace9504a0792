"""Letter-trigram word hashing (pure Python).

Each word is bracketed with '#' and decomposed into letter trigrams
('good' -> '#go','goo','ood','od#'); a text becomes a bag-of-trigrams count
vector, emitted in the fixed-length form the lookups take:

  indices[K] int32, weights[K] float32

Index 0 is RESERVED for padding (weight 0); real trigrams hash into
[1, vocab_size). A copy of the pure-Python path of dssm_tpu/data/trigram.py,
bit-identical to it (tests/test_torch_data.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD_INDEX = 0

_WORD_RE = re.compile(r"[a-z0-9']+")

# FNV-1a 64-bit constants — deterministic across processes/hosts (unlike
# Python's salted hash()).
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a(s: str) -> int:
    h = _FNV_OFFSET
    for byte in s.encode("utf-8"):
        h ^= byte
        h = (h * _FNV_PRIME) & _MASK64
    return h


def tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def word_trigrams(word: str) -> List[str]:
    """'good' -> ['#go', 'goo', 'ood', 'od#']."""
    w = f"#{word}#"
    n = len(w)
    if n < 3:
        return [w]
    return [w[i : i + 3] for i in range(n - 2)]


def trigram_id(tri: str, vocab_size: int) -> int:
    """Deterministic hash of a trigram into [1, vocab_size). 0 = padding."""
    return 1 + _fnv1a(tri) % (vocab_size - 1)


def text_trigram_counts(text: str, vocab_size: int) -> Dict[int, float]:
    counts: Dict[int, float] = {}
    for word in tokenize(text):
        for tri in word_trigrams(word):
            idx = trigram_id(tri, vocab_size)
            counts[idx] = counts.get(idx, 0.0) + 1.0
    return counts


def _counts_to_fixed(
    counts: Dict[int, float], k: int, normalize: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k (by count, then index for determinism) -> fixed (indices, weights)."""
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    idx = np.full((k,), PAD_INDEX, dtype=np.int32)
    wgt = np.zeros((k,), dtype=np.float32)
    for j, (i, c) in enumerate(items):
        idx[j] = i
        wgt[j] = c
    if normalize:
        norm = np.linalg.norm(wgt)
        if norm > 0:
            wgt /= norm
    return idx, wgt


def hash_text(
    text: str, vocab_size: int, max_trigrams: int, normalize: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Bag-of-trigrams fixed-length encoding for MLP-DSSM towers."""
    return _counts_to_fixed(
        text_trigram_counts(text, vocab_size), max_trigrams, normalize
    )


def hash_batch(
    texts: Sequence[str], vocab_size: int, max_trigrams: int, normalize: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Over a batch of texts -> (indices[B, K], weights[B, K])."""
    n = len(texts)
    idx = np.full((n, max_trigrams), PAD_INDEX, dtype=np.int32)
    wgt = np.zeros((n, max_trigrams), dtype=np.float32)
    for b, text in enumerate(texts):
        idx[b], wgt[b] = hash_text(text, vocab_size, max_trigrams, normalize)
    return idx, wgt
