"""Letter-trigram word hashing.

Each word is bracketed with '#' and decomposed into letter trigrams
('good' -> '#go','goo','ood','od#'); a text becomes a bag-of-trigrams count
vector, emitted in the fixed-length form the lookups take:

  indices[K] int32, weights[K] float32

and, for the sequence towers (cnn, lstm), per word: indices[T, Kw],
weights[T, Kw] and a word mask[T]. Index 0 is RESERVED for padding (weight 0); real trigrams hash into
[1, vocab_size). The batch functions run the C++ host data plane
(data/native.py) unless impl="plain", which takes the pure-Python path
below: a copy of dssm_tpu/data/trigram.py's, bit-identical to it
(tests/test_torch_data.py) and to the C++ path (tests/test_torch_native.py).
The text is lowercased by str.lower() on both paths, so a letter whose
lowercase is ASCII (the Kelvin sign, U+0130) hashes as that letter on both.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from dssm_tpu_torch.data import native

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


def hash_text_sequence(
    text: str,
    vocab_size: int,
    max_words: int,
    max_trigrams_per_word: int,
    normalize: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-word trigram encoding for the CNN / LSTM towers:
    (indices[T, Kw], weights[T, Kw], mask[T]) with T = max_words."""
    words = tokenize(text)[:max_words]
    t, kw = max_words, max_trigrams_per_word
    idx = np.full((t, kw), PAD_INDEX, dtype=np.int32)
    wgt = np.zeros((t, kw), dtype=np.float32)
    mask = np.zeros((t,), dtype=np.float32)
    for wi, word in enumerate(words):
        counts: Dict[int, float] = {}
        for tri in word_trigrams(word):
            i = trigram_id(tri, vocab_size)
            counts[i] = counts.get(i, 0.0) + 1.0
        idx[wi], wgt[wi] = _counts_to_fixed(counts, kw, normalize)
        mask[wi] = 1.0
    return idx, wgt, mask


def hash_batch(
    texts: Sequence[str], vocab_size: int, max_trigrams: int,
    normalize: bool = False, impl: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Over a batch of texts -> (indices[B, K], weights[B, K])."""
    if native.resolve(impl, "hash_batch") == "native":
        return native.hash_batch(texts, vocab_size, max_trigrams, normalize)
    n = len(texts)
    idx = np.full((n, max_trigrams), PAD_INDEX, dtype=np.int32)
    wgt = np.zeros((n, max_trigrams), dtype=np.float32)
    for b, text in enumerate(texts):
        idx[b], wgt[b] = hash_text(text, vocab_size, max_trigrams, normalize)
    return idx, wgt


def hash_batch_sequence(
    texts: Sequence[str],
    vocab_size: int,
    max_words: int,
    max_trigrams_per_word: int,
    normalize: bool = False,
    impl: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Over a batch of texts -> (indices[B, T, Kw], weights[B, T, Kw],
    mask[B, T])."""
    if native.resolve(impl, "hash_batch_sequence") == "native":
        return native.hash_batch_sequence(texts, vocab_size, max_words,
                                          max_trigrams_per_word, normalize)
    n = len(texts)
    idx = np.full((n, max_words, max_trigrams_per_word), PAD_INDEX,
                  dtype=np.int32)
    wgt = np.zeros((n, max_words, max_trigrams_per_word), dtype=np.float32)
    mask = np.zeros((n, max_words), dtype=np.float32)
    for b, text in enumerate(texts):
        idx[b], wgt[b], mask[b] = hash_text_sequence(
            text, vocab_size, max_words, max_trigrams_per_word, normalize)
    return idx, wgt, mask


def dense_from_fixed(
    indices: np.ndarray, weights: np.ndarray, vocab_size: int
) -> np.ndarray:
    """The dense [B, V] bag vector of fixed-length rows (tests and
    diagnostics)."""
    b = indices.shape[0]
    dense = np.zeros((b, vocab_size), dtype=np.float32)
    flat_rows = np.repeat(np.arange(b), indices.shape[1])
    np.add.at(dense, (flat_rows, indices.reshape(-1)), weights.reshape(-1))
    dense[:, PAD_INDEX] = 0.0
    return dense


def collision_stats(texts: Iterable[str], vocab_size: int) -> Dict[str, float]:
    """The trigram hash's collisions over a corpus: distinct trigrams, used
    buckets, buckets holding more than one trigram and their share, and
    trigram occurrences (tools/vocab_stats.py)."""
    seen: Dict[int, set] = {}
    total = 0
    for text in texts:
        for word in tokenize(text):
            for tri in word_trigrams(word):
                total += 1
                seen.setdefault(trigram_id(tri, vocab_size), set()).add(tri)
    collided = sum(1 for tris in seen.values() if len(tris) > 1)
    return {
        "distinct_trigrams": float(sum(len(v) for v in seen.values())),
        "used_buckets": float(len(seen)),
        "collided_buckets": float(collided),
        "collision_rate": collided / max(len(seen), 1),
        "total_occurrences": float(total),
    }
