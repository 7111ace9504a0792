"""Letter-trigram word hashing and the frequency-ordered vocab remap, a
frozen plain copy of the model's input encoding (DSSM, Huang et al. 2013:
each word bracketed with '#' and cut into letter trigrams; FNV-1a 64 hashes
a trigram into rows [1, V) of the table, row 0 is padding).

A text's bag keeps its K most frequent trigram ids (ties to the lower id).
The encoding here lists each trigram occurrence in a slot of its own with
weight 1, which sums to the same bag as one slot a distinct id weighted by
its count; a text with more than K occurrences falls back to the distinct
ids and their counts, cut to the K most frequent.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

WORD_RE = re.compile(r"[a-z0-9']+")
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a(s: str) -> int:
    h = _FNV_OFFSET
    for byte in s.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


def word_ids(word: str, vocab: int) -> List[int]:
    """The table rows of a word's trigrams, in order ('#go', 'goo', ...)."""
    w = f"#{word}#"
    tris = [w] if len(w) < 3 else [w[i:i + 3] for i in range(len(w) - 2)]
    return [1 + fnv1a(t) % (vocab - 1) for t in tris]


_PLAIN = re.compile(r"[a-z0-9' \n]*")


def word_rows(words: Sequence[str], vocab: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(table [n, longest] int64 of each word's trigram rows in order, 0
    past its end; [n] trigram counts). ASCII words are hashed together,
    FNV-1a's 64-bit products wrapping in numpy's uint64; the rest one by
    one (word_ids)."""
    n = len(words)
    wlen = np.fromiter(map(len, words), dtype=np.int64, count=n)
    if n == 0 or not all(map(str.isascii, words)):
        rows_of = [word_ids(w, vocab) for w in words]
        wlen = np.asarray([len(r) for r in rows_of], dtype=np.int64)
        table = np.zeros((n, int(wlen.max(initial=1))), dtype=np.int64)
        for i, r in enumerate(rows_of):
            table[i, :len(r)] = r
        return table, wlen
    width = int(wlen.max()) + 2
    padded = np.array([f"#{w}#" for w in words], dtype=f"S{width}")
    b = padded.view(np.uint8).reshape(n, width).astype(np.uint64)
    tris = width - 2
    h = np.full((n, tris), _FNV_OFFSET, dtype=np.uint64)
    prime = np.uint64(_FNV_PRIME)
    for j in range(3):
        h = (h ^ b[:, j:j + tris]) * prime
    table = (h % np.uint64(vocab - 1)).astype(np.int64) + 1
    table[np.arange(tris)[None, :] >= wlen[:, None]] = 0
    return table, wlen


def _bag(occ: List[int], k: int, normalize: bool
         ) -> Tuple[List[int], List[float]]:
    """The K most frequent distinct ids of a text's occurrences (ties to
    the lower id) and their counts, l2-normalised with `normalize`."""
    counts: Dict[int, float] = {}
    for j in occ:
        counts[j] = counts.get(j, 0.0) + 1.0
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    wts = [c for _, c in top]
    if normalize and top:
        norm = float(np.linalg.norm(np.asarray(wts, np.float32)))
        wts = [c / norm for c in wts]
    return [j for j, _ in top], wts


def _tokens(texts: Sequence[str]) -> Tuple[List[str], np.ndarray]:
    """(every text's tokens in order, tokens per text). Texts of token
    characters and spaces alone are split in bulk; the rest one by one."""
    big = "\n".join(texts).lower()
    if (_PLAIN.fullmatch(big) and big.isascii()
            and big.count("\n") == len(texts) - 1):
        b = np.frombuffer(big.encode("ascii"), dtype=np.uint8)
        tok = (b != ord(" ")) & (b != ord("\n"))
        starts = tok.copy()
        starts[1:] &= ~tok[:-1]
        text_of = np.cumsum(b == ord("\n"))
        return big.split(), np.bincount(text_of[starts],
                                        minlength=len(texts))
    per = [WORD_RE.findall(t.lower()) for t in texts]
    return ([w for ws in per for w in ws],
            np.asarray([len(ws) for ws in per], dtype=np.int64))


def encode(texts: Sequence[str], vocab: int, k: int,
           normalize: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [N, k] int64, weights [N, k] f32) of each text's bag; padding
    slots hold id 0 with weight 0."""
    n = len(texts)
    tokens, per_text = _tokens(texts)
    words = list(dict.fromkeys(tokens))
    vocab_of = {w: i for i, w in enumerate(words)}
    tok_word = np.fromiter(map(vocab_of.__getitem__, tokens), dtype=np.int64,
                           count=len(tokens))
    table, wlen = word_rows(words, vocab)
    # Every trigram occurrence, text by text.
    lens = wlen[tok_word]
    occ_word = np.repeat(tok_word, lens)
    occ_pos = np.arange(occ_word.size) - np.repeat(np.cumsum(lens) - lens,
                                                   lens)
    occ = table[occ_word, occ_pos]
    tok_text = np.repeat(np.arange(n), per_text)
    occ_text = np.repeat(tok_text, lens)
    occ_len = np.bincount(occ_text, minlength=n)
    occ_col = np.arange(occ.size) - np.repeat(np.cumsum(occ_len) - occ_len,
                                              occ_len)
    idx = np.zeros((n, k), dtype=np.int64)
    wgt = np.zeros((n, k), dtype=np.float32)
    simple = (occ_len <= k) & (not normalize)
    fit = simple[occ_text]
    flat = occ_text[fit] * k + occ_col[fit]
    idx.reshape(-1)[flat] = occ[fit]
    wgt.reshape(-1)[flat] = 1.0
    starts = np.cumsum(occ_len) - occ_len
    for i in np.nonzero(~simple)[0]:
        ids, wts = _bag(occ[starts[i]:starts[i] + occ_len[i]].tolist(), k,
                        normalize)
        idx[i, :len(ids)] = ids
        wgt[i, :len(ids)] = np.asarray(wts, dtype=np.float32)
    return idx, wgt


def live_sorted(idx: np.ndarray, wgt: np.ndarray) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """(ids sorted within each row with dead slots as 0, mask of each row's
    first slot of every distinct live id)."""
    s = np.sort(np.where(wgt > 0, idx, 0), axis=1)
    first = np.ones(s.shape, dtype=bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return s, first & (s != 0)


def doc_freq(encodings: Sequence[Tuple[np.ndarray, np.ndarray]],
             vocab: int) -> np.ndarray:
    """[vocab] int64: in how many texts (of every encoding given) each id
    occurs."""
    counts = np.zeros(vocab, dtype=np.int64)
    for idx, wgt in encodings:
        s, first = live_sorted(idx, wgt)
        counts += np.bincount(s[first], minlength=vocab)
    return counts


def freq_remap(counts: np.ndarray, num_shards: int = 1) -> np.ndarray:
    """[vocab] int64, old id -> new id: ids ranked by count (descending,
    ties to the lower id) take the new ids in order, id 0 stays 0; with S
    shards rank r goes to shard r % S at slot r // S."""
    v = counts.shape[0]
    c = counts.copy()
    c[0] = 0
    order = np.argsort(-c, kind="stable")
    order = order[order != 0]
    ranks = np.arange(v, dtype=np.int64)
    if num_shards > 1:
        if v % num_shards:
            raise ValueError(f"vocab {v} not divisible by {num_shards}")
        dests = (ranks % num_shards) * (v // num_shards) + ranks // num_shards
    else:
        dests = ranks
    dests = dests[dests != 0]
    remap = np.zeros(v, dtype=np.int64)
    remap[order] = dests[:order.shape[0]]
    return remap
