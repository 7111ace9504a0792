"""The benchmark's traffic generator: seeds, the click-log corpus and the
serving requests, all made from the run's --seed.

The corpus is a click log of text over the full alphabet: a vocabulary of
distinct words (letters drawn by their English frequencies; a share of
words alphanumeric over letters and digits alike, as model numbers and
years are in queries), used with a Zipfian law, the frequent words the
short ones. A query and its clicked title share topical words (a topic
draws 4-8 words; the query takes 2-4 of them, its title 3-6 plus 0-2
noise words), so the towers have something to learn. The configuration's
file sets the vocabulary's size (data.toy_vocab_words) and its `corpus`
block the law's exponent, the alphanumeric share and the words' median
length. At 500,000 words a 59,000-pair log holds about 27,000 distinct
letter trigrams, and a batch of 1024 pairs about 6,700 (PERF.md).

It is the benchmark's own: the program only ever receives the texts.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

# English letter frequencies, in %.
LETTERS = "etaoinshrdlcumwfgypbvkjxqz"
LETTER_PCT = [12.7, 9.06, 8.17, 7.51, 6.97, 6.75, 6.33, 6.09, 5.99, 4.25,
              4.03, 2.78, 2.76, 2.41, 2.36, 2.23, 2.02, 1.97, 1.93, 1.29,
              0.98, 0.77, 0.15, 0.15, 0.10, 0.07]
ALNUM = "abcdefghijklmnopqrstuvwxyz0123456789"
TEXT = {"zipf": 1.0, "alnum_share": 0.05, "median_word_len": 6.5}
MAX_WORD = 16  # letters a word holds at most
TOPIC_MAX = 8  # words a topic holds at most


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed (any
    non-negative whole number, 2**31 and above too)."""
    return np.random.default_rng(np.random.SeedSequence(int(seed),
                                                        spawn_key=stream))


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for a torch.Generator, from one stream of the seed."""
    hi, lo = np.random.SeedSequence(int(seed), spawn_key=stream
                                    ).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def word_vocab(num_words: int, seed: int, text: Optional[Dict] = None
               ) -> List[str]:
    """num_words distinct words, ordered from the most used: lengths drawn
    around the median, the shorter the earlier (with jitter)."""
    t = {**TEXT, **(text or {})}
    return list(_vocab(num_words, seed, t["alnum_share"],
                       t["median_word_len"]))


@functools.lru_cache(maxsize=2)
def _vocab(num_words: int, seed: int, alnum_share: float,
           median_len: float) -> Tuple[str, ...]:
    t = {"alnum_share": alnum_share, "median_word_len": median_len}
    r = rng(seed, 0)
    cum = np.cumsum(LETTER_PCT) / sum(LETTER_PCT)
    letters = np.frombuffer(LETTERS.encode(), np.uint8)
    alnum = np.frombuffer(ALNUM.encode(), np.uint8)
    words: List[str] = []
    seen = set()
    while len(words) < num_words:
        m = 2 * (num_words - len(words)) + 64
        lens = np.clip(np.round(r.lognormal(np.log(t["median_word_len"]),
                                            0.35, size=m)), 2, MAX_WORD)
        mixed = r.random(m) < t["alnum_share"]
        ch = np.where(
            mixed[:, None], alnum[r.integers(0, len(alnum),
                                             size=(m, MAX_WORD))],
            letters[np.minimum(np.searchsorted(cum, r.random((m, MAX_WORD))),
                               len(letters) - 1)])
        ch[np.arange(MAX_WORD)[None, :] >= lens[:, None]] = 0
        for w in ch.view(f"S{MAX_WORD}").ravel():
            w = w.decode()
            if w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == num_words:
                    break
    key = (np.fromiter(map(len, words), float, count=num_words)
           + r.normal(0.0, 2.0, size=num_words))
    return tuple(words[i] for i in np.argsort(key, kind="stable"))


def toy_pairs(num_pairs: int, vocab_words: int, seed: int, stream: int,
              text: Optional[Dict] = None) -> Tuple[List[str], List[str]]:
    """(queries, titles): each pair draws a topic of 4-8 words by the
    Zipfian law; the query takes 2-4 of them, its title 3-6 (at most the
    topic) plus 0-2 noise words drawn by the same law."""
    t = {**TEXT, **(text or {})}
    words = _vocab(vocab_words, seed, t["alnum_share"], t["median_word_len"])
    r = rng(seed, 1, stream)
    n = num_pairs
    law = np.cumsum(1.0 / np.arange(1, vocab_words + 1) ** t["zipf"])
    law /= law[-1]

    def draw(shape) -> np.ndarray:
        return np.minimum(np.searchsorted(law, r.random(shape)),
                          vocab_words - 1)

    topic = draw((n, TOPIC_MAX))
    size = r.integers(4, TOPIC_MAX + 1, size=n)
    nq = r.integers(2, 5, size=n)
    nt = r.integers(3, np.minimum(7, size + 1))
    n_noise = r.integers(0, 3, size=n)
    noise = draw((n, 2))
    live = np.arange(TOPIC_MAX)[None, :] < size[:, None]

    def shuffled() -> np.ndarray:
        """The topic's live words in a fresh random order a pair."""
        keys = np.where(live, r.random((n, TOPIC_MAX)), 2.0)
        return np.take_along_axis(topic, np.argsort(keys, axis=1), axis=1)

    q_rows = shuffled()[:, :4].tolist()
    t_rows = np.concatenate([shuffled()[:, :6], noise], axis=1).tolist()
    queries = [" ".join([words[j] for j in row[:k]])
               for row, k in zip(q_rows, nq.tolist())]
    titles = [" ".join([words[j] for j in row[:k]]
                       + [words[j] for j in row[6:6 + m]])
              for row, k, m in zip(t_rows, nt.tolist(), n_noise.tolist())]
    return queries, titles
