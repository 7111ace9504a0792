"""Toy query-title clickthrough dataset generator.

A structured stand-in for click logs: a query and its clicked title share
topical words (so a model must learn lexical-semantic overlap through the
trigram bottleneck), while random titles don't. Deterministic given the
seed; a copy of dssm_tpu/data/toy.py, pair for pair the same corpus.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# Small pronounceable syllable inventory -> synthetic "words" with realistic
# letter-trigram overlap structure.
_SYLLABLES = [
    "ba", "be", "bi", "bo", "bu", "da", "de", "di", "do", "du",
    "ka", "ke", "ki", "ko", "ku", "la", "le", "li", "lo", "lu",
    "ma", "me", "mi", "mo", "mu", "na", "ne", "ni", "no", "nu",
    "ra", "re", "ri", "ro", "ru", "sa", "se", "si", "so", "su",
    "ta", "te", "ti", "to", "tu", "va", "ve", "vi", "vo", "vu",
]


def make_word_vocab(num_words: int, seed: int) -> List[str]:
    rng = np.random.default_rng(seed)
    vocab = set()
    words: List[str] = []
    while len(words) < num_words:
        n_syll = int(rng.integers(2, 5))
        w = "".join(rng.choice(_SYLLABLES) for _ in range(n_syll))
        if w not in vocab:
            vocab.add(w)
            words.append(w)
    return words


@dataclass
class ToyPairs:
    queries: List[str]
    titles: List[str]  # titles[i] is the clicked title for queries[i]

    def __len__(self) -> int:
        return len(self.queries)


def make_toy_pairs(
    num_pairs: int, vocab_words: int = 512, seed: int = 0
) -> ToyPairs:
    """Each pair draws a topic = a small set of words; the query uses 2-4 of
    them, the clicked title uses an overlapping 3-6 of them plus noise words.
    """
    rng = np.random.default_rng(seed + 1)
    words = make_word_vocab(vocab_words, seed)
    nw = len(words)
    queries, titles = [], []
    for _ in range(num_pairs):
        topic_size = int(rng.integers(4, 9))
        topic = rng.choice(nw, size=topic_size, replace=False)
        nq = int(rng.integers(2, 5))
        q_words = [words[i] for i in rng.choice(topic, size=nq, replace=False)]
        nt = int(rng.integers(3, min(7, topic_size + 1)))
        t_words = [words[i] for i in rng.choice(topic, size=nt, replace=False)]
        n_noise = int(rng.integers(0, 3))
        t_words += [words[int(rng.integers(nw))] for _ in range(n_noise)]
        queries.append(" ".join(q_words))
        titles.append(" ".join(t_words))
    return ToyPairs(queries=queries, titles=titles)


def train_eval_split(pairs: ToyPairs, eval_frac: float = 0.1,
                     seed: int = 0) -> Tuple[ToyPairs, ToyPairs]:
    rng = np.random.default_rng(seed + 2)
    n = len(pairs)
    perm = rng.permutation(n)
    n_eval = max(1, int(n * eval_frac))
    ev, tr = perm[:n_eval], perm[n_eval:]

    def pick(idx):
        return ToyPairs(queries=[pairs.queries[i] for i in idx],
                        titles=[pairs.titles[i] for i in idx])

    return pick(tr), pick(ev)
