"""The port's pipelined loader and file corpus against its serial path and
dssm_tpu's, on the CPU, bit for bit: batch_iterator on a pool of 2 or 4
threads (from a data cursor, across epoch boundaries, with the epoch batch
cache on an epoch shorter than the pool's lookahead), eval_batches on a
pool, the ordered pool's eviction of a failed build, LockedIterator and
prefetch under several threads, and load_file_corpus / hash_pairs_chunked /
write_tsv."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import corpus as jcorpus
from dssm_tpu.data import loader as jloader
from dssm_tpu.data import toy as jtoy
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import corpus as tcorpus
from dssm_tpu_torch.data import loader as tloader
from dssm_tpu_torch.data import toy as ttoy

VOCAB = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _configs(arch="mlp"):
    tower = jcfg.TowerConfig(arch=arch, vocab_size=VOCAB, embed_width=40,
                             hidden_dims=(64,), semantic_dim=32)
    data = jcfg.DataConfig(max_trigrams=16, max_trigrams_query=8,
                           max_words=5, max_trigrams_per_word=6)
    return (tower, data, tcfg.TowerConfig(**dataclasses.asdict(tower)),
            tcfg.DataConfig(**dataclasses.asdict(data)))


def _hashed(n, arch="mlp"):
    tower, data, ttower, tdata = _configs(arch)
    pairs = jtoy.make_toy_pairs(n, 96, 2)
    return (jloader.hash_pairs(pairs, tower, data),
            tloader.hash_pairs(ttoy.ToyPairs(pairs.queries, pairs.titles),
                               ttower, tdata))


# (workers, start_batch, epoch cache, joint, corpus pairs): 5 batches of 64
# an epoch at 320 pairs, 2 at 150 (shorter than the pool's lookahead of
# workers + 1, so the cached stream submits a batch index again before its
# first build has finished).
@pytest.mark.parametrize("workers,start,cache,joint,n", [
    (2, 0, False, True, 320), (4, 7, False, False, 320),
    (4, 3, True, True, 320), (4, 0, True, True, 150), (2, 5, True, False, 150),
])
def test_pooled_batch_iterator_identical(workers, start, cache, joint, n):
    jh, th = _hashed(n)
    kw = dict(seed=3, dedup_unique=512, dedup_group=8, dedup_unique_rows=128,
              dedup_joint=joint, wire_compress=True, sort_rows=True,
              start_batch=start, reshuffle_each_epoch=not cache)
    serial = tloader.batch_iterator(th, 64, **kw)
    pooled = tloader.batch_iterator(th, 64, pipeline_workers=workers,
                                    cache_epoch_batches=cache, **kw)
    ref = jloader.batch_iterator(jh, 64, pipeline_workers=workers,
                                 cache_epoch_batches=cache, **kw)
    for _ in range(12):
        a = next(pooled)
        _assert_batches_equal(a, next(serial))
        _assert_batches_equal(a, next(ref))
    pooled.close()


def test_pooled_sequence_batches_identical():
    jh, th = _hashed(200, "lstm")
    kw = dict(seed=2, dedup_unique=512, dedup_unique_rows=128,
              dedup_joint=True, reshuffle_each_epoch=False)
    serial = tloader.batch_iterator(th, 64, True, **kw)
    pooled = tloader.batch_iterator(th, 64, True, pipeline_workers=3,
                                    cache_epoch_batches=True, **kw)
    ref = jloader.batch_iterator(jh, 64, True, **kw)
    for _ in range(7):
        a = next(pooled)
        _assert_batches_equal(a, next(serial))
        _assert_batches_equal(a, next(ref))
    with pytest.raises(ValueError, match="reshuffle"):
        next(tloader.batch_iterator(th, 64, cache_epoch_batches=True))


@pytest.mark.parametrize("workers,arch", [(2, "mlp"), (4, "mlp"),
                                          (4, "cnn")])
def test_pooled_eval_batches_identical(workers, arch):
    jh, th = _hashed(300, arch)
    seq = arch != "mlp"
    kw = dict(dedup_unique=512, dedup_group=8, dedup_unique_rows=128,
              dedup_joint=True, wire_compress=not seq)
    pooled = list(tloader.eval_batches(th, 32, sequence=seq,
                                       pipeline_workers=workers, **kw))
    serial = list(tloader.eval_batches(th, 32, sequence=seq, **kw))
    ref = list(jloader.eval_batches(jh, 32, seq, pipeline_workers=workers,
                                    **kw))
    assert len(pooled) == len(serial) == len(ref) == 10  # tail of 12 rows
    for a, b, c in zip(pooled, serial, ref):
        _assert_batches_equal(a, b)
        _assert_batches_equal(a, c)


def test_failed_build_is_evicted_and_built_again():
    """A build that raised leaves the cache: the next submit of its key
    builds it again, whether the failure was read first or not."""
    calls = []

    def build(job):
        calls.append(job)
        if calls.count(job) == 1 and job == "flaky":
            raise RuntimeError("transient")
        return job.upper()

    cache = {}
    pool = tloader.OrderedPool(build, 2, cache)
    try:
        pool.submit(0, "flaky")
        with pytest.raises(RuntimeError, match="transient"):
            pool.next()
        assert 0 not in cache
        pool.submit(0, "flaky")
        assert pool.next() == "FLAKY" and calls.count("flaky") == 2
        pool.submit(0, "flaky")  # a finished build is shared
        assert pool.next() == "FLAKY" and calls.count("flaky") == 2
        pool.submit(1, "odd")  # a build in flight is shared
        pool.submit(1, "odd")
        assert pool.next() == pool.next() == "ODD" and calls.count("odd") == 1
        # A failure not read yet: the next submit of its key does not share
        # it; each queued job hands back its own build's outcome.
        calls.clear()
        pool.submit(2, "flaky")
        pool._queue[-1][1].exception(timeout=30)  # the build has failed
        pool.submit(2, "flaky")
        with pytest.raises(RuntimeError, match="transient"):
            pool.next()
        assert pool.next() == "FLAKY" and calls.count("flaky") == 2
    finally:
        pool.close()


def test_batch_build_error_reaches_the_consumer(monkeypatch):
    """A batch whose build raises on a pool thread raises from next(), after
    the batches before it, also through prefetch."""
    _, th = _hashed(320)
    real = tloader.select_batch
    # The rows of the third batch: the (seed, epoch 0) permutation's third
    # run of 64.
    bad = np.random.default_rng((1, 0)).permutation(320)[128:192]

    def select_batch(hashed, rows, *args, **kw):
        if np.array_equal(rows, bad):
            raise RuntimeError("bad batch")
        return real(hashed, rows, *args, **kw)

    monkeypatch.setattr(tloader, "select_batch", select_batch)
    for wrap in (lambda it: it, tloader.prefetch):
        it = wrap(tloader.batch_iterator(th, 64, seed=1, pipeline_workers=2,
                                         dedup_unique=512))
        next(it), next(it)
        with pytest.raises(RuntimeError, match="bad batch"):
            next(it)


@pytest.mark.parametrize("threads", [2, 12])
def test_locked_iterator_hands_each_item_once(threads):
    """Threads (12: more than the cores) pull one LockedIterator over a
    generator (and over prefetch) with a short switch interval: every item
    reaches exactly one of them."""
    n = 3000
    for source in (lambda: (i for i in range(n)),
                   lambda: tloader.prefetch((i for i in range(n)), depth=4)):
        shared = tloader.LockedIterator(source())
        got = [[] for _ in range(threads)]

        def pull(out):
            for item in shared:
                out.append(item)

        before = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(target=pull, args=(g,))
                       for g in got]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
                assert not w.is_alive()
        finally:
            sys.setswitchinterval(before)
        assert sorted(i for g in got for i in g) == list(range(n))


def test_load_file_corpus_identical(tmp_path):
    """The split and the hashing of a TSV and a JSONL file, one-shot and in
    chunks, for the bag and the sequence towers; write_tsv's file."""
    pairs = jtoy.make_toy_pairs(250, 96, 6)
    tsv = tmp_path / "pairs.tsv"
    jcorpus.write_tsv(pairs, str(tsv))
    tcorpus.write_tsv(ttoy.ToyPairs(pairs.queries, pairs.titles),
                      str(tmp_path / "t.tsv"))
    assert (tmp_path / "t.tsv").read_bytes() == tsv.read_bytes()
    jsonl = tmp_path / "pairs.jsonl"
    jsonl.write_text("".join(
        f'{{"query": "{q}", "doc": "{t}"}}\n'
        for q, t in zip(pairs.queries, pairs.titles)))
    for arch in ("mlp", "cnn"):
        tower, data, ttower, tdata = _configs(arch)
        for path, max_pairs in ((tsv, 0), (jsonl, 200)):
            data_ = dataclasses.replace(data, max_pairs=max_pairs,
                                        eval_frac=0.2, seed=4)
            tdata_ = dataclasses.replace(tdata, max_pairs=max_pairs,
                                         eval_frac=0.2, seed=4)
            got = tcorpus.load_file_corpus(ttower, tdata_, str(path))
            want = jcorpus.load_file_corpus(tower, data_, str(path))
            for g, w in zip(got[2:], want[2:]):
                assert (g.queries, g.titles) == (w.queries, w.titles)
            for g, w in zip(got[:2], want[:2]):
                _assert_hashed_equal(g, w)
            chunked = tcorpus.hash_pairs_chunked(got[2], ttower, tdata_,
                                                 chunk_size=37)
            _assert_hashed_equal(chunked, got[0])
    with pytest.raises(ValueError, match="data.path"):
        tcorpus.load_file_corpus(ttower, tdata)


def _assert_hashed_equal(a, b):
    for f in tloader.HashedPairs.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
