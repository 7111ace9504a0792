"""dssm_tpu_torch's host data path against dssm_tpu's, bit for bit: configs,
trigram hashing, the toy corpus, corpus files, the two-level dedupe (with
cap overflow), serving batches and the frequency remap."""

import dataclasses

import numpy as np
import pytest

from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import corpus as jcorpus
from dssm_tpu.data import loader as jloader
from dssm_tpu.data import remap as jremap
from dssm_tpu.data import toy as jtoy
from dssm_tpu.data import trigram as jtrigram
from dssm_tpu.kernels import dedup_embed as jdedup
from dssm_tpu.train.eval import _pad_batch as j_pad_batch
from dssm_tpu_torch.cli import args as targs
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import corpus as tcorpus
from dssm_tpu_torch.data import dedupe as tdedup
from dssm_tpu_torch.data import loader as tloader
from dssm_tpu_torch.data import remap as tremap
from dssm_tpu_torch.data import toy as ttoy
from dssm_tpu_torch.data import trigram as ttrigram

VOCAB = 4096


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_fields(cfg):
    """dssm_tpu's config as a dict, less use_pallas: the port has no such
    switch (its kernels always run on CUDA tensors)."""
    d = dataclasses.asdict(cfg)
    del d["train"]["use_pallas"]
    return d


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal(name):
    assert (dataclasses.asdict(tcfg.get_preset(name))
            == _jax_fields(jcfg.get_preset(name)))
    tcfg.validate(tcfg.get_preset(name))


@pytest.mark.parametrize("overrides", [
    {"tower.vocab_size": "4095"},  # not a multiple of the row group
    {"data.max_unique": "100"},  # not a multiple of 8
    {"tower.activation": "gelu", "loss.mode": "x"},
    {"tower.table_dtype": "int8", "mesh.model_parallel": "2"},
])
def test_validate_and_overrides_match(overrides):
    from dssm_tpu.cli.train import coerce_overrides

    jc = coerce_overrides(jcfg.get_preset("full"), overrides)
    tc = targs.coerce_overrides(tcfg.get_preset("full"), overrides)
    assert dataclasses.asdict(tc) == _jax_fields(jc)
    with pytest.raises(ValueError) as je:
        jcfg.validate(jc)
    with pytest.raises(ValueError) as te:
        tcfg.validate(tc)
    assert str(te.value) == str(je.value)


def test_parse_argv_matches():
    from dssm_tpu.cli.train import parse_argv

    argv = ["--preset=full", "--cpu", "--train.batch_size=64",
            "--tower.hidden_dims=64,32"]
    assert targs.parse_argv(argv) == parse_argv(argv)


def test_toy_corpus_identical():
    for seed in (0, 7):
        a = ttoy.make_toy_pairs(300, 96, seed)
        b = jtoy.make_toy_pairs(300, 96, seed)
        assert a.queries == b.queries and a.titles == b.titles
    assert ttoy.make_word_vocab(200, 3) == jtoy.make_word_vocab(200, 3)


@pytest.mark.parametrize("k,normalize", [(16, False), (64, False), (8, True)])
def test_trigram_hashing_identical(k, normalize):
    pairs = jtoy.make_toy_pairs(200, 96, 1)
    texts = pairs.titles + ["", "a", "Hello, World! it's 42", "ünïcode wörds",
                            "x" * 300]
    ti, tw = ttrigram.hash_batch(texts, VOCAB, k, normalize)
    ji, jw = jtrigram.hash_batch(texts, VOCAB, k, normalize)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    assert ti.dtype == ji.dtype and tw.dtype == jw.dtype


def test_corpus_readers_identical(tmp_path):
    tsv = tmp_path / "c.tsv"
    tsv.write_text("q one\tt one\textra\nbad line\nq two\tt two\n\tempty\n")
    jsonl = tmp_path / "c.jsonl"
    jsonl.write_text('{"query": "a b", "title": "c d"}\n\n'
                     '{"query": "e", "doc": "f"}\n{"query": 1, "title": "x"}\n')
    for path in (tsv, jsonl):
        for max_pairs in (0, 1):
            a = tcorpus.read_pairs(str(path), max_pairs)
            b = jcorpus.read_pairs(str(path), max_pairs)
            assert (a.queries, a.titles) == (b.queries, b.titles)
    with pytest.raises(ValueError):
        tcorpus.read_pairs(str(tmp_path / "c.csv"))


def _idx(rng, shape, vocab=VOCAB, nnz_frac=0.8):
    idx = rng.integers(1, vocab, size=shape).astype(np.int32)
    idx[rng.random(shape) > nnz_frac] = 0
    return idx


# (g_cap_rows, u2_cap, group): roomy caps, group overflow, unique-row
# overflow, both, and a bf16-sized group.
_CAPS = [(512, 128, 8), (64, 128, 8), (512, 32, 8), (48, 24, 8), (512, 128, 16)]


@pytest.mark.parametrize("caps", _CAPS)
def test_dedupe_two_level_identical(caps):
    g_cap, u2, group = caps
    rng = np.random.default_rng(11)
    idx = _idx(rng, (64, 16))
    a = tdedup.dedupe_two_level(idx, g_cap, u2, group)
    b = jdedup.dedupe_two_level_numpy(idx, g_cap, u2, group)
    c = jdedup.dedupe_two_level(idx, g_cap, u2, group)  # C++ plane if built
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    for x, y in zip(tdedup.dedupe_indices(idx, g_cap, group),
                    jdedup.dedupe_indices(idx, g_cap, group)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("caps", _CAPS)
def test_dedupe_two_level_joint_identical(caps):
    g_cap, u2, group = caps
    rng = np.random.default_rng(12)
    q, d = _idx(rng, (64, 8)), _idx(rng, (64, 16))
    for x, y in zip(tdedup.dedupe_two_level_joint(q, d, g_cap, u2, group),
                    jdedup.dedupe_two_level_joint(q, d, g_cap, u2, group)):
        np.testing.assert_array_equal(x, y)
    assert tdedup.SKIP_SENTINEL_GID == jdedup.SKIP_SENTINEL_GID


def _tower_data():
    tower = jcfg.TowerConfig(vocab_size=VOCAB, embed_width=40,
                             hidden_dims=(64,), semantic_dim=32)
    data = jcfg.DataConfig(max_trigrams=16, max_trigrams_query=8,
                           max_unique=512, max_unique_rows=128)
    ttower = tcfg.TowerConfig(**dataclasses.asdict(tower))
    tdata = tcfg.DataConfig(**dataclasses.asdict(data))
    return tower, data, ttower, tdata


@pytest.mark.parametrize("joint,caps", [
    (True, (512, 128)), (False, (512, 128)), (True, (128, 48)),
    (False, (64, 32)),
])
def test_eval_batches_identical(joint, caps):
    tower, data, ttower, tdata = _tower_data()
    pairs = jtoy.make_toy_pairs(150, 96, 2)
    jh = jloader.hash_pairs(pairs, tower, data)
    th = tloader.hash_pairs(ttoy.ToyPairs(pairs.queries, pairs.titles),
                            ttower, tdata)
    for f in ("q_idx", "q_wgt", "d_idx", "d_wgt"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f))
    kw = dict(dedup_unique=caps[0], dedup_group=8,
              dedup_unique_rows=caps[1], dedup_joint=joint)
    tb = list(tloader.eval_batches(th, 64, **kw))
    jb = list(jloader.eval_batches(jh, 64, False, **kw))
    assert len(tb) == len(jb) == 3  # ragged tail of 22 rows
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)
        _assert_batches_equal(tloader.pad_batch(a, 64), j_pad_batch(b, 64))


def test_freq_remap_identical(tmp_path):
    tower, data, ttower, tdata = _tower_data()
    pairs = jtoy.make_toy_pairs(120, 64, 4)
    jh = jloader.hash_pairs(pairs, tower, data)
    th = tloader.hash_pairs(ttoy.ToyPairs(pairs.queries, pairs.titles),
                            ttower, tdata)
    for shards in (1, 2):
        a = tremap.build_freq_remap(th, VOCAB, shards)
        b = jremap.build_freq_remap(jh, VOCAB, shards)
        np.testing.assert_array_equal(a, b)
    ta, ja = tremap.apply_remap(th, a), jremap.apply_remap(jh, b)
    for f in ("q_idx", "q_wgt", "d_idx", "d_wgt"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    jremap.save_remap(str(tmp_path), b)
    np.testing.assert_array_equal(tremap.load_remap(str(tmp_path)), b)
    assert tremap.REMAP_FILE == jremap.REMAP_FILE
    assert tremap.load_remap(str(tmp_path / "none")) is None


def test_sequence_towers_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloader.hash_pairs(ttoy.ToyPairs(["a"], ["b"]),
                           tcfg.TowerConfig(arch="cnn"), tcfg.DataConfig())


def _hashed_pair(n=330):
    tower, data, ttower, tdata = _tower_data()
    pairs = jtoy.make_toy_pairs(n, 96, 2)
    jh = jloader.hash_pairs(pairs, tower, data)
    th = tloader.hash_pairs(ttoy.ToyPairs(pairs.queries, pairs.titles),
                            ttower, tdata)
    return jh, th


@pytest.mark.parametrize("joint,sort_rows,wire,start", [
    (True, True, True, 0), (False, True, True, 0), (True, False, False, 0),
    (True, True, True, 7), (False, False, True, 12),
])
def test_batch_iterator_identical(joint, sort_rows, wire, start):
    """The training stream, with row sorting, the compressed wire format and
    a resumed data cursor (start_batch, across an epoch boundary: 5 batches
    an epoch)."""
    jh, th = _hashed_pair()
    kw = dict(seed=5, dedup_unique=512, dedup_group=8, dedup_unique_rows=128,
              dedup_joint=joint, wire_compress=wire, sort_rows=sort_rows,
              start_batch=start)
    ti = tloader.batch_iterator(th, 64, **kw)
    ji = jloader.batch_iterator(jh, 64, **kw)
    for _ in range(7):
        a, b = next(ti), next(ji)
        _assert_batches_equal(a, b)
        assert ("q_idx" in a) == (not wire)
    if start:
        # The resumed stream is the uninterrupted one from batch `start` on.
        whole = tloader.batch_iterator(th, 64, **{**kw, "start_batch": 0})
        for _ in range(start):
            next(whole)
        _assert_batches_equal(
            next(whole), next(tloader.batch_iterator(th, 64, **kw)))


def test_batch_iterator_fixed_epoch_order_and_refusals():
    jh, th = _hashed_pair()
    kw = dict(seed=1, dedup_unique=512, dedup_unique_rows=128,
              dedup_joint=True, reshuffle_each_epoch=False)
    ti = tloader.batch_iterator(th, 64, **kw)
    ji = jloader.batch_iterator(jh, 64, **kw)
    got = [next(ti) for _ in range(10)]
    for a in got:
        _assert_batches_equal(a, next(ji))
    _assert_batches_equal(got[0], got[5])  # epoch 2 replays epoch 1
    for bad in (dict(process_count=2), dict(pipeline_workers=4),
                dict(cache_epoch_batches=True), dict(local_sel_cap=64),
                dict(sequence=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            next(tloader.batch_iterator(th, 64, **bad))
    with pytest.raises(ValueError, match="corpus size"):
        next(tloader.batch_iterator(th, 1024))


def test_wire_plan_compress_sort_and_prefetch_identical():
    jh, th = _hashed_pair(150)
    for args in ((512, 128), (8 * 40000, None)):
        assert (tloader.wire_dtype_plan(th, *args)
                == jloader.wire_dtype_plan(jh, *args))
    rows = np.arange(64)
    tb = tloader.select_batch(th, rows, 512, 8, 128, True)
    jb = jloader.select_batch(jh, rows, False, 512, 8, 128, True)
    _assert_batches_equal(tloader.sort_batch_rows(tb),
                          jloader.sort_batch_rows(jb))
    for plan in (None, {"inv_int16": True, "wgt_uint8": False},
                 {"inv_int16": False, "wgt_uint8": True}):
        _assert_batches_equal(tloader.compress_wire(tb, plan),
                              jloader.compress_wire(jb, plan))
    frac = dict(tb, q_wgt=tb["q_wgt"] * 0.5)  # not integral: stays f32
    assert tloader.compress_wire(frac)["q_wgt"].dtype == np.float32
    items = [{"i": np.asarray(i)} for i in range(5)]
    assert [int(b["i"]) for b in tloader.prefetch(iter(items), depth=2)] \
        == list(range(5))


@pytest.mark.parametrize("n,frac,seed", [(150, 0.1, 0), (40, 0.25, 3),
                                         (5, 0.1, 1)])
def test_train_eval_split_identical(n, frac, seed):
    pairs = jtoy.make_toy_pairs(n, 64, seed)
    jt, je = jtoy.train_eval_split(pairs, frac, seed)
    tt, te = ttoy.train_eval_split(
        ttoy.ToyPairs(pairs.queries, pairs.titles), frac, seed)
    assert (tt.queries, tt.titles) == (jt.queries, jt.titles)
    assert (te.queries, te.titles) == (je.queries, je.titles)
    assert len(te) == max(1, int(n * frac))
