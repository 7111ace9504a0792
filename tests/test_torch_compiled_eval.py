"""Eval's and serving's dispatch (train/eval.py, serve/retrieval.py,
train/compiled.py::CompiledForward) against dssm_tpu on the CPU, where the
compiled forward runs its bodies eagerly (its graphs run only on the card:
tests/test_torch_cuda.py -k "compiled_eval or compiled_serve").

- _k_block equals dssm_tpu's.
- The stacked wire blocks (_host_blocks) equal dssm_tpu's _host_blocks
  field by field after widening, bit for bit, at N = 1, N = B * K and
  N = B * K + 1 (a ragged tail batch and a tail block padded with its last
  batch).
- embed_corpus and evaluate against dssm_tpu's for mlp on f32, bf16 and
  int8 tables, cnn, lstm and raw-index batches, over two blocks of three
  batches (the tail block padded; _k_block shrunk in both packages alike).
- top_k against dssm_tpu's _topk_all / _topk_all_approx (through its
  top_k) with three full chunks and a ragged tail, and with no queries.
- The forward's graph cache: keyed on every parameter's address, shape,
  dtype and stride, on the same of an input on the call's device (read in
  place) and on another input's shape and dtype (copied into a static
  buffer that the graphs of that key share), bounded at 32 graphs, least
  recently used first out; a CPU evaluate captures nothing and keeps its
  embeddings buffer for the next pass of its shape.

Tolerances, f32 compute: embeddings 1e-5 (test_torch_eval.py's: the sums
run in another order); ranks and so the metrics equal, but where a doc
scores within 2e-5 of the true doc (a duplicate title: the lstm case
moves 4 of 300 ranks by 1), as test_torch_models.py allows; the port's
later passes (cached, eager) equal its first exactly; the wire blocks bit
for bit;
top-k scores 1e-6 (a product of unit vectors, 32 terms, in another
order), ids equal (random embeddings: no exact ties).
"""

import jax
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.models import base as jbase
from dssm_tpu.serve import retrieval as jserve
from dssm_tpu.train import eval as jeval
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.loader import hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.models import base as tmodels
from dssm_tpu_torch.serve import retrieval as tserve
from dssm_tpu_torch.train import compiled
from dssm_tpu_torch.train import eval as teval

V, BATCH = 4096, 64
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch="mlp", table_dtype="", dedup=True, batch=BATCH):
    kw = dict(
        tower=dict(arch=arch, vocab_size=V, embed_width=40,
                   hidden_dims=(48,), conv_window=3, conv_channels=40,
                   lstm_hidden=32, semantic_dim=32, table_dtype=table_dtype),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_words=4,
                  max_trigrams_per_word=4, max_unique=1024,
                  max_unique_rows=256, dedup_lookup=dedup),
        train=dict(batch_size=batch),
    )

    def build(m, **extra):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"], **extra)))

    return build(jcfg, use_pallas=False), build(tcfg)


def _corpus(tc, n, seed=11):
    return hash_pairs(make_toy_pairs(n, vocab_words=96, seed=seed), tc.tower,
                      tc.data)


def test_k_block_matches_dssm_tpu():
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 511, 512, 513, 6553, 65536, 10**6):
        for b in (1, 8, 64, 256, 1024):
            assert teval._k_block(n, b) == jeval._k_block(n, b), (n, b)


@pytest.mark.parametrize("arch,dedup,n", [
    ("mlp", True, 1), ("mlp", True, 512), ("mlp", True, 513),
    ("cnn", True, 513), ("mlp", False, 513)])
def test_host_blocks_match_dssm_tpu(arch, dedup, n):
    """B = 8: at N = 512 one block of K = 64 full batches; at 513 a second
    block of one 1-row batch padded to 8 rows, repeated 64 times."""
    b = 8
    jc, tc = _cfgs(arch, dedup=dedup, batch=b)
    corpus = _corpus(tc, n)
    k = teval._k_block(n, b)
    got = list(teval._host_blocks(tc, corpus, b, 8, k, CPU, V))
    want = list(jeval._host_blocks(jc, corpus, b, 8, k))
    assert len(got) == len(want) == -(-n // (b * k))
    assert sum(r for _, r in got) == n
    for (wire, rows), (jblock, jrows) in zip(got, want):
        assert rows == jrows
        fields = wire.fields()
        assert set(fields) == set(jblock)
        for key, _, shape, dtype in wire.layout:
            a = jblock[key]
            assert shape == a.shape and dtype == torch.from_numpy(a).dtype, key
            want_t = bridge.widen({key: torch.from_numpy(np.array(a))})[key]
            assert fields[key].dtype == want_t.dtype, key
            assert torch.equal(fields[key], want_t), key
    if n == 513:
        tail = got[-1][0].fields()
        # the tail block is its one batch, repeated
        assert all(torch.equal(v[0], v[-1]) for v in tail.values())


EVAL_CASES = {"f32": ("mlp", "", True), "bf16": ("mlp", "bfloat16", True),
              "int8": ("mlp", "int8", True), "cnn": ("cnn", "", True),
              "lstm": ("lstm", "", True), "raw": ("mlp", "", False)}


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_embed_corpus_and_evaluate_match_dssm_tpu(name, monkeypatch):
    """300 pairs, batch 64: five batches, three a block in both packages,
    so the second block holds two and repeats its last."""
    arch, table_dtype, dedup = EVAL_CASES[name]
    jc, tc = _cfgs(arch, table_dtype, dedup)
    corpus = _corpus(tc, 300)
    jparams = jbase.init_params(jc.tower, seed=0)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tc.tower, "cpu")
    for mod in (jeval, teval):
        monkeypatch.setattr(mod, "_k_block", lambda n, b: 3)
    jeval._EVAL_CACHES.clear()
    teval._EVAL_CACHES.clear()
    jq, jd = jeval.embed_corpus(jparams, jc, corpus, BATCH, "xla")
    q, d = teval.embed_corpus(tparams, tc, corpus, BATCH)
    assert q.shape == d.shape == (300, 32)
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-5)
    # Embeddings 1e-5 apart can swap a doc that scores within 2e-5 of the
    # true doc (a duplicate title ties it; test_torch_models.py's rule): a
    # rank may move by the number of such docs, and each metric by that
    # query's share of the mean. Where no rank moves, the metrics are equal.
    ranks = teval.compute_ranks(q, d)
    jranks = np.asarray(jeval.compute_ranks(jq, jd))
    scores = np.asarray(jq) @ np.asarray(jd).T
    gap = np.abs(scores - np.diag(scores)[:, None])
    np.fill_diagonal(gap, 1.0)
    assert (np.abs(ranks - jranks) <= (gap < 2e-5).sum(axis=1)).all()
    moved = int((ranks != jranks).sum())
    want = jeval.evaluate(jparams, jc, corpus, BATCH, "xla", cache=False)
    got = teval.evaluate(tparams, tc, corpus, BATCH, cache=True)
    assert set(got) == set(want)
    for k in got:
        assert abs(got[k] - want[k]) <= moved / 300, (k, got, want)
    assert moved > 0 or got == want
    want = got
    cache = teval._EVAL_CACHES[-1][2]
    assert cache.complete and len(cache.blocks) == 2
    assert [r for _, r in cache.blocks] == [192, 108]
    stats = {}
    assert teval.evaluate(tparams, tc, corpus, BATCH, cache=True,
                          stats=stats) == want
    assert stats["cache_hit"] == 1.0
    assert teval.evaluate(tparams, tc, corpus, BATCH, cache=False,
                          eager=True) == want
    # on the CPU every body ran eagerly: no graph was captured
    for fwd in (teval.EMBED, teval.EMBED_STACKED, teval.RANK, tserve.TOPK):
        assert fwd.num_graphs == 0 and fwd.pool_bytes == 0
    teval._EVAL_CACHES.clear()


@pytest.mark.parametrize("exact", [True, False])
def test_top_k_matches_dssm_tpu(exact):
    """Q = 3 chunks of 16 and a tail of 5 against 80 docs, unit vectors as
    the towers make them: approx_max_k's
    80 bins cover the docs, so both routes are exact here, as dssm_tpu's
    lax.approx_max_k is off a TPU."""
    rng = np.random.default_rng(5)
    q, d = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (
        rng.standard_normal((n, 32)).astype(np.float32) for n in (53, 80)))
    assert tserve.approx_bins(80, 10) == 80
    js, ji = jserve.top_k(q, d, k=10, chunk=16, exact=exact)
    ts, ti = tserve.top_k(q, d, k=10, chunk=16, exact=exact, device="cpu")
    assert ts.shape == ti.shape == (53, 10) and ti.dtype == np.int64
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    # tensors as inputs, and no queries
    ts2, ti2 = tserve.top_k(torch.from_numpy(q), torch.from_numpy(d), k=10,
                            chunk=16, exact=exact, device="cpu")
    assert np.array_equal(ts2, ts) and np.array_equal(ti2, ti)
    es, ei = tserve.top_k(q[:0], d, k=10, exact=exact, device="cpu")
    jes, jei = jserve.top_k(q[:0], d, k=10, exact=exact)
    assert es.shape == ei.shape == jes.shape == (0, 10)
    assert es.dtype == np.float32 and ei.dtype == jei.dtype == np.int64
    assert tserve.TOPK.num_graphs == 0


def test_forward_cache_keyed_on_layout_and_bounded(monkeypatch):
    t = torch.zeros(8)
    key = compiled.forward_key
    card = torch.device("cuda", 0)  # a key is made without the card
    base = key({"w": t.view(2, 4)}, (torch.zeros(3),), {"k": 1}, card)
    assert base == key({"w": t.view(2, 4)}, (torch.ones(3),), {"k": 1},
                       card)
    for other in (
        key({"w": t.view(4, 2)}, (torch.zeros(3),), {"k": 1}, card),  # shape
        key({"w": t.view(4, 2).t()}, (torch.zeros(3),), {"k": 1},
            card),                                                 # stride
        key({"w": t.view(torch.int32).view(2, 4)}, (torch.zeros(3),),
            {"k": 1}, card),                                       # dtype
        key({"w": t.clone().view(2, 4)}, (torch.zeros(3),), {"k": 1}, card),
        key({"w": t.view(2, 4)}, (torch.zeros(4),), {"k": 1}, card),  # input
        key({"w": t.view(2, 4)}, (torch.zeros(3, dtype=torch.int32),),
            {"k": 1}, card),
        key({"w": t.view(2, 4)}, (torch.zeros(3),), {"k": 2}, card),  # static
    ):
        assert other != base
    # an input on the call's device is read in place: keyed on its address
    x = torch.zeros(3)
    here = key({}, (x,), {}, CPU)
    assert here.inputs == (("in_place", x.data_ptr(), (3,), torch.float32,
                            (1,)),)
    assert here == key({}, (x.view(3),), {}, CPU)
    assert here != key({}, (x.clone(),), {}, CPU)
    wire = bridge.batch_to_device({"x": np.zeros((2, 3), np.int16)}, CPU)
    assert key({}, (wire,), {}, card).inputs == (("wire", wire.layout),)

    assert compiled.GRAPH_CACHE_SIZE == 32
    monkeypatch.setattr(compiled, "GRAPH_CACHE_SIZE", 3)
    cf = compiled.CompiledForward(lambda p, x: x)
    for i in range(4):
        cf._store(("key", i), compiled._Forward(None, (), None, {}))
    assert cf.num_graphs == 3 and list(cf._graphs) == [("key", i)
                                                       for i in (1, 2, 3)]
    assert cf._lookup(("key", 1)) is not None  # now the most recent
    cf._store(("key", 4), compiled._Forward(None, (), None, {}))
    assert list(cf._graphs) == [("key", i) for i in (3, 1, 4)]
    assert cf._lookup(("key", 2)) is None and cf.pool_bytes == 0
    cf.clear()
    assert cf.num_graphs == 0
    # eagerly, multi: K bodies on the views [j], the outputs stacked
    stacked = compiled.CompiledForward(lambda p, x, *, s: (x * s, x + p["b"]),
                                       multi=True)
    x = torch.arange(6.0).view(3, 2)
    a, b = stacked({"b": torch.ones(())}, x, s=2.0)
    assert torch.equal(a, x * 2) and torch.equal(b, x + 1)
    assert stacked.num_graphs == 0


def test_forward_static_buffers_shared_while_a_graph_holds_them():
    """A copied input's static buffer: one a position and input key, shared
    by the graphs that read it and freed with the last of them; none for
    an input read in place."""
    cf = compiled.CompiledForward(lambda p, q, d: q @ d.T)
    q, d = torch.zeros(5, 4), torch.zeros(7, 4)
    card = torch.device("cuda", 0)
    keys = [compiled.forward_key({}, (q, d), {}, card),
            compiled.forward_key({}, (q[:2], d), {}, card)]
    held = [tuple(cf._buffer(i, k, x, CPU) for i, (k, x) in
                  enumerate(zip(key.inputs, xs)))
            for key, xs in zip(keys, ((q, d), (q[:2], d)))]
    (q0, d0), (q1, d1) = held
    assert d0 is d1 and q0 is not q1  # the index shared across Q
    assert q0.shape == (5, 4) and q1.shape == (2, 4)
    assert cf.buffer_bytes == (5 + 7 + 2) * 4 * 4
    # the same shape at another position gets a buffer of its own
    square = compiled.forward_key({}, (d, d), {}, card).inputs
    assert cf._buffer(0, square[0], d, CPU) is not cf._buffer(
        1, square[1], d, CPU)
    assert cf._buffer(0, ("in_place",) + compiled._tensor_key(q), q,
                      CPU) is None
    del held, q0, d0
    assert cf.buffer_bytes == (7 + 2) * 4 * 4  # q0 freed; d1 still held
    del q1, d1
    assert cf.buffer_bytes == 0


def test_evaluate_keeps_its_embeddings_buffer():
    """evaluate writes the embeddings into a [2, N, D] buffer that the next
    pass of that shape reuses (on the card the rank graph is keyed on its
    address), one for each of the last four shapes; embed_corpus on its
    own returns new tensors."""
    _, cfg = _cfgs()
    dim = cfg.tower.semantic_dim
    params = tmodels.init_params(cfg.tower, seed=0, device=CPU)
    teval._EVAL_EMB.clear()
    hashed = _corpus(cfg, 150)
    m = teval.evaluate(params, cfg, hashed, BATCH, cache=False)
    buf = teval._EVAL_EMB[(150, dim, "cpu")]
    assert buf.shape == (2, 150, dim)
    assert teval.evaluate(params, cfg, hashed, BATCH, cache=False) == m
    assert list(teval._EVAL_EMB.values()) == [buf]
    q, d = teval.embed_corpus(params, cfg, hashed, BATCH, cache=False)
    assert torch.equal(q, buf[0]) and torch.equal(d, buf[1])
    assert q.data_ptr() != buf.data_ptr()
    for n in (40, 41, 42, 43):
        teval.evaluate(params, cfg, _corpus(cfg, n), BATCH, cache=False)
    assert [k[0] for k in teval._EVAL_EMB] == [40, 41, 42, 43]
    assert all(b.shape == (2, k[0], dim) for k, b in teval._EVAL_EMB.items())
    teval._EVAL_EMB.clear()
