"""The cnn (CLSM) and lstm towers of dssm_tpu_torch against dssm_tpu on the
CPU: the same seed gives bit-identical parameters; the same weights
(bridge.params_from_jax) and batches give the same embeddings, eval metrics
and served index; the sequence batches keep their layout through eval and
cli.train; and the train / eval / export CLIs run both presets.

Sizes: vocab 4096, T = 4 words x Kw = 4 trigrams, conv 3 x 40 (120 columns
padded to 128), LSTM E 40 / H 32, semantic 32, batch 32.

Tolerances: f32 compute against dssm_tpu's XLA path 1e-5 (sums in another
order); bf16 compute against dssm_tpu's Pallas kernels in interpret mode
2e-2, as tests/test_torch_serve.py (a bf16 rounding falls to the
neighbouring value where the f32 sums differ in their last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu import serve as jserve
from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import loader as jloader
from dssm_tpu.data import toy as jtoy
from dssm_tpu.kernels.pallas_gather import force_interpret
from dssm_tpu.models import base as jbase
from dssm_tpu.train import eval as jeval
from dssm_tpu_torch import bridge
from dssm_tpu_torch import data as tdata
from dssm_tpu_torch import serve as tserve
from dssm_tpu_torch.cli import eval as cli_eval
from dssm_tpu_torch.cli import export as cli_export
from dssm_tpu_torch.cli import train as cli_train
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import loader as tloader
from dssm_tpu_torch.data.toy import ToyPairs
from dssm_tpu_torch.io.checkpoint import Checkpointer
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import eval as teval

import reference_native

# dssm_tpu's C++ extension linked whole before any worker loads it.
reference_native.build()

BATCH = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, compute_dtype="float32", shared=True, dedup=True,
          table_dtype=""):
    kw = dict(
        tower=dict(arch=arch, vocab_size=4096, embed_width=40,
                   conv_window=3, conv_channels=40, lstm_hidden=32,
                   semantic_dim=32, compute_dtype=compute_dtype,
                   shared_weights=shared, table_dtype=table_dtype),
        data=dict(max_trigrams=16, max_words=4, max_trigrams_per_word=4,
                  max_unique=1024, max_unique_rows=256, dedup_lookup=dedup),
        train=dict(batch_size=BATCH),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


def _params(jc, tc, seed=0):
    jp = jbase.init_params(jc.tower, seed=seed)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc.tower,
                                      "cpu")


@pytest.fixture(scope="module")
def pairs():
    return jtoy.make_toy_pairs(150, 64, 5)


def _hashed(pairs, tc):
    return tloader.hash_pairs(ToyPairs(pairs.queries, pairs.titles),
                              tc.tower, tc.data)


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("arch,shared,table_dtype", [
    ("cnn", True, ""), ("cnn", False, ""), ("cnn", True, "bfloat16"),
    ("cnn", True, "int8"), ("lstm", True, ""), ("lstm", False, ""),
    ("lstm", True, "bfloat16"), ("lstm", True, "int8")])
def test_init_params_bit_identical(arch, shared, table_dtype):
    jc, tc = _cfgs(arch, shared=shared, table_dtype=table_dtype)
    jp = jax.tree.map(np.asarray, jbase.init_params(jc.tower, seed=7))
    tp = tbase.init_params(tc.tower, seed=7, device="cpu")
    assert set(tp) == set(jp)
    for tower, want in jp.items():
        assert set(tp[tower]) == set(want)
        for k, w in want.items():
            got = tp[tower][k]
            assert tuple(got.shape) == w.shape, k
            if got.dtype == torch.bfloat16:
                np.testing.assert_array_equal(got.float().numpy(),
                                              w.astype(np.float32), k)
            else:
                np.testing.assert_array_equal(got.numpy(), w, k)
    key = tbase.TABLE_KEY[arch]
    assert tp[next(iter(tp))][key].shape[1] == 128  # lane-padded


@pytest.mark.parametrize("arch", ["cnn", "lstm"])
def test_bridge_checks_keys_and_shapes(arch):
    jc, tc = _cfgs(arch)
    jp = jax.tree.map(np.asarray, jbase.init_params(jc.tower, seed=1))
    tp = bridge.params_from_jax(jp, tc.tower, "cpu")
    for k, v in jp["shared"].items():
        np.testing.assert_array_equal(tp["shared"][k].numpy(), v)
    key = tbase.TABLE_KEY[arch]
    missing = {"shared": {k: v for k, v in jp["shared"].items() if k != "Ws"}}
    with pytest.raises(KeyError, match="expected"):
        bridge.params_from_jax(missing, tc.tower, "cpu")
    narrow = {"shared": dict(jp["shared"], **{key: jp["shared"][key][:, :64]})}
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(narrow, tc.tower, "cpu")
    # An int8 table travels with its per-row scale.
    j8, t8 = _cfgs(arch, table_dtype="int8")
    jp8 = jax.tree.map(np.asarray, jbase.init_params(j8.tower, seed=1))
    tp8 = bridge.params_from_jax(jp8, t8.tower, "cpu")
    assert tp8["shared"][key].dtype == torch.int8
    assert tuple(tp8["shared"][f"{key}_scale"].shape) == (4096, 1)


def _batches(pairs, jc, tc, dedup):
    th = _hashed(pairs, tc)
    kw = dict(dedup_unique=1024 if dedup else None, dedup_unique_rows=256,
              dedup_joint=True)
    rows = np.arange(BATCH)
    tb = tloader.select_batch(th, rows, **kw, sequence=True)
    jb = jloader.select_batch(th, rows, True, **kw)
    return tb, {k: jnp.asarray(v) for k, v in jb.items()}


@pytest.mark.parametrize("arch", ["cnn", "lstm"])
@pytest.mark.parametrize("dtype,dedup", [("float32", True),
                                         ("float32", False),
                                         ("bfloat16", True),
                                         ("bfloat16", False)])
def test_tower_forward_matches_dssm_tpu(pairs, arch, dtype, dedup):
    jc, tc = _cfgs(arch, dtype, dedup=dedup)
    jp, tp = _params(jc, tc)
    tb, jb = _batches(pairs, jc, tc, dedup)
    assert ("uniq" in tb) == dedup and tb["q_idx"].shape == (BATCH, 4, 4)
    tbt = bridge.batch_to_torch(tb, "cpu")
    assert tbt["q_mask"].dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    for side in "qd":
        if dtype == "float32":
            want = jbase.embed(jp, jc.tower, side, jb, impl="xla")
        else:
            with force_interpret():
                want = jbase.embed(jp, jc.tower, side, jb, impl="pallas")
        got = tbase.embed(tp, tc.tower, side, tbt)
        assert got.dtype == torch.float32 and got.shape == (BATCH, 32)
        np.testing.assert_allclose(got.numpy(), _np32(want), rtol=0,
                                   atol=tol, err_msg=side)
        # The module and the functional halves agree.
        lookup = tbase.embed_table_lookup(tp, tc.tower, side, tbt)
        np.testing.assert_array_equal(
            tbase.embed_from_lookup(tp, tc.tower, side, tbt, lookup).numpy(),
            got.numpy())


@pytest.mark.parametrize("arch", ["cnn", "lstm"])
def test_padding_invariance(pairs, arch):
    """Extra padding words (mask 0, weight 0) leave the embedding as it
    was; a text with no words at all stays finite."""
    jc, tc = _cfgs(arch)
    _, tp = _params(jc, tc)
    tb, _ = _batches(pairs, jc, tc, dedup=False)
    y1 = tbase.embed(tp, tc.tower, "q", bridge.batch_to_torch(tb, "cpu"))
    padded = dict(tb)
    for key in ("q_idx", "q_wgt"):
        arr = tb[key]
        padded[key] = np.concatenate(
            [arr, np.zeros((BATCH, 3, arr.shape[2]), arr.dtype)], axis=1)
    padded["q_mask"] = np.concatenate(
        [tb["q_mask"], np.zeros((BATCH, 3), np.float32)], axis=1)
    y2 = tbase.embed(tp, tc.tower, "q", bridge.batch_to_torch(padded, "cpu"))
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=1e-5, atol=1e-6)
    empty = {k: np.zeros_like(v) for k, v in tb.items()}
    y0 = tbase.embed(tp, tc.tower, "q", bridge.batch_to_torch(empty, "cpu"))
    assert bool(torch.isfinite(y0).all())


@pytest.mark.parametrize("arch,dedup", [("cnn", True), ("cnn", False),
                                        ("lstm", True), ("lstm", False)])
def test_evaluate_matches_dssm_tpu(pairs, arch, dedup):
    jc, tc = _cfgs(arch, dedup=dedup)
    jp, tp = _params(jc, tc)
    corpus = _hashed(pairs, tc)
    jeval._EVAL_CACHES.clear()
    want = jeval.evaluate(jp, jc, corpus, BATCH, "xla", cache=False)
    got = teval.evaluate(tp, tc, corpus, BATCH, cache=False)
    assert set(got) == set(want) and got["num_queries"] == 150.0
    q, d = teval.embed_corpus(tp, tc, corpus, BATCH)
    jq, jd = jeval.embed_corpus(jp, jc, corpus, BATCH, "xla")
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-5)
    # Embeddings 1e-5 apart can swap a doc that scores within 2e-5 of the
    # true doc (a duplicate title ties it): a rank may move by the number of
    # such docs, and each metric by that query's share of the mean.
    ranks = teval.compute_ranks(q, d)
    jranks = np.asarray(jeval.compute_ranks(jq, jd))
    scores = np.asarray(jq) @ np.asarray(jd).T
    gap = np.abs(scores - np.diag(scores)[:, None])
    np.fill_diagonal(gap, 1.0)
    ties = (gap < 2e-5).sum(axis=1)
    assert (np.abs(ranks - jranks) <= ties).all()
    moved = int((ranks != jranks).sum())
    for k in ("recall@1", "recall@10", "ndcg@10", "mrr"):
        assert abs(got[k] - want[k]) <= 1e-6 + moved / 150, (k, got, want)
    # A second pass from the cache of prepared batches.
    assert teval.evaluate(tp, tc, corpus, BATCH, cache=True) == \
        teval.evaluate(tp, tc, corpus, BATCH, cache=True)


def test_eval_keeps_sequence_batches_whole(pairs):
    """Sequence batches cross to the device uncompressed (their idx fields
    and int32 slots), as in dssm_tpu; an mlp batch is compressed. The cache
    key tells the two apart."""
    _, tc = _cfgs("cnn")
    corpus = _hashed(pairs, tc)
    wire, _ = next(teval._host_blocks(tc, corpus, BATCH, 8, 1,
                                      torch.device("cpu")))
    tb = {k: v[0] for k, v in wire.fields().items()}
    assert "q_idx" in tb and tb["q_idx"].shape == (BATCH, 4, 4)
    assert "q_mask" in tb and "uniq" in tb
    jb = next(jloader.eval_batches(
        corpus, BATCH, True, dedup_unique=1024, dedup_group=8,
        dedup_unique_rows=256, dedup_joint=True, wire_compress=False))
    for k, v in jb.items():
        np.testing.assert_array_equal(tb[k].numpy(), v.astype(
            tb[k].numpy().dtype), k)
    mlp = tc.replace(tower=tc.tower.replace(arch="mlp"))
    mwire, _ = next(teval._host_blocks(mlp, corpus, BATCH, 8, 1,
                                       torch.device("cpu")))
    mb = mwire.fields()
    assert "q_idx" not in mb
    assert teval._cache_key(tc, corpus, BATCH, 8, "cpu") != \
        teval._cache_key(mlp, corpus, BATCH, 8, "cpu")


@pytest.mark.parametrize("arch,dtype,dedup", [
    ("cnn", "float32", True), ("cnn", "float32", False),
    ("lstm", "float32", True), ("lstm", "bfloat16", True),
    ("lstm", "float32", False)])
def test_serving_embeddings_match_dssm_tpu(pairs, arch, dtype, dedup):
    """The doc index and the query embeddings read the model's own table
    (Wc / Win), dedupe or raw batches."""
    jc, tc = _cfgs(arch, dtype, dedup=dedup)
    jp, tp = _params(jc, tc)
    titles = list(dict.fromkeys(pairs.titles))[:70]
    tol = 1e-5 if dtype == "float32" else 2e-2
    with force_interpret():
        impl = "xla" if dtype == "float32" else "pallas"
        jd = jserve.build_doc_index(jp, jc, titles, BATCH, impl=impl)
        jq = jserve.embed_queries(jp, jc, pairs.queries[:40], BATCH,
                                  impl=impl)
    td = tserve.build_doc_index(tp, tc, titles, BATCH, device="cpu")
    tq = tserve.embed_queries(tp, tc, pairs.queries[:40], BATCH,
                              device="cpu")
    assert td.shape == (70, 32) and tq.shape == (40, 32)
    np.testing.assert_allclose(td, jd, rtol=0, atol=tol)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=tol)
    s, i = tserve.top_k(tq, td, k=5, device="cpu")
    assert np.all(np.diff(s, axis=1) <= 0)


SMALL = ["--tower.vocab_size=4096", "--tower.embed_width=40",
         "--tower.conv_channels=40", "--tower.lstm_hidden=32",
         "--tower.semantic_dim=32", "--data.max_words=4",
         "--data.max_trigrams_per_word=4", "--data.max_unique=1024",
         "--data.max_unique_rows=256", f"--train.batch_size={BATCH}",
         "--data.toy_num_pairs=120", "--data.toy_vocab_words=64"]


@pytest.mark.parametrize("preset,dedup", [("cnn", True), ("lstm", False),
                                          ("mlp", True)])
def test_train_eval_export_clis(tmp_path, monkeypatch, capsys, preset,
                                dedup):
    """cli.train builds sequence batches whole and in corpus row order (no
    wire compression, no row sort), an mlp stream compressed and sorted;
    cli.eval reports the run's final metrics from its checkpoint and
    cli.export serves it."""
    seen = []
    real = tdata.batch_iterator

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(tdata, "batch_iterator", spy)
    name = "tiny" if preset == "mlp" else preset
    flags = [f"--preset={name}", "--cpu", *SMALL, f"--io.workdir={tmp_path}",
             f"--data.dedup_lookup={dedup}"]
    cli_train.main([*flags, "--train.max_steps=2", "--train.log_every=1"])
    (args, kw), = seen
    seq = preset != "mlp"
    assert args[2] is seq
    assert kw["wire_compress"] is (dedup and not seq)
    assert kw["sort_rows"] is (dedup and not seq)
    assert (kw["dedup_unique"] is not None) == dedup
    err = capsys.readouterr().err
    assert "step 1: loss=" in err and "final eval: recall@1=" in err
    state = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert state.step == 2
    assert tbase.TABLE_KEY[preset] in state.params["shared"]
    cli_eval.main(flags)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"step": 2' in out[0]
    index = str(tmp_path / "index.npz")
    cli_export.main([*flags, f"--out={index}"])
    cli_export.main([*flags, f"--index={index}", "--query=kiba lomu",
                     "--k=3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"indexed_docs"' in lines[0] and '"results"' in lines[-1]
