"""The eval slice of dssm_tpu_torch against dssm_tpu on the CPU: the rank
count, evaluate with its cache, and the eval hooks of the command lines.

Tolerances. Ranks are integers: the plain rank count equals dssm_tpu's
Pallas kernel (interpret mode) and its XLA scan exactly on embeddings whose
scores are well apart, and an exact tie does not count in either. evaluate:
recall@1, recall@10, ndcg@10 and mrr within 1e-6 of dssm_tpu's from the same
weights, under f32 compute (the embeddings agree to 1e-5, far below the
score gaps of this corpus).
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import corpus as jcorpus
from dssm_tpu.data import toy as jtoy
from dssm_tpu.kernels.pallas_gather import force_interpret
from dssm_tpu.kernels.pallas_rank import rank_counts_pallas
from dssm_tpu.models import base as jbase
from dssm_tpu.train import eval as jeval
from dssm_tpu_torch import bridge
from dssm_tpu_torch.cli import eval as cli_eval
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.loader import HashedPairs, eval_batches, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.io.checkpoint import Checkpointer
from dssm_tpu_torch.kernels.rank import (
    rank_counts, rank_counts_plain, true_scores)
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import eval as teval

V, BATCH = 4096, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit(rng, n, dim, near=None, noise=0.4):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if near is not None:
        x = near + noise * x
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n", [96, 600])
def test_rank_counts_plain_matches_pallas_and_xla_scan(n):
    rng = np.random.default_rng(3)
    q = _unit(rng, n, 128)
    d = _unit(rng, n, 128, near=q)
    want = np.asarray(jeval._rank_all(jnp.asarray(q), jnp.asarray(d),
                                      min(1024, n), min(4096, n)))
    with force_interpret():
        pallas = np.asarray(rank_counts_pallas(jnp.asarray(q), jnp.asarray(d)))
    got = rank_counts(torch.from_numpy(q), torch.from_numpy(d))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # chunk sizes that do not divide n or nd give the same ranks
    np.testing.assert_array_equal(
        rank_counts_plain(torch.from_numpy(q), torch.from_numpy(d), 50,
                          77).numpy(), want)
    assert want.min() == 1 and want.max() > 1


def test_rank_counts_more_docs_than_queries_and_ties():
    rng = np.random.default_rng(4)
    n, nd, dim = 70, 203, 36
    q = _unit(rng, n, dim)
    d = _unit(rng, nd, dim)
    d[:n] = _unit(rng, n, dim, near=q, noise=0.2)
    want = np.asarray(jeval._rank_all(jnp.asarray(q), jnp.asarray(d), n, nd))
    got = rank_counts(torch.from_numpy(q), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    scores = q @ d.T
    true = scores[np.arange(n), np.arange(n)]
    masked = scores.copy()
    masked[np.arange(n), np.arange(n)] = -np.inf
    np.testing.assert_array_equal(got, 1 + (masked > true[:, None]).sum(1))
    # An exact tie (strict >): doc 150 is a copy of query 9's true doc, in
    # one-hot embeddings whose products are exact.
    q1 = np.eye(8, 16, dtype=np.float32)
    d1 = np.concatenate([np.eye(8, 16, dtype=np.float32),
                         np.eye(8, 16, dtype=np.float32)[[3]],
                         np.eye(8, 16, k=8, dtype=np.float32)])
    ranks = rank_counts(torch.from_numpy(q1), torch.from_numpy(d1)).numpy()
    assert ranks.tolist() == [1] * 8
    jr = np.asarray(jeval._rank_all(jnp.asarray(q1), jnp.asarray(d1), 8, 17))
    np.testing.assert_array_equal(ranks, jr)
    d1[9] = 2 * d1[3]  # now it scores strictly above query 3's true doc
    assert rank_counts(torch.from_numpy(q1),
                       torch.from_numpy(d1)).numpy().tolist() == [
        1, 1, 1, 2, 1, 1, 1, 1]
    np.testing.assert_allclose(
        true_scores(torch.from_numpy(q), torch.from_numpy(d)).numpy(), true,
        rtol=0, atol=1e-6)


def test_rank_counts_refusals():
    q, d = torch.zeros((4, 8)), torch.zeros((3, 8))
    with pytest.raises(ValueError, match="true doc"):
        rank_counts(q, d)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        rank_counts(q, torch.zeros((4, 12)))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        rank_counts(q, q, impl="kernel")
    # int32 ranks: at most 2**31 - 1 docs (a broadcast view, no memory).
    with pytest.raises(ValueError, match="int32 ranks"):
        rank_counts(q, torch.zeros((1, 8)).expand(2**31, 8))
    assert rank_counts(q[:0], d).shape == (0,)


def test_metrics_from_ranks_match_dssm_tpu():
    ranks = np.asarray([1, 1, 2, 5, 10, 11, 40, 1, 3, 7], np.int32)
    assert teval.metrics_from_ranks(ranks) == jeval.metrics_from_ranks(ranks)


# ---- evaluate ----------------------------------------------------------------

def _cfgs(table_dtype=""):
    kw = dict(
        tower=dict(vocab_size=V, embed_width=40, hidden_dims=(48,),
                   semantic_dim=32, table_dtype=table_dtype),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_unique=1024,
                  max_unique_rows=256),
        train=dict(batch_size=BATCH),
    )

    def build(m, **extra):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"], **extra)))

    return build(jcfg, use_pallas=False), build(tcfg)


@pytest.fixture(scope="module")
def corpus():
    _, tc = _cfgs()
    pairs = make_toy_pairs(300, vocab_words=96, seed=11)
    return hash_pairs(pairs, tc.tower, tc.data)


@pytest.mark.parametrize("table_dtype", ["", "bfloat16", "int8"])
def test_evaluate_matches_dssm_tpu(corpus, table_dtype):
    jc, tc = _cfgs(table_dtype)
    jparams = jbase.init_params(jc.tower, seed=0)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     tc.tower, "cpu")
    jeval._EVAL_CACHES.clear()
    want = jeval.evaluate(jparams, jc, corpus, BATCH, "xla", cache=False)
    stats = {}
    got = teval.evaluate(tparams, tc, corpus, BATCH, cache=False, stats=stats)
    assert set(got) == set(want) and got["num_queries"] == 300.0
    for k in ("recall@1", "recall@10", "ndcg@10", "mrr"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.05 < got["recall@1"] < 1.0  # the corpus does rank
    assert stats["cache_hit"] == 0.0 and stats["host_prep_s"] > 0
    assert stats["embed_s"] > 0 and stats["rank_s"] > 0
    # the embeddings themselves, and their ranks
    q, d = teval.embed_corpus(tparams, tc, corpus, BATCH)
    jq, jd = jeval.embed_corpus(jparams, jc, corpus, BATCH, "xla")
    assert q.shape == d.shape == (300, 32)
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(teval.compute_ranks(q, d),
                                  jeval.compute_ranks(jq, jd))


def test_eval_batches_wire_compress_identical(corpus):
    from dssm_tpu.data import loader as jloader

    _, tc = _cfgs()
    kw = dict(dedup_unique=1024, dedup_group=8, dedup_unique_rows=256,
              dedup_joint=True, wire_compress=True)
    tb = list(eval_batches(corpus, BATCH, **kw))
    jb = list(jloader.eval_batches(corpus, BATCH, False, **kw))
    assert len(tb) == len(jb) == 5 and "q_idx" not in tb[0]
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    assert tb[0]["q_inv"].dtype == np.int16 and tb[-1]["q_wgt"].shape[0] == 44


def test_cached_eval_matches_uncached(corpus):
    _, tc = _cfgs()
    params = tbase.init_params(tc.tower, seed=0, device="cpu")
    teval._EVAL_CACHES.clear()
    cold = teval.evaluate(params, tc, corpus, BATCH, cache=False)
    hot1 = teval.evaluate(params, tc, corpus, BATCH, cache=True)
    stats = {}
    hot2 = teval.evaluate(params, tc, corpus, BATCH, cache=True, stats=stats)
    assert cold == hot1 == hot2 and stats["cache_hit"] == 1.0
    # an explicit cache object fills on its first pass and is reused
    own = teval.EvalCache()
    assert teval.evaluate(params, tc, corpus, BATCH, cache=own) == cold
    assert own.complete and len(own.blocks) == 1  # 5 batches: K = 5
    assert teval.evaluate(params, tc, corpus, BATCH, cache=own) == cold


def test_cache_skips_host_pipeline(corpus, monkeypatch):
    """After the cache is built, evaluate never re-enters the host batch
    pipeline."""
    _, tc = _cfgs()
    params = tbase.init_params(tc.tower, seed=0, device="cpu")
    teval._EVAL_CACHES.clear()
    m1 = teval.evaluate(params, tc, corpus, BATCH, cache=True)

    def boom(*a, **k):
        raise AssertionError("host pipeline re-entered on a cached eval")

    monkeypatch.setattr(teval, "eval_batches", boom)
    assert teval.evaluate(params, tc, corpus, BATCH, cache=True) == m1
    with pytest.raises(AssertionError, match="re-entered"):
        teval.evaluate(params, tc, corpus, BATCH, cache=False)
    # an aborted fill never registers as complete
    broken = teval.EvalCache()
    with pytest.raises(AssertionError, match="re-entered"):
        teval.evaluate(params, tc, corpus, BATCH, cache=broken)
    assert not broken.complete


def test_cache_tracks_params_updates(corpus):
    """The cache holds batches, not embeddings: an eval during training sees
    the current model."""
    _, tc = _cfgs()
    params = tbase.init_params(tc.tower, seed=0, device="cpu")
    teval._EVAL_CACHES.clear()
    m1 = teval.evaluate(params, tc, corpus, BATCH, cache=True)
    bumped = {t: {k: (v + 0.05 if k == "W0" else v) for k, v in tp.items()}
              for t, tp in params.items()}
    m2 = teval.evaluate(bumped, tc, corpus, BATCH, cache=True)
    assert m2 == teval.evaluate(bumped, tc, corpus, BATCH, cache=False)
    assert any(m1[k] != m2[k] for k in ("recall@1", "ndcg@10", "mrr"))


def test_cache_keyed_on_corpus_and_batch_size(corpus):
    _, tc = _cfgs()
    params = tbase.init_params(tc.tower, seed=0, device="cpu")
    teval._EVAL_CACHES.clear()
    teval.evaluate(params, tc, corpus, BATCH, cache=True)
    assert len(teval._EVAL_CACHES) == 1
    teval.evaluate(params, tc, corpus, 50, cache=True)
    assert len(teval._EVAL_CACHES) == 2
    other = hash_pairs(make_toy_pairs(120, vocab_words=64, seed=12), tc.tower,
                       tc.data)
    m = teval.evaluate(params, tc, other, BATCH, cache=True)
    assert m == teval.evaluate(params, tc, other, BATCH, cache=False)
    assert len(teval._EVAL_CACHES) == 3
    # a bf16 table takes 16-row groups: batches of its own
    _, tc16 = _cfgs("bfloat16")
    p16 = tbase.init_params(tc16.tower, seed=0, device="cpu")
    teval.evaluate(p16, tc16, corpus, BATCH, cache=True)
    assert len(teval._EVAL_CACHES) == 4
    teval._EVAL_CACHES.clear()


# ---- the command lines -----------------------------------------------------

SMALL = ["--tower.vocab_size=4096", "--tower.embed_width=40",
         "--tower.hidden_dims=64", "--tower.semantic_dim=32",
         "--data.max_unique=1024", "--data.max_unique_rows=128",
         "--data.max_trigrams=16", "--train.batch_size=64",
         "--data.toy_num_pairs=400"]


def _run(module, *args):
    return subprocess.run(
        [sys.executable, "-m", f"dssm_tpu_torch.cli.{module}",
         "--preset=tiny", *SMALL, *args],
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_train_cli_evaluates_and_eval_cli_reports(tmp_path, table_dtype):
    work = str(tmp_path / "run")
    flags = [f"--io.workdir={work}", f"--tower.table_dtype={table_dtype}",
             "--data.freq_remap=true"]
    r = _run("train", "--cpu", *flags, "--train.max_steps=5",
             "--train.eval_every=2", "--train.log_every=2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "eval@2: recall@1=" in r.stderr and "eval@4: recall@1=" in r.stderr
    assert "final eval: recall@1=" in r.stderr
    assert "not ported" not in r.stderr
    records = [json.loads(line)
               for line in (tmp_path / "run" / "metrics.jsonl").open()]
    assert [(rec["tag"], rec["step"]) for rec in records] == [
        ("train", 0), ("train", 2), ("eval", 2), ("train", 4), ("eval", 4),
        ("eval_final", 5)]
    final = records[-1]
    for k in ("recall@1", "recall@10", "ndcg@10", "mrr", "num_queries"):
        assert np.isfinite(final[k])
    assert final["num_queries"] == 40.0

    state = Checkpointer(work).restore(device="cpu")
    table = state.params["shared"]["W0"]
    assert state.step == 5 and table.dtype == tbase.torch_dtype(table_dtype)
    assert ("W0_scale" in state.params["shared"]) == (table_dtype == "int8")

    r = _run("eval", "--cpu", *flags)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restored step 5" in r.stderr and "applied saved vocab remap" in r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["step"] == 5 and out["impl"] == "auto"
    for k in ("recall@1", "recall@10", "ndcg@10", "mrr"):
        assert out[k] == final[k], k  # the final eval, from the checkpoint

    # cli.export serves the same workdir, whatever the table's dtype
    index = str(tmp_path / "index.npz")
    r = _run("export", "--cpu", *flags, f"--out={index}")
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["indexed_docs"] > 0


def test_eval_cli_in_process(tmp_path, capsys):
    """No checkpoint: the fresh init is evaluated; a table dtype that is not
    the checkpoint's is refused; a corpus file is evaluated on dssm_tpu's
    held-out split of it; no GPU and no --cpu raises."""
    flags = ["--preset=tiny", *SMALL, f"--io.workdir={tmp_path}"]
    cli_eval.main([*flags, "--cpu"])
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip())
    assert out["step"] == 0 and "evaluating fresh init" in cap.err
    assert 0 <= out["recall@1"] <= out["recall@10"] <= 1
    _, tc = _cfgs()
    from dssm_tpu_torch.cli.args import coerce_overrides

    cfg = tcfg.validate(coerce_overrides(
        tcfg.get_preset("tiny"), dict(a[2:].split("=", 1) for a in SMALL)))
    from dssm_tpu_torch.train.state import create_run_state

    state = create_run_state(cfg, tbase.init_params(cfg.tower, seed=0,
                                                    device="cpu"))
    Checkpointer(str(tmp_path)).save(3, state)
    with pytest.raises(SystemExit, match="table_dtype"):
        cli_eval.main([*flags, "--cpu", "--tower.table_dtype=bfloat16"])
    # A corpus file, once refused (written by dssm_tpu's write_tsv): the
    # metrics are evaluate's on the held-out split dssm_tpu's
    # load_file_corpus makes of the same file, from the checkpoint.
    tsv = str(tmp_path / "pairs.tsv")
    jcorpus.write_tsv(jtoy.make_toy_pairs(300, 96, 5), tsv)
    capsys.readouterr()
    cli_eval.main([*flags, "--cpu", f"--data.path={tsv}"])
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip())
    _, j_eval, _, _ = jcorpus.load_file_corpus(
        jcfg.TowerConfig(**dataclasses.asdict(cfg.tower)),
        jcfg.DataConfig(**dataclasses.asdict(cfg.data)), tsv)
    want = teval.evaluate(state.params, cfg, HashedPairs(**{
        f: getattr(j_eval, f) for f in HashedPairs.__dataclass_fields__}),
        cfg.train.batch_size)
    assert "restored step" in cap.err and out["step"] == state.step
    assert out["num_queries"] == len(j_eval) == 30
    assert f"corpus {tsv}: 30 eval pairs" in cap.err
    for k in ("recall@1", "recall@10", "ndcg@10", "mrr"):
        assert out[k] == want[k], k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_eval.main(flags)
