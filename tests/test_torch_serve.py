"""The serving slice of dssm_tpu_torch against dssm_tpu on the CPU: the same
weights (carried by bridge.params_from_jax) and the same titles give the same
doc index, query embeddings and top-k; the export CLI builds and queries an
index that dssm_tpu reads.

Tolerances: f32 1e-5 (sums in another order); bf16 compute 2e-2 (dssm_tpu's
XLA tower returns its products in bf16, the port keeps them in f32 as the
Pallas tower does).
"""

import json
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dssm_tpu import serve as jserve
from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import toy as jtoy
from dssm_tpu.kernels.pallas_gather import force_interpret
from dssm_tpu.models import base as jbase
from dssm_tpu_torch import bridge
from dssm_tpu_torch import serve as tserve
from dssm_tpu_torch.cli import export as texport
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.remap import build_freq_remap
from dssm_tpu_torch.data.loader import hash_pairs
from dssm_tpu_torch.data.toy import ToyPairs
from dssm_tpu_torch.device import resolve_device
from dssm_tpu_torch.models import base as tbase

BATCH = 64
SMALL = ["--tower.vocab_size=4096", "--tower.embed_width=40",
         "--tower.hidden_dims=64", "--tower.semantic_dim=32",
         "--data.max_trigrams=16", "--data.max_trigrams_query=8",
         "--data.max_unique=512", "--data.max_unique_rows=128",
         "--data.toy_num_pairs=150", "--data.toy_vocab_words=64",
         f"--train.batch_size={BATCH}"]


def _cfgs(compute_dtype="float32", max_unique=512, activation="tanh",
          shared=True):
    kw = dict(
        tower=dict(vocab_size=4096, embed_width=40, hidden_dims=(64,),
                   semantic_dim=32, compute_dtype=compute_dtype,
                   activation=activation, shared_weights=shared),
        data=dict(max_trigrams=16, max_trigrams_query=8,
                  max_unique=max_unique, max_unique_rows=128),
        train=dict(batch_size=BATCH),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


def _params(jc, tc, seed=0):
    jp = jbase.init_params(jc.tower, seed=seed)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc.tower, "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def pairs():
    return jtoy.make_toy_pairs(150, 64, 5)


def test_bridge_carries_init_params_exactly():
    jc, tc = _cfgs()
    for shared in (True, False):
        jt = jc.tower.replace(shared_weights=shared)
        tt = tc.tower.replace(shared_weights=shared)
        jp = jax.tree.map(np.asarray, jbase.init_params(jt, seed=3))
        tp = bridge.params_from_jax(jp, tt, "cpu")
        own = tbase.init_params(tt, seed=3, device="cpu")
        assert sorted(tp) == sorted(own) == sorted(jp)
        for tower in jp:
            assert tp[tower]["W0"].shape == (4096, 128)  # padded to 128
            for k in jp[tower]:
                np.testing.assert_array_equal(tp[tower][k].numpy(), jp[tower][k])
                assert torch.equal(own[tower][k], tp[tower][k])
    bf = jp["query"]["W1"].astype(ml_dtypes.bfloat16)
    got = bridge._to_tensor(bf)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), bf.astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax({"shared": {**jp["query"], "W0": np.zeros((8, 8))}},
                               tt, "cpu")


def test_batch_to_torch_widens_wire_fields():
    b = {"q_inv": np.arange(6, dtype=np.int16).reshape(2, 3),
         "q_wgt": np.ones((2, 3), np.uint8), "uniq": np.zeros(4, np.int32)}
    t = bridge.batch_to_torch(b, "cpu")
    assert t["q_inv"].dtype == torch.int32 and t["uniq"].dtype == torch.int32
    assert t["q_wgt"].dtype == torch.float32


def _top_k_agree(jq, jd, ts, ti, k):
    js, ji = jserve.top_k(jq, jd, k=k)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    scores = jq @ jd.T
    for q, r in np.argwhere(ti != ji):  # only at ties
        assert abs(scores[q, ti[q, r]] - scores[q, ji[q, r]]) <= 1e-5


# The last case has separate query and doc towers: per-side dedupe fields.
@pytest.mark.parametrize("compute_dtype,activation,tol,shared", [
    ("float32", "tanh", 1e-5, True), ("float32", "relu", 1e-5, True),
    ("bfloat16", "tanh", 2e-2, True), ("float32", "tanh", 1e-5, False)])
def test_serving_matches_dssm_tpu(pairs, compute_dtype, activation, tol,
                                  shared):
    jc, tc = _cfgs(compute_dtype, activation=activation, shared=shared)
    jp, tp = _params(jc, tc)
    titles = list(dict.fromkeys(pairs.titles))
    jd = jserve.build_doc_index(jp, jc, titles, BATCH, impl="xla")
    td = tserve.build_doc_index(tp, tc, titles, BATCH, device="cpu")
    assert td.shape == (len(titles), 32) and td.dtype == np.float32
    np.testing.assert_allclose(td, jd, rtol=0, atol=tol)
    jq = jserve.embed_queries(jp, jc, pairs.queries, BATCH, impl="xla")
    tq = tserve.embed_queries(tp, tc, pairs.queries, BATCH, device="cpu")
    np.testing.assert_allclose(tq, jq, rtol=0, atol=tol)
    if compute_dtype == "float32":
        ts, ti = tserve.top_k(tq, td, k=5, chunk=64, device="cpu")
        _top_k_agree(jq, jd, ts, ti, 5)


def test_serving_with_remap_matches_dssm_tpu_pallas(pairs):
    """dssm_tpu's Pallas kernels (interpret mode) on a remapped vocab; 16
    gather slots keep the interpreted gather small."""
    jc, tc = _cfgs(max_unique=128)
    jp, tp = _params(jc, tc, seed=1)
    titles = list(dict.fromkeys(pairs.titles))[:100]
    remap = build_freq_remap(
        hash_pairs(ToyPairs(pairs.queries, titles), tc.tower, tc.data), 4096)
    with force_interpret():
        jd = jserve.build_doc_index(jp, jc, titles, BATCH, impl="pallas",
                                    remap=remap)
    td = tserve.build_doc_index(tp, tc, titles, BATCH, remap=remap,
                                device="cpu")
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)


def test_raw_index_batch_not_ported():
    jc, tc = _cfgs()
    _, tp = _params(jc, tc)
    batch = {"d_idx": torch.ones((2, 16), dtype=torch.int32),
             "d_wgt": torch.ones((2, 16))}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbase.embed(tp, tc.tower, "d", batch)


def test_top_k_matches_dssm_tpu():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(70, 16)).astype(np.float32)
    d = rng.normal(size=(300, 16)).astype(np.float32)
    d[7] = d[3]  # an exact tie
    ts, ti = tserve.top_k(q, d, k=10, chunk=32, device="cpu")
    assert ts.dtype == np.float32 and ti.dtype == np.int64
    assert np.all(np.diff(ts, axis=1) <= 0)
    _top_k_agree(q, d, ts, ti, 10)
    es, ei = tserve.top_k(q[:0], d, k=5, device="cpu")
    assert es.shape == ei.shape == (0, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.top_k(q, d, exact=False, device="cpu")


def test_no_silent_cpu_fallback(pairs):
    if torch.cuda.is_available():
        assert resolve_device(cpu=False).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(cpu=False)
    jc, tc = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbase.init_params(tc.tower, seed=0)
    _, tp = _params(jc, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_doc_index(tp, tc, pairs.titles[:4], BATCH)


def _export(*args):
    r = subprocess.run(
        [sys.executable, "-m", "dssm_tpu_torch.cli.export", "--preset=tiny",
         "--cpu", *SMALL, *args],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_export_cli_builds_and_queries_index(tmp_path):
    work, index = str(tmp_path / "run"), str(tmp_path / "index.npz")
    r = _export(f"--io.workdir={work}", f"--out={index}")
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert "using fresh init" in r.stderr
    emb, titles = jserve.load_index(index)  # dssm_tpu reads the port's index
    assert info["indexed_docs"] == len(titles) == emb.shape[0]
    assert emb.shape[1] == 32
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    r = _export(f"--io.workdir={work}", f"--index={index}",
                f"--query={titles[3]}", "--k=3")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["query"] == titles[3] and len(out["results"]) == 3
    assert out["results"][0]["score"] >= out["results"][-1]["score"]


@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_export_cli_impl_does_not_depend_on_preset(tmp_path, monkeypatch,
                                                    preset):
    """The CLI always asks for impl="auto" (kernels on CUDA tensors), and
    dssm_tpu's use_pallas switch is refused rather than honoured."""
    seen = []

    def embed(params, cfg, texts, batch_size, impl, remap, device):
        seen.append(impl)
        return np.eye(len(texts), 4, dtype=np.float32)

    monkeypatch.setattr(tbase, "init_params", lambda *a, **k: None)
    monkeypatch.setattr(tserve, "build_doc_index", embed)
    monkeypatch.setattr(tserve, "embed_queries", embed)
    index = str(tmp_path / "index.npz")
    common = [f"--preset={preset}", "--cpu", f"--io.workdir={tmp_path}",
              "--data.toy_num_pairs=8"]
    texport.main([*common, f"--out={index}"])
    texport.main([*common, f"--index={index}", "--query=hiking", "--k=2"])
    assert seen == ["auto", "auto"]
    with pytest.raises(AttributeError, match="use_pallas"):
        texport.main([*common, f"--out={index}", "--train.use_pallas=false"])


def test_export_cli_refuses_dssm_tpu_checkpoint(tmp_path):
    (tmp_path / "checkpoints" / "60").mkdir(parents=True)
    with pytest.raises(SystemExit, match="no orbax checkpoint reader"):
        texport.main(["--preset=tiny", "--cpu", *SMALL,
                      f"--io.workdir={tmp_path}",
                      f"--out={tmp_path / 'index.npz'}"])
    assert not (tmp_path / "index.npz").exists()


def _train(*args, cpu=True):
    return subprocess.run(
        [sys.executable, "-m", "dssm_tpu_torch.cli.train", "--preset=tiny",
         *(["--cpu"] if cpu else []), *SMALL, "--data.toy_num_pairs=400",
         "--train.log_every=1", *args],
        capture_output=True, text=True, timeout=300)


def test_train_cli_then_export_serves_the_trained_weights(tmp_path):
    """Train 2 steps on the CPU, save, and cli.export serves from the
    port's checkpoint (and through the saved vocab remap); --resume
    continues at the saved step."""
    work, index = str(tmp_path / "run"), str(tmp_path / "index.npz")
    r = _train(f"--io.workdir={work}", "--train.max_steps=2",
               "--data.freq_remap=true")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step 0: loss=" in r.stderr and "step 1: loss=" in r.stderr
    assert "evaluation is not ported yet" in r.stderr
    records = [json.loads(line)
               for line in (tmp_path / "run" / "metrics.jsonl").open()]
    assert [rec["step"] for rec in records] == [0, 1]
    assert all(rec["tag"] == "train" and np.isfinite(rec["loss"])
               for rec in records)
    from dssm_tpu_torch.data.remap import load_remap
    from dssm_tpu_torch.io.checkpoint import Checkpointer

    state = Checkpointer(work).restore(device="cpu")
    assert state.step == 2 and load_remap(work) is not None
    fresh = tbase.init_params(
        tcfg.TowerConfig(vocab_size=4096, embed_width=40, hidden_dims=(64,),
                         semantic_dim=32), seed=42, device="cpu")
    assert not torch.equal(state.params["shared"]["W1"],
                           fresh["shared"]["W1"])  # it trained

    r = _export(f"--io.workdir={work}", f"--out={index}",
                "--data.toy_num_pairs=400", "--data.freq_remap=true")
    assert "restored step 2" in r.stderr and "fresh init" not in r.stderr
    assert "applying saved vocab remap" in r.stderr
    emb, titles = tserve.load_index(index)
    # The index is the restored weights' own, not the fresh init's.
    from dssm_tpu_torch.config import configs as cfgs
    from dssm_tpu_torch.cli.args import coerce_overrides

    cfg = cfgs.validate(coerce_overrides(
        cfgs.get_preset("tiny"),
        dict(a[2:].split("=", 1) for a in SMALL)))
    want = tserve.build_doc_index(state.params, cfg, titles, BATCH, "auto",
                                  load_remap(work), "cpu")
    np.testing.assert_allclose(emb, want, rtol=0, atol=1e-6)
    r = _export(f"--io.workdir={work}", f"--index={index}",
                f"--query={titles[5]}", "--k=3")
    assert json.loads(r.stdout.strip().splitlines()[-1])["results"]

    r = _train(f"--io.workdir={work}", "--train.max_steps=3", "--resume",
               "--data.freq_remap=true")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed from step 2" in r.stderr and "step 2: loss=" in r.stderr
    assert Checkpointer(work).all_steps() == [2, 3]


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    if not torch.cuda.is_available():
        r = _train(f"--io.workdir={tmp_path}", "--train.max_steps=1",
                   cpu=False)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
    for flag, what in (("--data.path=/nonexistent.tsv", "file corpus"),
                       ("--train.sparse_embed_update=false",
                        "dense-table train step"),
                       ("--io.tensorboard=true", "tooling")):
        r = _train(f"--io.workdir={tmp_path}", "--train.max_steps=1", flag)
        assert r.returncode != 0 and "NotImplementedError" in r.stderr
        assert what in r.stderr and "ROADMAP.md" in r.stderr
