"""K steps a call in dssm_tpu_torch against dssm_tpu on the CPU:
make_multi_train_step is K single steps (bit-equal here) and matches
dssm_tpu's scanned multi-step on the dense, sparse-dedupe, sparse-raw and
AdaGrad-table steps (the cases of tests/test_multi_step.py); train() at
train.steps_per_call = K reports the same steps with the same losses as
dssm_tpu's train(), ragged tail included; cli.train at K = 3 writes its
metrics records, evals and checkpoints on the steps dssm_tpu's cli.train
writes them. Also the host-side range check of raw-index batches that
replaced the lookup kernel's read-back.

Sizes: vocab 2048, embed 32, hidden 24, semantic 16, batch 32, K = 3 (the
CLI: the SMALL flags of tests/test_torch_serve.py, batch 64).

Tolerances: f32 compute against dssm_tpu's XLA path 1e-5 (sums in another
order); 1e-4 with the row-wise AdaGrad table, which rescales a gradient to
the size of the learning rate. The port's K-step call runs the same eager
step K times, so against its own single steps it is bit-equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.models import base as jbase
from dssm_tpu.train import loop as jloop
from dssm_tpu.train import state as jstate
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import loader as tloader
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.train import eval as teval
from dssm_tpu_torch.train import loop as tloop

B, K, V = 32, 3, 2048


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**train_kw):
    kw = dict(
        tower=dict(vocab_size=V, embed_width=32, hidden_dims=(24,),
                   semantic_dim=16),
        data=dict(max_trigrams=32, max_unique=1024, max_unique_rows=256),
        train=dict(batch_size=B, learning_rate=0.1, **train_kw),
    )

    def build(m, extra):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            loss=m.LossConfig(mode="in_batch"),
            train=m.TrainConfig(**kw["train"], **extra)))

    # dssm_tpu's XLA path; the port has no use_pallas switch.
    return build(jcfg, dict(use_pallas=False)), build(tcfg, {})


@pytest.fixture(scope="module")
def hashed():
    _, tc = _cfgs()
    return tloader.hash_pairs(make_toy_pairs(B * 8, vocab_words=64, seed=7),
                              tc.tower, tc.data)


def _batches(hashed, dedup, n=K):
    """The batches of tests/test_multi_step.py: per-side dedupe or raw."""
    return [tloader.select_batch(
        hashed, np.arange(i * B, (i + 1) * B),
        dedup_unique=1024 if dedup else None, dedup_unique_rows=256)
        for i in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _states(jc, tc):
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=0))
    ts = bridge.state_from_jax(int(js.step), _np(js.params),
                               _np(js.opt_state), tc, "cpu")
    return js, ts


def _tree_equal(a, b):
    for tower, tp in a.items():
        for k, v in tp.items():
            assert torch.equal(v, b[tower][k]), f"{tower}/{k}"


def _tree_close(got, want, atol):
    for tower, tp in want.items():
        for k, w in tp.items():
            np.testing.assert_allclose(got[tower][k].numpy(), w, rtol=0,
                                       atol=atol, err_msg=f"{tower}/{k}")


@pytest.mark.parametrize("train_kw,dedup", [
    (dict(sparse_embed_update=False), False),  # dense step
    (dict(), True),                            # sparse dedupe step
    (dict(), False),                           # sparse raw step
    (dict(table_optimizer="adagrad"), True),   # row-wise AdaGrad table
], ids=["dense", "sparse-dedupe", "sparse-raw", "adagrad-dedupe"])
def test_multi_step_matches_single_steps_and_dssm_tpu(hashed, train_kw,
                                                      dedup):
    jc, tc = _cfgs(**train_kw)
    batches = _batches(hashed, dedup)
    js, ts = _states(jc, tc)
    _, ts_single = _states(jc, tc)
    step = tloop.make_train_step(tc)
    single_losses = []
    for b in batches:
        ts_single, aux = step(ts_single, bridge.batch_to_torch(b, "cpu"))
        single_losses.append(aux["loss"])
    stacked = tloop.stack_batches(batches)
    ts, auxes = tloop.make_multi_train_step(tc)(
        ts, bridge.batch_to_torch(stacked, "cpu", vocab_size=V))
    assert ts.step == K and auxes["loss"].shape == (K,)
    assert torch.equal(auxes["loss"], torch.stack(single_losses))
    _tree_equal(ts.params, ts_single.params)

    js, jauxes = jloop.make_multi_train_step(jc, impl="xla")(js, stacked)
    np.testing.assert_allclose(auxes["loss"].numpy(),
                               np.asarray(jauxes["loss"]), rtol=0, atol=1e-5)
    atol = 1e-4 if train_kw.get("table_optimizer") == "adagrad" else 1e-5
    _tree_close(ts.params, _np(js.params), atol)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("steps", [5, 7])
def test_train_reports_the_steps_dssm_tpu_reports(hashed, k, steps):
    """train() at K steps a call: a block's last step is reported, with its
    own loss, when i % log_every < K; the ragged tail is not. The port once
    reported i % log_every == 0 whatever K."""
    jc, tc = _cfgs(steps_per_call=k, log_every=2)
    stream = tloader.batch_iterator(
        hashed, B, seed=5, dedup_unique=1024, dedup_unique_rows=256,
        dedup_joint=True, wire_compress=True, sort_rows=True)
    batches = [next(stream) for _ in range(steps)]
    js, ts = _states(jc, tc)
    got, want = [], []
    ts = tloop.train(tc, ts, iter(batches), steps,
                     metrics_cb=lambda i, aux: got.append((i, aux)))
    js = jloop.train(jc, js, iter(batches), steps,
                     metrics_cb=lambda i, aux: want.append((i, aux)))
    assert [i for i, _ in got] == [i for i, _ in want]
    assert got and all(a["step_ms"] > 0 for _, a in got)
    for (i, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0, atol=1e-5,
                                   err_msg=f"step {i}")
    assert ts.step == int(js.step) == steps
    _tree_close(ts.params, _np(js.params), 1e-5)


SMALL = ["--tower.vocab_size=4096", "--tower.embed_width=40",
         "--tower.hidden_dims=64", "--tower.semantic_dim=32",
         "--data.max_trigrams=16", "--data.max_trigrams_query=8",
         "--data.max_unique=512", "--data.max_unique_rows=128",
         "--data.toy_num_pairs=150", "--data.toy_vocab_words=64",
         "--train.batch_size=64"]


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"]) for r in map(json.loads, f)]


def test_train_cli_blocks_land_records_where_dssm_tpus_do(tmp_path):
    """cli.train --train.steps_per_call=3 over 8 steps: two blocks, then
    a tail of two single steps. Its train / eval / eval_final records and
    its checkpoint steps are dssm_tpu's cli.train's on the same flags."""
    from dssm_tpu.cli import train as jcli
    from dssm_tpu_torch.cli import train as tcli
    from dssm_tpu_torch.io.checkpoint import Checkpointer

    flags = [*SMALL, "--train.steps_per_call=3", "--train.max_steps=8",
             "--train.log_every=2", "--train.eval_every=4",
             "--train.checkpoint_every=4", "--train.keep_checkpoints=10"]
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tcli.main(["--preset=tiny", "--cpu", *flags, f"--io.workdir={tdir}"])
    jcli.main(["--preset=tiny", "--cpu", *flags, f"--io.workdir={jdir}"])
    # Blocks end on steps 2 and 5; the tail is 6 and 7. Records land where
    # step % every < 3: train 2, 5, 6, 7; eval 2, 5, 6; checkpoints 2, 5,
    # 6 and the final 8.
    want = _records(jdir)
    assert _records(tdir) == want
    assert [s for t, s in want if t == "train"] == [2, 5, 6, 7]
    ref_steps = sorted(int(d) for d in os.listdir(
        os.path.join(jdir, "checkpoints")) if d.isdigit())
    assert Checkpointer(tdir).all_steps() == ref_steps == [2, 5, 6, 8]


def test_raw_batches_are_checked_on_the_host(hashed):
    """A live lookup outside the table is refused on the host, before its
    batch reaches the device or a step: by batch_to_torch given the table's
    rows, and so by train() and evaluate(). A lookup of weight 0 may point
    anywhere, and a dedupe batch's slots are not looked at."""
    _, tc = _cfgs()
    batch = _batches(hashed, False, 1)[0]
    live = tuple(np.argwhere(batch["d_wgt"] != 0)[0])
    dead = tuple(np.argwhere(batch["d_wgt"] == 0)[0])
    bad = dict(batch, d_idx=batch["d_idx"].copy())
    bad["d_idx"][live] = V + 3
    with pytest.raises(IndexError, match=f"row {V + 3}, outside the table"):
        bridge.batch_to_torch(bad, "cpu", vocab_size=V)
    ok = dict(batch, d_idx=batch["d_idx"].copy())
    ok["d_idx"][dead] = -5
    bridge.batch_to_torch(ok, "cpu", vocab_size=V)
    bridge.batch_to_torch(_batches(hashed, True, 1)[0], "cpu", vocab_size=1)

    _, ts = _states(*_cfgs())
    w0 = ts.params["shared"]["W0"].clone()
    with pytest.raises(IndexError):
        tloop.train(tc, ts, iter([bad]), 1)
    assert torch.equal(ts.params["shared"]["W0"], w0)

    raw = tc.replace(data=tc.data.replace(dedup_lookup=False))
    corpus = tloader.HashedPairs(hashed.q_idx, hashed.q_wgt,
                                 hashed.d_idx.copy(), hashed.d_wgt)
    corpus.d_idx[tuple(np.argwhere(corpus.d_wgt != 0)[0])] = -2
    with pytest.raises(IndexError, match="row -2"):
        teval.evaluate(ts.params, raw, corpus, B, cache=False)
