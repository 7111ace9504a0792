"""Training the cnn (CLSM) and lstm towers, and any tower on raw-index
batches, with dssm_tpu_torch against dssm_tpu on the CPU: from the same
TrainState (bridge.state_from_jax) and the same batches, five steps of
make_sparse_train_step give the same loss per step, dense parameters and
table, on the joint (union dedupe), per-side and raw-index branches, and
with the rotate loss (rot_offsets a step, as train() attaches them).
The sequence towers on a bf16 and an int8 table and under the row-wise
AdaGrad table optimizer (f32 and bf16 tables): each step starts from
dssm_tpu's state, as tests/test_torch_lowprec.py runs the mlp's, and the
tables are compared in grid steps there.

Sizes: vocab 4096, T = 4 words x Kw = 4 trigrams, conv 3 x 40, LSTM E 40 /
H 32, semantic 32, batch 32.

Tolerances, as tests/test_torch_train.py: f32 compute against dssm_tpu's
XLA path 1e-5 (sums in another order), every step and after the fifth;
bf16 compute against dssm_tpu's Pallas kernels in interpret mode: loss 1e-2
and in-batch recall two rows of the batch at every step, parameters 2e-3
after the first step. After five bf16 steps at batch 32 and lr 0.1 the two
runs part further, as bf16 runs do (PERF.md): a rounding that falls
the other way feeds the next step, and in the cnn a channel whose maxima
nearly tie over the words max-pools another word, which moves that word's
table elements by lr x |g| (up to 0.02 measured, on 0.1% of them). The
five-step parameters under bf16 are held to 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.kernels.pallas_gather import force_interpret
from dssm_tpu.models import base as jbase
from dssm_tpu.train import sparse_update as jsparse
from dssm_tpu.train import state as jstate
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.loss.cosine_softmax import in_batch_loss
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train.loop import add_rotation_offsets, make_train_step

BATCH, STEPS, V = 32, 5, 4096
GROUP = {"float32": 8, "bfloat16": 16, "int8": 32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, compute_dtype="float32", shared=True, dedup=True,
          table_optimizer="sgd", table_dtype="float32", loss_mode="in_batch"):
    kw = dict(
        tower=dict(arch=arch, vocab_size=V, embed_width=40, hidden_dims=(48,),
                   conv_window=3, conv_channels=40, lstm_hidden=32,
                   semantic_dim=32, compute_dtype=compute_dtype,
                   shared_weights=shared, table_dtype=table_dtype),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_words=4,
                  max_trigrams_per_word=4, max_unique=1024,
                  max_unique_rows=256, dedup_lookup=dedup),
        train=dict(batch_size=BATCH, learning_rate=0.1,
                   table_optimizer=table_optimizer),
        loss=dict(mode=loss_mode, num_negatives=15),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"]),
            loss=m.LossConfig(**kw["loss"])))

    return build(jcfg), build(tcfg)


@pytest.fixture(scope="module")
def pairs():
    return make_toy_pairs(320, 96, 7)


def _batches(pairs, tc, n):
    """n batches of the stream as train() feeds them (rot_offsets of step i
    in rotate mode)."""
    seq = tc.tower.is_sequence_model
    dedup = tc.data.dedup_lookup
    it = batch_iterator(
        hash_pairs(pairs, tc.tower, tc.data), BATCH, seq, seed=3,
        dedup_unique=tc.data.max_unique if dedup else None,
        dedup_group=GROUP[tc.tower.table_dtype_resolved],
        dedup_unique_rows=tc.data.max_unique_rows,
        dedup_joint=tc.tower.shared_weights,
        wire_compress=dedup and not seq, sort_rows=dedup and not seq)
    return [add_rotation_offsets(next(it), tc, i) for i in range(n)]


def _states(jc, tc):
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    ts = bridge.state_from_jax(int(js.step),
                               jax.tree.map(np.asarray, js.params),
                               jax.tree.map(np.asarray, js.opt_state), tc,
                               "cpu")
    return js, ts


# (arch, compute dtype, branch, dssm_tpu impl, loss tol, param tol, loss
# mode): the joint branch also under the rotate loss, whose batches keep
# their row order and carry each step's rot_offsets.
CASES = [
    ("cnn", "float32", "joint", "xla", 1e-5, 1e-5, "in_batch"),
    ("cnn", "float32", "per_side", "xla", 1e-5, 1e-5, "in_batch"),
    ("cnn", "float32", "raw", "xla", 1e-5, 1e-5, "in_batch"),
    ("lstm", "float32", "joint", "xla", 1e-5, 1e-5, "in_batch"),
    ("lstm", "float32", "per_side", "xla", 1e-5, 1e-5, "in_batch"),
    ("lstm", "float32", "raw", "xla", 1e-5, 1e-5, "in_batch"),
    ("mlp", "float32", "raw", "xla", 1e-5, 1e-5, "in_batch"),
    ("cnn", "bfloat16", "joint", "pallas", 1e-2, 2e-3, "in_batch"),
    ("lstm", "bfloat16", "joint", "pallas", 1e-2, 2e-3, "in_batch"),
    ("cnn", "bfloat16", "raw", "pallas", 1e-2, 2e-3, "in_batch"),
    ("mlp", "bfloat16", "raw", "pallas", 1e-2, 2e-3, "in_batch"),
    ("cnn", "float32", "joint", "xla", 1e-5, 1e-5, "rotate"),
]


@pytest.mark.parametrize(
    "arch,dtype,branch,jimpl,loss_tol,param_tol,loss_mode", CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}" + ("-rotate" if c[6] == "rotate" else "")
         for c in CASES])
def test_train_steps_match_dssm_tpu(pairs, arch, dtype, branch, jimpl,
                                    loss_tol, param_tol, loss_mode):
    jc, tc = _cfgs(arch, dtype, shared=branch != "per_side",
                   dedup=branch != "raw", loss_mode=loss_mode)
    batches = _batches(pairs, tc, STEPS)
    assert ("uniq" in batches[0]) == (branch == "joint")
    assert ("q_uniq" in batches[0]) == (branch == "per_side")
    assert ("rot_offsets" in batches[0]) == (loss_mode == "rotate")
    js, ts = _states(jc, tc)
    key = tbase.TABLE_KEY[arch]
    table0 = {k: v[key].clone() for k, v in ts.params.items()}
    jstep = jax.jit(jsparse.make_sparse_train_step_body(jc, jimpl))
    tstep = make_train_step(tc)

    def params_close(atol, when):
        got_ = bridge.params_to_numpy(ts.params)
        for tower_, tp_ in jax.tree.map(np.asarray, js.params).items():
            for k_, w_ in tp_.items():
                np.testing.assert_allclose(
                    got_[tower_][k_], np.asarray(w_, np.float32), rtol=0,
                    atol=atol, err_msg=f"{when}: {tower_}/{k_}")
        return got_

    for i, batch in enumerate(batches):
        with force_interpret():
            js, jaux = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, taux = tstep(ts, bridge.batch_to_torch(batch, "cpu"))
        assert ts.step == int(js.step) == i + 1
        for k in ("loss", "in_batch_recall@1", "pos_cos"):
            np.testing.assert_allclose(
                float(taux[k]), float(jaux[k]), rtol=0,
                atol=(2 / BATCH if k == "in_batch_recall@1"
                      and dtype == "bfloat16" else loss_tol),
                err_msg=f"step {i} {k}")
        if i == 0:
            params_close(param_tol, "after one step")
    got = params_close(param_tol if dtype == "float32" else 5e-2,
                       f"after {STEPS} steps")
    for tower in got:
        # The table moved where the batches looked, and only there.
        moved = np.abs(got[tower][key] - table0[tower].numpy()).max(axis=1)
        assert moved.max() > 1e-4
        if branch == "raw":
            sides = {"shared": "qd", "query": "q", "doc": "d"}[tower]
            hit = np.zeros((V,), bool)
            for b in batches:
                for s in sides:
                    hit[b[f"{s}_idx"][b[f"{s}_wgt"] != 0]] = True
            assert (moved[~hit] == 0).all()


def _table_np(t: torch.Tensor) -> np.ndarray:
    """A table's elements as stored: int8, bf16 bit patterns, or f32."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jtable_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _grid_steps(got, want, before, table_opt):
    """Each element's distance between two updated tables in grid steps:
    int8 levels; bf16 bit patterns apart under sgd; under AdaGrad, ulps of
    the largest of the old and the two new values (its first steps move a
    weight by several times its size, so a sum lands in a far finer binade
    than it was formed in), as tests/test_torch_lowprec.py counts them."""
    if got.dtype == np.int8:
        return np.abs(got.astype(np.int64) - want.astype(np.int64))
    if table_opt == "sgd":
        o = [np.where(x < 0x8000, x, -(x & 0x7FFF)).astype(np.int64)
             for x in (got.astype(np.int64), want.astype(np.int64))]
        return np.abs(o[0] - o[1])
    a, b, old = (_bf16_values(x) for x in (got, want, before))
    big = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(old))
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30)))
                                   - 7)


# (arch, table dtype, table optimizer), the joint branch under f32 compute.
TABLE_CASES = [(arch, dtype, opt) for arch in ("cnn", "lstm")
               for dtype, opt in (("bfloat16", "sgd"), ("int8", "sgd"),
                                  ("float32", "adagrad"),
                                  ("bfloat16", "adagrad"))]


@pytest.mark.parametrize("arch,table_dtype,table_opt", TABLE_CASES,
                         ids=["-".join(c) for c in TABLE_CASES])
def test_table_dtype_and_adagrad_steps_match_dssm_tpu(pairs, arch,
                                                      table_dtype, table_opt):
    """Each step from dssm_tpu's state: loss and dense parameters to 1e-5;
    an f32 table to 1e-5 (AdaGrad rescales a gradient that is f32 noise by
    lr / sqrt(acc), 1.4e-6 measured); a bf16 or int8 table within one grid
    step (the two packages round stochastically from different random
    streams), two under AdaGrad (its accumulators differ by that noise
    before either rounds); rows of no gathered group bit-equal and
    unchanged; AdaGrad's accumulator column moved on gathered rows only,
    its dead padding columns 0; an int8 table's scale unchanged."""
    jc, tc = _cfgs(arch, table_optimizer=table_opt, table_dtype=table_dtype)
    group = GROUP[table_dtype]
    key = tbase.TABLE_KEY[arch]
    batches = _batches(pairs, tc, STEPS)
    assert "uniq" in batches[0]
    js, _ = _states(jc, tc)
    jstep = jsparse.make_sparse_train_step_body(jc, "xla")  # not jitted
    tstep = make_train_step(tc)
    moved = 0
    for i, batch in enumerate(batches):
        ts = bridge.state_from_jax(int(js.step),
                                   jax.tree.map(np.asarray, js.params),
                                   jax.tree.map(np.asarray, js.opt_state), tc,
                                   "cpu")
        before = _table_np(ts.params["shared"][key]).copy()
        js, jaux = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, taux = tstep(ts, bridge.batch_to_torch(batch, "cpu"))
        assert ts.step == int(js.step) == i + 1
        for k in ("loss", "in_batch_recall@1", "pos_cos"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=0,
                                       atol=1e-5, err_msg=f"step {i} {k}")
        want = jax.tree.map(np.asarray, js.params)["shared"]
        got = ts.params["shared"]
        assert set(got) == set(want)
        for k, w in want.items():
            if k != key:
                np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                           atol=1e-5, err_msg=f"step {i} {k}")
        g = batch["uniq"][batch["uniq"] < V // group].astype(np.int64)
        touched = np.zeros((V,), bool)
        touched[(g[:, None] * group + np.arange(group)).reshape(-1)] = True
        got_t, want_t = _table_np(got[key]), _jtable_np(want[key])
        assert got[key].dtype == tbase.torch_dtype(table_dtype)
        np.testing.assert_array_equal(got_t[~touched], want_t[~touched])
        np.testing.assert_array_equal(got_t[~touched], before[~touched])
        if table_dtype == "float32":
            np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {key}")
        else:
            gap = _grid_steps(got_t, want_t, before, table_opt)
            limit = 2 if table_opt == "adagrad" else 1
            assert gap.max() <= limit, f"step {i}: {gap.max()} grid steps"
        if table_opt == "adagrad":
            acc = got[key][:, -1].float().numpy()
            acc0 = (_bf16_values(before[:, -1]) if table_dtype == "bfloat16"
                    else before[:, -1])
            assert (acc[touched] > acc0[touched]).any()
            np.testing.assert_array_equal(acc[~touched], acc0[~touched])
            width = tc.tower.conv_window * tc.tower.conv_channels if (
                arch == "cnn") else tc.tower.embed_width
            assert not got[key][:, width:-1].float().any()
        moved += int((got_t != before).sum())
    assert moved > 1000  # sub-grid updates do land
    if table_dtype == "int8":
        np.testing.assert_array_equal(got[f"{key}_scale"].numpy(),
                                      want[f"{key}_scale"])


@pytest.mark.parametrize("arch", ["cnn", "lstm"])
def test_shared_towers_embed_each_side_with_its_own_mask(pairs, arch):
    """Shared sequence towers: the step embeds the doc side with the doc's
    word mask. One tower call over both sides stacked (as the MLP step
    does) would give the docs the queries' masks, and another loss."""
    jc, tc = _cfgs(arch)
    batch = _batches(pairs, tc, 1)[0]
    assert (batch["q_mask"] != batch["d_mask"]).any()
    js, ts = _states(jc, tc)
    tb = bridge.batch_to_torch(batch, "cpu")
    _, taux = make_train_step(tc)(ts, tb)
    _, jaux = jax.jit(jsparse.make_sparse_train_step_body(jc, "xla"))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=0, atol=1e-5)
    _, ts = _states(jc, tc)
    p, t = ts.params, tc.tower
    with torch.no_grad():
        lq, ld = (tbase.embed_table_lookup(p, t, s, tb) for s in "qd")
        q = tbase.embed_from_lookup(p, t, "q", tb, lq)
        d_wrong = tbase.embed_from_lookup(p, t, "q", tb, ld)  # q's mask
    stacked, _ = in_batch_loss(q, d_wrong, tc.loss.gamma)
    assert abs(float(stacked) - float(taux["loss"])) > 1e-3


def test_raw_branch_refuses_adagrad(pairs):
    _, tc = _cfgs("cnn", dedup=True, table_optimizer="adagrad")
    raw_cfg = tc.replace(data=tc.data.replace(dedup_lookup=False))
    _, ts = _states(*_cfgs("cnn"))
    batch = _batches(pairs, raw_cfg, 1)[0]
    with pytest.raises(ValueError, match="adagrad"):
        make_train_step(tc)(ts, bridge.batch_to_torch(batch, "cpu"))
