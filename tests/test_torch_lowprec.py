"""The bf16 and int8 embedding tables of dssm_tpu_torch against dssm_tpu on
the CPU: init, forward, train step, trajectory, checkpoint.

Tolerances. init_params: bit-equal (table and scale). Forward: the serving
tolerances, 1e-5 under f32 compute (sums in another order) and 2e-2 under
bf16 compute (one bf16 rounding of an intermediate). Train step, f32 compute:
every step starts from dssm_tpu's own state, so loss and dense parameters
agree to 1e-5; the two packages draw different random streams (Philox here,
threefry there), so an updated table element is one of the two grid
neighbours of the same f32 accumulator in each: within ONE grid step of each
other (one bf16 ulp, one int8 level; two under row-wise AdaGrad, whose
accumulators themselves differ by up to 1e-4), rows of no gathered group
bit-equal.
The rounding points of a bf16 table are dssm_tpu's: the compact gradient comes
back from autograd rounded to bf16, -lr * g is a bf16 product with lr rounded
to bf16, and the f32 accumulator is f32(row) + f32(vals). dssm_tpu's step is
run op by op here, not under jax.jit: compiled, XLA elides the f32 -> bf16 ->
f32 round trips of the compact gradient (its allow-excess-precision default)
and keeps more bits than the code states; the port follows the code as
written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.models import base as jbase
from dssm_tpu.train import sparse_update as jsparse
from dssm_tpu.train import state as jstate
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.loader import (
    batch_iterator, hash_pairs, select_batch)
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.io.checkpoint import Checkpointer
from dssm_tpu_torch.kernels.gather import sublane_group
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import sparse_update as tsparse
from dssm_tpu_torch.train import state as tstate
from dssm_tpu_torch.train.loop import make_train_step, train

V, BATCH, STEPS = 4096, 64, 5
GROUP = {"float32": 8, "bfloat16": 16, "int8": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(table_dtype, compute_dtype="float32", shared=True, **train_kw):
    kw = dict(
        tower=dict(vocab_size=V, embed_width=100, hidden_dims=(64,),
                   semantic_dim=32, compute_dtype=compute_dtype,
                   shared_weights=shared, table_dtype=table_dtype),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_unique=1024,
                  max_unique_rows=128),
        train=dict(batch_size=BATCH, learning_rate=0.1, **train_kw),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


@pytest.fixture(scope="module")
def hashed():
    _, tc = _cfgs("bfloat16")
    return hash_pairs(make_toy_pairs(512, 96, 7), tc.tower, tc.data)


def _batches(hashed, tc, n):
    it = batch_iterator(
        hashed, BATCH, seed=3, dedup_unique=tc.data.max_unique,
        dedup_group=GROUP[tc.tower.table_dtype_resolved],
        dedup_unique_rows=tc.data.max_unique_rows,
        dedup_joint=tc.tower.shared_weights, wire_compress=True,
        sort_rows=True)
    return [next(it) for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ordered(a: np.ndarray) -> np.ndarray:
    """A table as integers in which grid neighbours differ by 1: int8 as it
    is, bf16 bit patterns mapped from sign-magnitude to a number line."""
    if a.dtype == np.int8:
        return a.astype(np.int64)
    bits = a.view(np.uint16).astype(np.int64)
    return np.where(bits < 0x8000, bits, -(bits & 0x7FFF))


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns as float32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _table_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.int8:
        return t.numpy()
    return t.view(torch.int16).numpy().view(np.uint16)


def _jtable_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.view(np.uint16)


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("shared", [True, False])
def test_init_params_bit_equal(table_dtype, shared):
    if table_dtype == "int8" and not shared:
        with pytest.raises(ValueError, match="shared_weights"):
            _cfgs(table_dtype, shared=False)
        return
    jc, tc = _cfgs(table_dtype, shared=shared)
    want = _np_tree(jbase.init_params(jc.tower, seed=3))
    got = tbase.init_params(tc.tower, seed=3, device="cpu")
    assert set(got) == set(want)
    for tower, tp in want.items():
        assert set(got[tower]) == set(tp)
        table = got[tower]["W0"]
        assert table.dtype == tbase.torch_dtype(table_dtype)
        np.testing.assert_array_equal(_table_np(table), _jtable_np(tp["W0"]))
        if table_dtype == "int8":
            scale = got[tower]["W0_scale"]
            assert scale.dtype == torch.float32 and scale.shape == (V, 1)
            np.testing.assert_array_equal(scale.numpy(), tp["W0_scale"])
            assert not scale[:, 0].eq(0).any() and table.abs().max() <= 127
        for k in ("b0", "W1", "b1", "W2", "b2"):
            np.testing.assert_array_equal(got[tower][k].numpy(), tp[k])
    # the bridge carries the same tree across, dtypes kept
    carried = bridge.params_from_jax(want, tc.tower, "cpu")
    for tower, tp in got.items():
        for k, v in tp.items():
            assert carried[tower][k].dtype == v.dtype
            assert torch.equal(carried[tower][k].view(torch.uint8),
                               v.view(torch.uint8))
    back = bridge.params_to_numpy(got)
    assert back[next(iter(back))]["W0"].dtype == (
        np.int8 if table_dtype == "int8" else np.float32)


def test_int8_init_zero_rows_get_scale_zero(monkeypatch):
    """A row of zeros quantizes to zeros under scale 0, as in dssm_tpu."""
    from dssm_tpu.models import mlp as jmlp
    from dssm_tpu_torch.models import mlp as tmlp

    jc, tc = _cfgs("int8")
    j_init, t_init = jmlp.init_tower, tmlp.init_tower

    def j_zeroed(cfg, seed=0):
        p = j_init(cfg, seed)
        return {**p, "W0": p["W0"].at[7].set(0.0)}

    def t_zeroed(cfg, seed=0):
        p = t_init(cfg, seed)
        p["W0"][7] = 0.0
        return p

    monkeypatch.setattr(jmlp, "init_tower", j_zeroed)
    monkeypatch.setattr(tmlp, "init_tower", t_zeroed)
    want = _np_tree(jbase.init_params(jc.tower, seed=1))["shared"]
    got = tbase.init_params(tc.tower, seed=1, device="cpu")["shared"]
    assert got["W0_scale"][7] == 0 and not got["W0"][7].any()
    np.testing.assert_array_equal(got["W0"].numpy(), want["W0"])
    np.testing.assert_array_equal(got["W0_scale"].numpy(), want["W0_scale"])


@pytest.mark.parametrize("table_dtype,compute_dtype,shared,tol", [
    ("bfloat16", "float32", True, 1e-5),
    ("bfloat16", "float32", False, 1e-5),
    ("bfloat16", "bfloat16", True, 2e-2),
    ("int8", "float32", True, 1e-5),
    ("int8", "bfloat16", True, 2e-2),
])
def test_forward_matches_dssm_tpu(hashed, table_dtype, compute_dtype, shared,
                                  tol):
    jc, tc = _cfgs(table_dtype, compute_dtype, shared)
    jparams = jbase.init_params(jc.tower, seed=1)
    tparams = bridge.params_from_jax(_np_tree(jparams), tc.tower, "cpu")
    batch = _batches(hashed, tc, 1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = bridge.batch_to_torch(batch, "cpu")
    for side in "qd":
        want = np.asarray(jbase.embed(jparams, jc.tower, side, jbatch,
                                      impl="xla"))
        got = tbase.embed(tparams, tc.tower, side, tbatch).numpy()
        assert got.shape == (BATCH, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_dequant_compact_and_scale_rows_match_dssm_tpu():
    from dssm_tpu.kernels import dedup_embed as jde
    from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
    from dssm_tpu_torch.kernels import dedup_embed as tde

    rng = np.random.default_rng(8)
    scale = rng.uniform(1e-3, 1e-2, size=(V, 1)).astype(np.float32)
    gids = np.asarray([0, 5, 127, SKIP_SENTINEL_GID], np.int32)
    compact = rng.integers(-127, 128, size=(4 * 32, 128)).astype(np.int8)
    want_sc = np.asarray(jde.gather_scale_rows(jnp.asarray(scale),
                                               jnp.asarray(gids), 32))
    got_sc = tde.gather_scale_rows(torch.from_numpy(scale),
                                   torch.from_numpy(gids), 32).numpy()
    np.testing.assert_array_equal(got_sc, want_sc)
    assert not got_sc[-32:].any()
    want = np.asarray(jde.dequant_compact(
        jnp.asarray(compact), jnp.asarray(scale), jnp.asarray(gids), 32))
    got = tde.dequant_compact(torch.from_numpy(compact),
                              torch.from_numpy(scale), torch.from_numpy(gids),
                              32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table_dtype,shared,table_opt", [
    ("bfloat16", True, "sgd"), ("bfloat16", False, "sgd"),
    ("int8", True, "sgd"), ("bfloat16", True, "adagrad")],
    ids=["bf16-joint", "bf16-per_side", "int8-joint", "bf16-joint-adagrad"])
def test_train_steps_match_dssm_tpu(hashed, table_dtype, shared, table_opt):
    """table_opt="adagrad": the row-wise accumulator rides in the table's
    last padding column, in bf16, and is rounded stochastically with it."""
    jc, tc = _cfgs(table_dtype, "float32", shared, table_optimizer=table_opt)
    group = GROUP[table_dtype]
    batches = _batches(hashed, tc, STEPS)
    assert ("uniq" in batches[0]) == shared
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    jstep = jsparse.make_sparse_train_step_body(jc, "xla")  # not jitted
    tstep = make_train_step(tc)
    moved = 0
    for i, batch in enumerate(batches):
        # The port starts each step from dssm_tpu's own state.
        ts = bridge.state_from_jax(int(js.step), _np_tree(js.params),
                                   _np_tree(js.opt_state), tc, "cpu")
        before = {k: _table_np(v["W0"]).copy() for k, v in ts.params.items()}
        js, jaux = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, taux = tstep(ts, bridge.batch_to_torch(batch, "cpu"))
        assert ts.step == int(js.step) == i + 1
        for k in ("loss", "in_batch_recall@1", "pos_cos"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=0,
                                       atol=1e-5, err_msg=f"step {i} {k}")
        want = _np_tree(js.params)
        for tower, tp in want.items():
            got = ts.params[tower]
            assert set(got) == set(tp)
            for k, w in tp.items():
                if k == "W0":
                    continue
                np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                           atol=1e-5, err_msg=f"{tower}/{k}")
            sides = {"shared": "qd", "query": "q", "doc": "d"}[tower]
            touched = np.zeros((V,), bool)
            for key in (["uniq"] if shared else [f"{s}_uniq" for s in sides]):
                g = batch[key][batch[key] < V // group].astype(np.int64)
                touched[(g[:, None] * group + np.arange(group)).reshape(-1)] = 1
            got_t, want_t = _table_np(got["W0"]), _jtable_np(tp["W0"])
            assert got["W0"].dtype == tbase.torch_dtype(table_dtype)
            np.testing.assert_array_equal(got_t[~touched], want_t[~touched])
            np.testing.assert_array_equal(got_t[~touched],
                                          before[tower][~touched])
            gap = np.abs(_ordered(got_t) - _ordered(want_t))
            if table_opt == "adagrad":
                # AdaGrad's first steps move a weight by several times its
                # size, so a sum often lands in a far finer binade than it
                # was formed in: count in ulps of the largest of the old
                # and the two new values (the grid of the sum's operands).
                a, b, old = (_bf16_values(x) for x in
                             (got_t, want_t, before[tower]))
                big = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(old))
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
                gap = np.abs(a - b) / ulp
            # AdaGrad rescales a gradient that is f32 cancellation noise to
            # the size of lr (test_torch_train.py allows 1e-4 for it, 0.4
            # ulp of these weights): the two accumulators can differ by
            # that before either rounds, so two grid steps, not one.
            limit = 2 if table_opt == "adagrad" else 1
            assert gap.max() <= limit, f"step {i}: {gap.max()} grid steps"
            moved += int((got_t != before[tower]).sum())
    assert moved > 1000  # sub-grid updates do land
    if table_dtype == "int8":
        np.testing.assert_array_equal(
            ts.params["shared"]["W0_scale"].numpy(),
            np.asarray(js.params["shared"]["W0_scale"]))


def test_bf16_table_round_to_nearest_option_matches_dssm_tpu(hashed):
    """train.table_stochastic_round=False: vals are cast to bf16 and added
    with a bf16 add, no random stream, so the table is bit-equal."""
    jc, tc = _cfgs("bfloat16", table_stochastic_round=False)
    batches = _batches(hashed, tc, 3)
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    ts = bridge.state_from_jax(0, _np_tree(js.params), _np_tree(js.opt_state),
                               tc, "cpu")
    jstep = jsparse.make_sparse_train_step_body(jc, "xla")  # not jitted
    tstep = make_train_step(tc)
    for batch in batches[:1]:
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, _ = tstep(ts, bridge.batch_to_torch(batch, "cpu"))
    got = _ordered(_table_np(ts.params["shared"]["W0"]))
    want = _ordered(_jtable_np(js.params["shared"]["W0"]))
    # f32 gradient sums in another order can tip a round-to-nearest: a
    # handful of elements one ulp apart, the rest bit-equal.
    gap = np.abs(got - want)
    assert gap.max() <= 1 and (gap > 0).mean() < 1e-3


def test_table_update_vals_keep_dssm_tpus_bf16_rounding():
    """Under sgd a bf16 gradient is scaled in bf16 by lr rounded to bf16."""
    jc, tc = _cfgs("bfloat16")
    rng = np.random.default_rng(9)
    g = rng.normal(size=(64, 128)).astype(np.float32)
    want = jsparse.table_update_vals(
        jc, jnp.asarray(g).astype(jnp.bfloat16), None)
    got = tsparse.table_update_vals(
        tc, torch.from_numpy(g).to(torch.bfloat16), None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_table_np(got), _jtable_np(want))
    # and differs from scaling by the unrounded lr
    plain = (-0.1 * torch.from_numpy(g).to(torch.bfloat16).float()).to(
        torch.bfloat16)
    assert not torch.equal(got, plain)


# ---- trajectories (dssm_tpu's own tests, restated for the port) ------------

def _traj_cfg(table_dtype):
    cfg = tcfg.get_preset("tiny")
    return tcfg.validate(cfg.replace(
        tower=cfg.tower.replace(vocab_size=4096, embed_width=64,
                                hidden_dims=(48,), semantic_dim=32,
                                table_dtype=table_dtype),
        data=cfg.data.replace(max_unique=1024, max_unique_rows=256,
                              toy_num_pairs=512, toy_vocab_words=128),
        train=cfg.train.replace(batch_size=64, max_steps=60,
                                learning_rate=0.05)))


def _toy_batches(cfg, n_batches, group, seed=0):
    pairs = make_toy_pairs(cfg.data.toy_num_pairs,
                           vocab_words=cfg.data.toy_vocab_words, seed=seed)
    hashed_ = hash_pairs(pairs, cfg.tower, cfg.data)
    rng = np.random.default_rng(seed)
    return [select_batch(
        hashed_, rng.choice(cfg.data.toy_num_pairs, cfg.train.batch_size,
                            replace=False),
        dedup_unique=cfg.data.max_unique, dedup_group=group,
        dedup_unique_rows=cfg.data.max_unique_rows)
        for _ in range(n_batches)]


def test_bf16_tracks_f32_trajectory():
    """Same data, same seeds: the bf16 + stochastic-rounding run's loss
    tracks the f32 run's (dssm_tpu's margins), through the per-side branch
    on a shared table (two scatters a step)."""
    losses = {}
    for td, group in (("", 8), ("bfloat16", 16)):
        cfg = _traj_cfg(td)
        params = tbase.init_params(cfg.tower, seed=0, device="cpu")
        table0 = params["shared"]["W0"].clone()
        state = tstate.create_run_state(cfg, params)
        step = make_train_step(cfg)
        ls = []
        for b in _toy_batches(cfg, 30, group):
            state, aux = step(state, bridge.batch_to_torch(b, "cpu"))
            ls.append(float(aux["loss"]))
        losses[td or "f32"] = ls
        table = state.params["shared"]["W0"]
        assert table.dtype == table0.dtype and not torch.equal(table, table0)
    f32, bf16 = np.array(losses["f32"]), np.array(losses["bfloat16"])
    rel = np.abs(f32 - bf16) / np.maximum(np.abs(f32), 1e-3)
    assert rel[:5].max() < 0.15, rel[:5]
    assert bf16[-10:].mean() < 1.4 * f32[-10:].mean() + 0.1
    assert bf16[-5:].mean() < 0.5 * bf16[:5].mean()


def test_int8_training_learns_and_tracks_f32():
    """The int8 run learns (in-batch recall far above chance) and lands near
    the f32 trajectory (dssm_tpu's margins); the scale passes through."""
    finals = {}
    for td in ("", "int8"):
        cfg = tcfg.validate(tcfg.RunConfig(
            tower=tcfg.TowerConfig(vocab_size=16384, embed_width=32,
                                   hidden_dims=(24,), semantic_dim=16,
                                   table_dtype=td),
            data=tcfg.DataConfig(max_trigrams=32, max_unique=2048,
                                 max_unique_rows=512),
            train=tcfg.TrainConfig(batch_size=64, learning_rate=0.1)))
        hashed_ = hash_pairs(make_toy_pairs(512, vocab_words=64, seed=5),
                             cfg.tower, cfg.data)
        it = batch_iterator(
            hashed_, 64, seed=1, dedup_unique=cfg.data.max_unique,
            dedup_group=32 if td else 8,
            dedup_unique_rows=cfg.data.max_unique_rows, dedup_joint=True)
        params = tbase.init_params(cfg.tower, seed=0, device="cpu")
        scale0 = params["shared"].get("W0_scale")
        metrics = []
        state = train(cfg, tstate.create_run_state(cfg, params), it, 150,
                      metrics_cb=lambda i, m: metrics.append(m))
        finals[td] = metrics[-1]
        if td == "int8":
            assert state.params["shared"]["W0"].dtype == torch.int8
            assert state.params["shared"]["W0_scale"] is scale0
    assert finals["int8"]["in_batch_recall@1"] > 0.5
    assert finals["int8"]["loss"] < finals[""]["loss"] * 1.5 + 0.5


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_low_precision_checkpoint_round_trip(hashed, tmp_path, table_dtype):
    """A state with a bf16 table, or an int8 table and its scale, saves and
    restores bit-equal and continues to the same result."""
    _, tc = _cfgs(table_dtype)
    params = tbase.init_params(tc.tower, seed=2, device="cpu")
    batches = _batches(hashed, tc, 4)
    state = train(tc, tstate.create_run_state(tc, params), iter(batches[:2]),
                  2)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state.step, state)
    restored = ckpt.restore(device="cpu")
    assert restored.step == 2
    assert set(restored.params["shared"]) == set(state.params["shared"])
    for k, v in state.params["shared"].items():
        r = restored.params["shared"][k]
        assert r.dtype == v.dtype and torch.equal(r, v), k
    step = make_train_step(tc)
    a, b = restored, state
    for batch in batches[2:]:  # the seed is the step, which came back too
        a, _ = step(a, bridge.batch_to_torch(batch, "cpu"))
        b, _ = step(b, bridge.batch_to_torch(batch, "cpu"))
    for k, v in a.params["shared"].items():
        assert torch.equal(v, b.params["shared"][k]), k
    assert sublane_group(a.params["shared"]["W0"].dtype) == GROUP[table_dtype]
