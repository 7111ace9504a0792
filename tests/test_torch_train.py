"""The training slice of dssm_tpu_torch against dssm_tpu on the CPU: from the
same TrainState (bridge.state_from_jax) and the same batches, N steps of
make_sparse_train_step give the same loss per step, dense parameters and
table; the dense optimizers follow optax; table_update_vals follows
dssm_tpu's.

Tolerances. f32 compute against dssm_tpu's XLA path: 1e-5 (sums in another
order); 1e-4 with adam or row-wise AdaGrad, which rescale a gradient to the
size of the learning rate whatever its own size, so an entry whose gradient
is f32 cancellation noise moves by that noise times lr / sqrt(eps). bf16 compute against dssm_tpu's Pallas kernels in interpret mode:
loss 1e-2, in-batch recall two rows of the batch, parameters 2e-3 after five
steps at lr 0.1 (a bf16 rounding of an activation or a gradient falls to the
neighbouring value where the f32 sums differ in their last bits; measured
gaps are about a third of these).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.kernels.pallas_gather import force_interpret
from dssm_tpu.models import base as jbase
from dssm_tpu.train import sparse_update as jsparse
from dssm_tpu.train import state as jstate
from dssm_tpu.train.loop import add_rotation_offsets as j_add_rot
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.io.checkpoint import Checkpointer
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import sparse_update as tsparse
from dssm_tpu_torch.train import state as tstate
from dssm_tpu_torch.train.loop import (
    add_rotation_offsets, make_train_step, rotation_offsets, train)

BATCH, STEPS = 128, 5


def _cfgs(compute_dtype="float32", shared=True, loss_mode="in_batch",
          optimizer="sgd", table_optimizer="sgd"):
    kw = dict(
        tower=dict(vocab_size=2048, embed_width=100, hidden_dims=(64,),
                   semantic_dim=32, compute_dtype=compute_dtype,
                   shared_weights=shared),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_unique=1024,
                  max_unique_rows=128),
        loss=dict(mode=loss_mode, num_negatives=20),
        train=dict(batch_size=BATCH, optimizer=optimizer,
                   table_optimizer=table_optimizer, learning_rate=0.1),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            loss=m.LossConfig(**kw["loss"]), train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


@pytest.fixture(scope="module")
def hashed():
    _, tc = _cfgs()
    return hash_pairs(make_toy_pairs(640, 96, 7), tc.tower, tc.data)


def _batches(hashed, tc, n):
    it = batch_iterator(
        hashed, BATCH, seed=3, dedup_unique=tc.data.max_unique,
        dedup_unique_rows=tc.data.max_unique_rows,
        dedup_joint=tc.tower.shared_weights, wire_compress=True,
        sort_rows=tc.loss.mode != "rotate")
    return [add_rotation_offsets(next(it), tc, i) for i in range(n)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _states(jc, tc):
    jstate_ = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    tstate_ = bridge.state_from_jax(
        int(jstate_.step), _np_tree(jstate_.params),
        _np_tree(jstate_.opt_state), tc, "cpu")
    return jstate_, tstate_


# (compute dtype, shared weights = joint branch, loss, dssm_tpu impl,
#  dense optimizer, table optimizer, loss tol, param tol)
CASES = [
    ("float32", True, "in_batch", "xla", "sgd", "sgd", 1e-5, 1e-5),
    ("float32", False, "in_batch", "xla", "sgd", "sgd", 1e-5, 1e-5),
    ("float32", True, "rotate", "xla", "sgd", "sgd", 1e-5, 1e-5),
    ("float32", True, "in_batch", "xla", "adam", "adagrad", 1e-5, 1e-4),
    ("float32", False, "in_batch", "xla", "momentum", "adagrad", 1e-5, 1e-4),
    ("bfloat16", True, "in_batch", "pallas", "sgd", "sgd", 1e-2, 2e-3),
    ("bfloat16", False, "in_batch", "pallas", "sgd", "sgd", 1e-2, 2e-3),
    ("bfloat16", True, "rotate", "pallas", "sgd", "sgd", 1e-2, 2e-3),
]


@pytest.mark.parametrize(
    "dtype,shared,mode,jimpl,opt,topt,loss_tol,param_tol", CASES,
    ids=[f"{c[0]}-{'joint' if c[1] else 'per_side'}-{c[2]}-{c[4]}-{c[5]}"
         for c in CASES])
def test_train_steps_match_dssm_tpu(hashed, dtype, shared, mode, jimpl, opt,
                                    topt, loss_tol, param_tol):
    jc, tc = _cfgs(dtype, shared, mode, opt, topt)
    batches = _batches(hashed, tc, STEPS)
    assert ("uniq" in batches[0]) == shared
    js, ts = _states(jc, tc)
    table0 = {k: v["W0"].clone() for k, v in ts.params.items()}
    jstep = jax.jit(jsparse.make_sparse_train_step_body(jc, jimpl))
    tstep = make_train_step(tc)
    touched = {k: np.zeros((2048,), bool) for k in ts.params}
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
        for tower in touched:
            sides = {"shared": "qd", "query": "q", "doc": "d"}[tower]
            for key in (["uniq"] if shared else [f"{s}_uniq" for s in sides]):
                g = batch[key][batch[key] < 2048 // 8]
                touched[tower][(g[:, None] * 8 + np.arange(8)).reshape(-1)] = 1
    got = bridge.params_to_numpy(ts.params)
    want = _np_tree(js.params)
    for tower, tp in want.items():
        for k, w in tp.items():
            np.testing.assert_allclose(
                got[tower][k], np.asarray(w, np.float32), rtol=0,
                atol=param_tol, err_msg=f"{tower}/{k}")
        # Rows of no gathered group keep their bits; the table moved.
        rest = ~touched[tower]
        assert rest.any() and touched[tower].any()
        np.testing.assert_array_equal(got[tower]["W0"][rest],
                                      table0[tower].numpy()[rest])
        assert np.abs(got[tower]["W0"] - table0[tower].numpy()).max() > 1e-4
    if opt == "adam":
        assert ts.opt_state["count"] == STEPS
        jmu = _np_tree(bridge.optax_field(js.opt_state, "mu"))
        for tower, tp in jmu.items():
            for k, w in tp.items():
                np.testing.assert_allclose(ts.opt_state["mu"][tower][k].numpy(),
                                           w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_dense_optimizers_match_optax(opt):
    rng = np.random.default_rng(11)
    cfg = tcfg.TrainConfig(optimizer=opt, learning_rate=0.05, momentum=0.9)
    tx = jstate.make_optimizer(jcfg.TrainConfig(
        optimizer=opt, learning_rate=0.05, momentum=0.9))
    p0 = {"shared": {"W1": rng.normal(size=(6, 5)).astype(np.float32),
                     "b1": rng.normal(size=(5,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = tx.init(jp)
    tp = {t: {k: torch.from_numpy(v) for k, v in d.items()}
          for t, d in p0.items()}
    topt = tstate.init_opt_state(cfg, tp)
    for _ in range(3):
        g = {"shared": {"W1": rng.normal(size=(6, 5)).astype(np.float32),
                        "b1": rng.normal(size=(5,)).astype(np.float32)}}
        upd, jopt = tx.update(jax.tree.map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {t: {k: torch.from_numpy(v) for k, v in d.items()}
              for t, d in g.items()}
        tupd, topt = tstate.optimizer_update(cfg, tg, topt)
        tp = tstate.apply_updates(tp, tupd)
        for k in ("W1", "b1"):
            np.testing.assert_allclose(tp["shared"][k].numpy(),
                                       np.asarray(jp["shared"][k]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("topt", ["sgd", "adagrad"])
def test_table_update_vals_match_dssm_tpu(topt):
    jc, tc = _cfgs(table_optimizer=topt)
    rng = np.random.default_rng(12)
    g = rng.normal(size=(64, 128)).astype(np.float32)
    compact = rng.normal(size=(64, 128)).astype(np.float32)
    compact[:, 127] = rng.uniform(0, 2, size=64)  # the accumulator column
    want = np.asarray(jsparse.table_update_vals(jc, jnp.asarray(g),
                                                jnp.asarray(compact)))
    got = tsparse.table_update_vals(tc, torch.from_numpy(g),
                                    torch.from_numpy(compact)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if topt == "adagrad":
        assert not got[:, 100:127].any()  # dead padding stays untouched


def test_sparse_update_predicates_and_refusals():
    jc, tc = _cfgs()
    for opt, topt, sparse in (("sgd", "sgd", True), ("adam", "sgd", True),
                              ("adam", "adagrad", True), ("sgd", "sgd", False)):
        kw = dict(optimizer=opt, table_optimizer=topt,
                  sparse_embed_update=sparse)
        assert (tsparse.uses_sparse_update(tc.replace(train=tc.train.replace(**kw)))
                == jsparse.uses_sparse_update(jc.replace(train=jc.train.replace(**kw))))
    assert tsparse.logical_table_width(tc) == jsparse.logical_table_width(jc)
    # Off the sparse path: the dense-table step, its optimizer state over
    # the whole tree, table included.
    params = tbase.init_params(tc.tower, seed=0, device="cpu")
    for kw in (dict(sparse_embed_update=False),
               dict(optimizer="adam", table_optimizer="sgd")):
        dense_cfg = tc.replace(train=tc.train.replace(**kw))
        assert make_train_step(dense_cfg).__qualname__.startswith(
            "make_dense_train_step")
        dense = tstate.create_run_state(dense_cfg, params)
        if dense_cfg.train.optimizer == "adam":
            assert dense.opt_state["count"] == 0
            for tree in (dense.opt_state["mu"], dense.opt_state["nu"]):
                assert {t: sorted(tp) for t, tp in tree.items()} == {
                    t: sorted(tp) for t, tp in params.items()}
                assert tree["shared"]["W0"].shape == params["shared"][
                    "W0"].shape
        else:
            assert dense.opt_state == {}
    state = tstate.create_run_state(tc, params)
    assert state.step == 0 and state.opt_state == {}
    raw = {"q_idx": torch.zeros((4, 8), dtype=torch.int32),
           "q_wgt": torch.zeros((4, 8)),
           "d_idx": torch.zeros((4, 16), dtype=torch.int32),
           "d_wgt": torch.zeros((4, 16))}
    # A raw-index batch, once refused, takes the raw branch: the table
    # moves nowhere for all-zero weights; AdaGrad still needs dedupe.
    w0 = state.params["shared"]["W0"].clone()
    raw_state, aux = make_train_step(tc)(state, raw)
    assert raw_state.step == 1 and np.isfinite(float(aux["loss"]))
    assert torch.equal(raw_state.params["shared"]["W0"], w0)
    ada = tc.replace(train=tc.train.replace(table_optimizer="adagrad"))
    with pytest.raises(ValueError, match="adagrad"):
        make_train_step(ada)(raw_state, raw)
    # A bf16 table takes the stochastic-rounding scatter: a zero update
    # leaves it bit-identical, a sentinel slot touches nothing.
    bf16 = torch.full((32, 128), 0.3, dtype=torch.bfloat16)
    out = tsparse.apply_table_update(
        bf16, torch.tensor([1, 1 << 25], dtype=torch.int32),
        torch.zeros((32, 128)), seed=0)
    assert out is bf16 and torch.equal(
        bf16, torch.full((32, 128), 0.3, dtype=torch.bfloat16))


def test_rotation_offsets_are_dssm_tpus():
    from dssm_tpu.oracle.numpy_oracle import rotation_offsets as j_offsets

    for b, neg, seed in ((128, 20, 0), (64, 50, 9)):
        np.testing.assert_array_equal(rotation_offsets(b, neg, seed),
                                      j_offsets(b, neg, seed))
    jc, tc = _cfgs(loss_mode="rotate")
    batch = {"q_wgt": np.zeros((BATCH, 8), np.float32)}
    np.testing.assert_array_equal(
        add_rotation_offsets(batch, tc, 4)["rot_offsets"],
        j_add_rot(batch, jc, 4)["rot_offsets"])


def test_train_loop_checkpoint_round_trip(hashed, tmp_path):
    """train() drives the stream; a saved state restores bit-identically
    and continues to the same result as an uninterrupted run."""
    _, tc = _cfgs(optimizer="adam", table_optimizer="adagrad")
    params = tbase.init_params(tc.tower, seed=2, device="cpu")
    logged = []
    state = train(tc, tstate.create_run_state(tc, params),
                  iter(_batches(hashed, tc, 4)), 4,
                  metrics_cb=lambda i, aux: logged.append((i, aux["loss"])))
    assert state.step == 4 and logged[0][0] == 0
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for step in (2, 3, 4):
        ckpt.save(step, state)
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    restored = ckpt.restore(device="cpu")
    assert restored.step == 4 and restored.opt_state["count"] == 4
    for tower, tp in state.params.items():
        for k, v in tp.items():
            assert torch.equal(restored.params[tower][k], v)
    more = _batches(hashed, tc, 6)[4:]
    a = train(tc, restored, iter(more), 2)
    b = train(tc, state, iter(more), 2)
    for k, v in a.params["shared"].items():
        assert torch.equal(v, b.params["shared"][k])
    assert Checkpointer(str(tmp_path / "empty")).restore(device="cpu") is None
