"""The dense-table train step of dssm_tpu_torch against dssm_tpu on the CPU:
off the sparse path (train.sparse_embed_update=False, or momentum / adam
with the sgd table optimizer) the step differentiates the whole parameter
tree, table included, and runs the dense optimizer over all of it. From the
same TrainState (bridge.state_from_jax) and the same raw-index batches,
three steps give the same loss, parameters and optimizer state as
dssm_tpu's dense step (make_train_step_body, impl="xla"), for the mlp, cnn
and lstm towers, shared and separate, with sgd, momentum and adam. The
dense step also matches the port's sparse step (the port's copy of
dssm_tpu's test_sparse_step_matches_dense_step), train.remat matches no
remat, and a dense adam state carried across from dssm_tpu saves, restores
and continues as dssm_tpu continues it.

Sizes: vocab 4096, embed 40, hidden 48, T = 4 words x Kw = 4 trigrams, conv
3 x 40, LSTM E 40 / H 32, semantic 32, batch 32, lr 0.1 (adam 0.01).

Tolerances, f32 compute throughout. Against dssm_tpu: 1e-5 (sums in
another order: the table gradient is a segment sum over the batch's
lookups in either package, in another order); adam 1e-4, for the
parameters and the losses of the steps after the first, because adam
rescales each gradient to the size of the learning rate whatever its own
size: an entry whose gradient is f32 cancellation noise moves by up to lr
(2e-5 measured on one or two table entries a run), and the next loss
with it (1.3e-5 measured). Dense against sparse: rtol 1e-4, atol 1e-6, as
dssm_tpu's own test. remat against no remat: 1e-7 (the same operations;
only the order in which autograd accumulates a shared parameter's
gradients may change).
"""

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
from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.io.checkpoint import Checkpointer
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import state as tstate
from dssm_tpu_torch.train.loop import make_train_step
from dssm_tpu_torch.train.sparse_update import make_sparse_train_step

BATCH, STEPS, V = 32, 3, 4096


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch="mlp", shared=True, optimizer="sgd", sparse=False,
          remat=False):
    kw = dict(
        tower=dict(arch=arch, vocab_size=V, embed_width=40, hidden_dims=(48,),
                   conv_window=3, conv_channels=40, lstm_hidden=32,
                   semantic_dim=32, compute_dtype="float32",
                   shared_weights=shared),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_words=4,
                  max_trigrams_per_word=4, dedup_lookup=False),
        train=dict(batch_size=BATCH, optimizer=optimizer,
                   learning_rate=0.01 if optimizer == "adam" else 0.1,
                   sparse_embed_update=sparse, remat=remat),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


@pytest.fixture(scope="module")
def pairs():
    return make_toy_pairs(320, 96, 7)


def _batches(pairs, tc, n):
    it = batch_iterator(hash_pairs(pairs, tc.tower, tc.data), BATCH,
                        tc.tower.is_sequence_model, seed=3)
    return [next(it) for _ in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _states(jc, tc):
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    ts = bridge.state_from_jax(int(js.step), _np(js.params),
                               _np(js.opt_state), tc, "cpu")
    return js, ts


def _close(got, want, atol, what, rtol=0.0):
    """Two {tower: {name: array}} trees, leaf by leaf."""
    assert set(got) == set(want), what
    for tower, tp in want.items():
        assert set(got[tower]) == set(tp), f"{what} {tower}"
        for k, w in tp.items():
            g = got[tower][k]
            g = g.detach().float().numpy() if torch.is_tensor(g) else g
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what} {tower}/{k}")


# (arch, shared towers, optimizer): sgd for every tower and sharing;
# momentum and adam once for each tower, on alternating sharing.
CASES = [(a, s, "sgd") for a in ("mlp", "cnn", "lstm") for s in (True, False)]
CASES += [("mlp", False, "momentum"), ("cnn", True, "momentum"),
          ("lstm", False, "momentum"), ("mlp", True, "adam"),
          ("cnn", False, "adam"), ("lstm", True, "adam")]


@pytest.mark.parametrize("arch,shared,opt", CASES,
                         ids=[f"{a}-{'shared' if s else 'separate'}-{o}"
                              for a, s, o in CASES])
def test_dense_steps_match_dssm_tpu(pairs, arch, shared, opt):
    jc, tc = _cfgs(arch, shared, opt)
    js, ts = _states(jc, tc)
    key = tbase.TABLE_KEY[arch]
    # Off the sparse path the optimizer state covers the table too.
    if opt != "sgd":
        field = "trace" if opt == "momentum" else "mu"
        for tower, tp in ts.params.items():
            assert ts.opt_state[field][tower][key].shape == tp[key].shape
    table0 = {t: tp[key].clone() for t, tp in ts.params.items()}
    jstep = jax.jit(jloop.make_train_step_body(jc, "xla"))
    tstep = make_train_step(tc)
    tol = 1e-4 if opt == "adam" else 1e-5
    batches = _batches(pairs, tc, STEPS)
    assert "q_idx" in batches[0] and "uniq" not in batches[0]
    for i, batch in enumerate(batches):
        js, jaux = jstep(js, batch)
        ts, taux = tstep(ts, bridge.batch_to_torch(batch, "cpu",
                                                   vocab_size=V))
        assert ts.step == int(js.step) == i + 1
        for k in ("loss", "in_batch_recall@1", "pos_cos"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=0, atol=tol,
                                       err_msg=f"step {i} {k}")
    _close(ts.params, _np(js.params), tol, "params")
    for tower, tp in ts.params.items():
        assert (tp[key] - table0[tower]).abs().max() > 1e-4  # it moved
    if opt == "momentum":
        _close(ts.opt_state["trace"],
               _np(bridge.optax_field(js.opt_state, "trace")), tol, "trace")
    if opt == "adam":
        assert ts.opt_state["count"] == STEPS
        for field in ("mu", "nu"):
            _close(ts.opt_state[field],
                   _np(bridge.optax_field(js.opt_state, field)), tol, field)


@pytest.mark.parametrize("arch", ["mlp", "cnn", "lstm"])
@pytest.mark.parametrize("shared", [True, False])
def test_sparse_step_matches_dense_step(pairs, arch, shared):
    """The sparse table update is dense SGD (dssm_tpu's
    test_sparse_step_matches_dense_step): three steps on one batch."""
    _, dense_cfg = _cfgs(arch, shared)
    _, sparse_cfg = _cfgs(arch, shared, sparse=True)
    params = tbase.init_params(dense_cfg.tower, seed=0, device="cpu")
    s_dense = tstate.create_run_state(dense_cfg, params)
    s_sparse = tstate.create_run_state(
        sparse_cfg, {t: {k: v.clone() for k, v in tp.items()}
                     for t, tp in params.items()})
    batch = bridge.batch_to_torch(_batches(pairs, dense_cfg, 1)[0], "cpu")
    step_dense = make_train_step(dense_cfg)
    step_sparse = make_sparse_train_step(sparse_cfg)
    for i in range(3):
        s_dense, a_dense = step_dense(s_dense, batch)
        s_sparse, a_sparse = step_sparse(s_sparse, batch)
        assert abs(float(a_dense["loss"]) - float(a_sparse["loss"])) < 1e-5, i
    _close(s_dense.params,
           {t: {k: v.numpy() for k, v in tp.items()}
            for t, tp in s_sparse.params.items()},
           1e-6, "dense vs sparse", rtol=1e-4)


@pytest.mark.parametrize("arch,opt", [("mlp", "adam"), ("cnn", "sgd"),
                                      ("lstm", "momentum")])
def test_remat_matches_no_remat(pairs, arch, opt, monkeypatch):
    """train.remat recomputes each side's embed in the backward pass: the
    table lookup runs twice a side, and the step's result is unchanged."""
    _, plain_cfg = _cfgs(arch, True, opt)
    _, remat_cfg = _cfgs(arch, True, opt, remat=True)
    lookups = []
    real_lookup = tbase.embed_table_lookup
    monkeypatch.setattr(tbase, "embed_table_lookup",
                        lambda *a, **k: lookups.append(1) or real_lookup(
                            *a, **k))
    states = {}
    batches = [bridge.batch_to_torch(b, "cpu")
               for b in _batches(pairs, plain_cfg, 2)]
    for name, cfg in (("plain", plain_cfg), ("remat", remat_cfg)):
        state = tstate.create_run_state(
            cfg, tbase.init_params(cfg.tower, seed=0, device="cpu"))
        step = make_train_step(cfg)
        lookups.clear()
        for b in batches:
            state, _ = step(state, b)
        assert len(lookups) == (8 if name == "remat" else 4), name
        states[name] = state
    _close(states["remat"].params,
           {t: {k: v.numpy() for k, v in tp.items()}
            for t, tp in states["plain"].params.items()}, 1e-7, "remat")


def test_dense_state_from_dssm_tpu_saves_restores_and_continues(pairs,
                                                                tmp_path):
    """dssm_tpu's dense adam state (moments over the table) after two of its
    steps, carried across, saved and restored, takes the third step as
    dssm_tpu takes it."""
    jc, tc = _cfgs("mlp", True, "adam")
    js, _ = _states(jc, tc)
    jstep = jax.jit(jloop.make_train_step_body(jc, "xla"))
    batches = _batches(pairs, tc, 3)
    for b in batches[:2]:
        js, _ = jstep(js, b)
    ts = bridge.state_from_jax(int(js.step), _np(js.params),
                               _np(js.opt_state), tc, "cpu")
    assert ts.opt_state["count"] == 2
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, ts)
    restored = ckpt.restore(device="cpu")
    assert restored.step == 2 and restored.opt_state["count"] == 2
    for field in ("mu", "nu"):
        for k, v in ts.opt_state[field]["shared"].items():
            assert torch.equal(restored.opt_state[field]["shared"][k], v)
    js, _ = jstep(js, batches[2])
    ts, _ = make_train_step(tc)(restored, bridge.batch_to_torch(batches[2],
                                                                "cpu"))
    _close(ts.params, _np(js.params), 1e-4, "params")
    _close(ts.opt_state["nu"], _np(bridge.optax_field(js.opt_state, "nu")),
           1e-4, "nu")


def test_dense_step_refusals(pairs):
    """The dense step takes raw-index batches of an f32 table; a bf16 table
    off the sparse path is refused where its state is made."""
    _, tc = _cfgs("mlp", True, "adam")
    params = tbase.init_params(tc.tower, seed=0, device="cpu")
    state = tstate.create_run_state(tc, params)
    dedupe = {"uniq": torch.zeros((4,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="raw-index batches"):
        make_train_step(tc)(state, dedupe)
    bf16 = {t: {k: (v.to(torch.bfloat16) if k == "W0" else v)
                for k, v in tp.items()} for t, tp in params.items()}
    with pytest.raises(ValueError, match="f32 table"):
        tstate.create_run_state(tc, bf16)
