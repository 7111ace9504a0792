"""The compiled train step's parts on the CPU, where its bodies run eagerly
(the graphs themselves run only on the card: tests/test_torch_cuda.py).

- The stochastic-rounding scatters seeded by a device int32 (what the step
  computes from its device counter) draw bit for bit the stream of the same
  int seed.
- Adam over a device count follows optax's adam for 24 steps.
- Each step body, run eagerly in place from dssm_tpu's state, against
  dssm_tpu's step (jitted; op by op on bf16 and int8 tables, as
  tests/test_torch_lowprec.py runs it): the `tiny` preset's tower on f32,
  bf16 and int8 joint steps and an f32 per-side step, cnn and lstm dedupe
  and raw steps, and the dense-table step with sgd and adam.
- The in-place optimizer update bit-equal to the functional one.
- A batch's wire block copied into a static block and widened bit-equal to
  batch_to_torch.
- K bodies a call bit-equal to K single steps.
- A checkpoint of the earlier format, whose step and adam count are ints,
  restored into device counters and continued.

Sizes: the `tiny` tower (embed 300, hidden 300, semantic 128) with its vocab
cut to 4096 rows (a whole number of 16- and 32-row groups), batch 32; cnn /
lstm at embed 40, conv 3 x 40, LSTM 32, 4 words x 4 trigrams.

Tolerances, f32 compute throughout (those of test_torch_train.py and
test_torch_seq_train.py): loss, aux and parameters 1e-5 against dssm_tpu
(sums in another order); 1e-4 under adam, which moves an entry whose
gradient is f32 noise by up to lr. A bf16 or int8 table element within one
grid step (the two packages round with different random streams: Philox
here, threefry there; a bf16 step counted on the grid of the largest of the
old and the two new values, as test_torch_lowprec.py counts AdaGrad's). Adam against optax:
rtol 1e-6 (the bias correction's f32 pow is XLA's on one side and the C
library's on the other, an ulp apart). Everything within the port: bit
for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.models import base as jbase
from dssm_tpu.train import loop as jloop
from dssm_tpu.train import sparse_update as jsparse
from dssm_tpu.train import state as jstate
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.io.checkpoint import CHECKPOINT_DIR, Checkpointer
from dssm_tpu_torch.kernels.scatter_sr import (
    scatter_sr_int8_row_groups, scatter_sr_row_groups)
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import state as tstate
from dssm_tpu_torch.train.compiled import CompiledStep, state_tensors
from dssm_tpu_torch.train.loop import (
    make_eager_train_step, make_multi_train_step, make_train_step,
    make_train_step_body, stack_batches)
from dssm_tpu_torch.train.sparse_update import scatter_seed

BATCH, V, STEPS = 32, 4096, 2
GROUP = {"float32": 8, "bfloat16": 16, "int8": 32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch="mlp", table_dtype="float32", branch="joint",
          optimizer="sgd", sparse=True):
    tiny = tcfg.get_preset("tiny").tower
    if arch == "mlp":
        tower = dict(embed_width=tiny.embed_width,
                     hidden_dims=tiny.hidden_dims,
                     semantic_dim=tiny.semantic_dim)
    else:
        tower = dict(embed_width=40, hidden_dims=(48,), conv_window=3,
                     conv_channels=40, lstm_hidden=32, semantic_dim=32)
    kw = dict(
        tower=dict(arch=arch, vocab_size=V, compute_dtype="float32",
                   table_dtype=table_dtype, shared_weights=branch != "per_side",
                   **tower),
        data=dict(max_trigrams=16, max_trigrams_query=8, max_words=4,
                  max_trigrams_per_word=4, max_unique=1024,
                  max_unique_rows=256, dedup_lookup=branch != "raw"),
        train=dict(batch_size=BATCH, optimizer=optimizer,
                   learning_rate=0.01 if optimizer == "adam" else 0.1,
                   sparse_embed_update=sparse),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]), data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


@pytest.fixture(scope="module")
def pairs():
    return make_toy_pairs(320, 96, 7)


def _batches(pairs, tc, n=STEPS):
    seq = tc.tower.is_sequence_model
    dedup = tc.data.dedup_lookup
    it = batch_iterator(
        hash_pairs(pairs, tc.tower, tc.data), BATCH, seq, seed=3,
        dedup_unique=tc.data.max_unique if dedup else None,
        dedup_group=GROUP[tc.tower.table_dtype_resolved],
        dedup_unique_rows=tc.data.max_unique_rows,
        dedup_joint=tc.tower.shared_weights,
        wire_compress=dedup and not seq, sort_rows=dedup and not seq)
    return [next(it) for _ in range(n)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(js, tc):
    return bridge.state_from_jax(int(js.step), _np(js.params),
                                 _np(js.opt_state), tc, "cpu")


def _grid_gap(a: np.ndarray, b: np.ndarray, old: np.ndarray) -> np.ndarray:
    """|a - b| in grid steps of two updates of one table: int8 levels; for
    bf16, ulps of the largest of the old and the two new values, the grid
    the sum was formed on (a hot row's update can carry a weight into a far
    finer binade, where the gradient's own bf16 rounding, tipped by f32
    sums in another order, spans several of the new ulps)."""
    if a.dtype == np.int8:
        return np.abs(a.astype(np.int64) - b.astype(np.int64))
    x, y, z = ((v.astype(np.uint32) << 16).view(np.float32)
               for v in (a, b, old))
    big = np.maximum(np.maximum(np.abs(x), np.abs(y)), np.abs(z))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    return np.abs(x - y) / ulp


def _table_bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.numpy() if t.dtype == torch.int8 else t.view(
            torch.int16).numpy().view(np.uint16)
    a = np.asarray(t)
    return a if a.dtype == np.int8 else a.view(np.uint16)


def _clone_state(s: tstate.TrainState) -> tstate.TrainState:
    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else t.clone())
    return tstate.TrainState(step=s.step.clone(), params=tree(s.params),
                             opt_state=tree(s.opt_state),
                             host_step=s.host_step)


def _states_equal(a, b):
    for x, y in zip(state_tensors(a), state_tensors(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.host_step == b.host_step == int(a.step)


@pytest.mark.parametrize("kind,seed", [
    ("bf16", 0), ("bf16", -7), ("bf16", 2 ** 31 - 1), ("int8", 12345),
    ("int8", -(2 ** 31))])
def test_device_seed_scatters_bit_equal_to_int_seed(kind, seed):
    rng = np.random.default_rng(3)
    group = 16 if kind == "bf16" else 32
    fn = scatter_sr_row_groups if kind == "bf16" else \
        scatter_sr_int8_row_groups
    if kind == "bf16":
        table = torch.from_numpy(rng.normal(size=(512, 64)).astype(
            np.float32)).to(torch.bfloat16)
        vals = rng.normal(size=(4 * group, 64)) * 1e-2
    else:
        table = torch.from_numpy(rng.integers(-100, 101, size=(512, 64),
                                              dtype=np.int8))
        vals = rng.uniform(-3, 3, size=(4 * group, 64))
    vals = torch.from_numpy(vals.astype(np.float32))
    gids = torch.tensor([3, 0, 1 << 25, 512 // group - 1], dtype=torch.int32)
    want = fn(table.clone(), gids, vals, group, seed)
    for dev_seed in (torch.tensor(seed, dtype=torch.int32),
                     torch.tensor([seed], dtype=torch.int32)):
        assert torch.equal(fn(table.clone(), gids, vals, group, dev_seed),
                           want)
    other = fn(table.clone(), gids, vals, group, seed + 1)
    assert not torch.equal(other, want)
    # The train step's seeds, step * 4 + the scatter's index, as dssm_tpu's.
    step = torch.tensor(seed // 8, dtype=torch.int32)
    for ix in range(3):
        s = scatter_seed(step, ix)
        assert s.dtype == torch.int32 and int(s) == (seed // 8) * 4 + ix


def test_adam_device_count_follows_optax():
    rng = np.random.default_rng(11)
    cfg = tcfg.TrainConfig(optimizer="adam", learning_rate=0.05)
    tx = jstate.make_optimizer(jcfg.TrainConfig(optimizer="adam",
                                                learning_rate=0.05))
    p0 = {"shared": {"W1": rng.normal(size=(6, 5)).astype(np.float32),
                     "b1": rng.normal(size=(5,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = tx.init(jp)
    tp = {t: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
          for t, d in p0.items()}
    topt = tstate.init_opt_state(cfg, tp)
    assert topt["count"].dtype == torch.int32 and topt["count"].dim() == 0
    for i in range(24):
        g = {"shared": {k: rng.normal(size=v.shape).astype(np.float32)
                        for k, v in p0["shared"].items()}}
        upd, jopt = tx.update(jax.tree.map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tstate.optimizer_step_(cfg, tp, {t: {k: torch.from_numpy(v) for k, v
                                             in d.items()}
                                         for t, d in g.items()}, topt)
        assert int(topt["count"]) == i + 1
        for k in p0["shared"]:
            np.testing.assert_allclose(tp["shared"][k].numpy(),
                                       np.asarray(jp["shared"][k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i} {k}")
            np.testing.assert_allclose(
                topt["mu"]["shared"][k].numpy(),
                np.asarray(jopt[0].mu["shared"][k]), rtol=1e-6, atol=1e-7)


# (arch, table dtype, branch, dense optimizer, sparse table updates)
BODY_CASES = [
    ("mlp", "float32", "joint", "sgd", True),
    ("mlp", "bfloat16", "joint", "sgd", True),
    ("mlp", "int8", "joint", "sgd", True),
    ("mlp", "float32", "per_side", "sgd", True),
    ("cnn", "float32", "joint", "sgd", True),
    ("cnn", "float32", "raw", "sgd", True),
    ("lstm", "float32", "joint", "sgd", True),
    ("lstm", "float32", "raw", "sgd", True),
    ("mlp", "float32", "raw", "sgd", False),   # the dense-table step
    ("mlp", "float32", "raw", "adam", False),  # ... under adam
]


@pytest.mark.parametrize(
    "arch,table_dtype,branch,opt,sparse", BODY_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}" + ("" if c[4] else f"-dense-{c[3]}")
         for c in BODY_CASES])
def test_step_bodies_match_dssm_tpu(pairs, arch, table_dtype, branch, opt,
                                    sparse):
    """Each step from dssm_tpu's own state: the body updates the port's
    state in place and reads nothing back."""
    jc, tc = _cfgs(arch, table_dtype, branch, opt, sparse)
    batches = _batches(pairs, tc)
    assert ("uniq" in batches[0]) == (branch == "joint")
    assert ("q_uniq" in batches[0]) == (branch == "per_side")
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    jbody = (jsparse.make_sparse_train_step_body(jc, "xla") if sparse
             else jloop.make_train_step_body(jc, "xla"))
    if table_dtype == "float32":
        jbody = jax.jit(jbody)  # bf16 / int8: op by op (test_torch_lowprec)
    body = make_train_step_body(tc)
    key = tbase.TABLE_KEY[arch]
    tol = 1e-4 if opt == "adam" else 1e-5
    for i, batch in enumerate(batches):
        ts = _port_state(js, tc)
        ptrs = [t.data_ptr() for t in state_tensors(ts)]
        before = {t: _table_bits(tp[key]).copy()
                  for t, tp in ts.params.items()}
        js, jaux = jbody(js, {k: jnp.asarray(v) for k, v in batch.items()})
        taux = body(ts, bridge.batch_to_torch(batch, "cpu"))
        assert [t.data_ptr() for t in state_tensors(ts)] == ptrs
        assert int(ts.step) == int(js.step) == i + 1
        if opt == "adam":
            assert int(ts.opt_state["count"]) == i + 1
        for k in ("loss", "in_batch_recall@1", "pos_cos"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=0,
                                       atol=tol, err_msg=f"step {i} {k}")
        for tower, tp in _np(js.params).items():
            for k, w in tp.items():
                got = ts.params[tower][k]
                if k == key and table_dtype != "float32":
                    gap = _grid_gap(_table_bits(got), _table_bits(w),
                                    before[tower])
                    assert gap.max() <= 1, f"step {i}: {gap.max()} steps"
                    assert (_table_bits(got) != before[tower]).any()
                    continue
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(w, np.float32), rtol=0,
                                           atol=tol,
                                           err_msg=f"step {i} {tower}/{k}")


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_in_place_update_bit_equal_to_functional(opt):
    rng = np.random.default_rng(5)
    cfg = tcfg.TrainConfig(optimizer=opt, learning_rate=0.05, momentum=0.9)
    shapes = {"W0": (7, 9), "b0": (9,), "Wq": (9, 3)}
    params = {"shared": {k: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)) for k, s in shapes.items()}}
    params["shared"]["Wq"] = params["shared"]["Wq"].to(torch.bfloat16)
    fparams = {t: {k: v.clone() for k, v in tp.items()}
               for t, tp in params.items()}
    opt_state = tstate.init_opt_state(cfg, params)
    fopt = {k: (v.clone() if isinstance(v, torch.Tensor) else
                tstate.tree_map(torch.clone, v)) for k, v in opt_state.items()}
    for _ in range(4):
        # Each gradient in its parameter's dtype, as autograd gives it.
        grads = {"shared": {k: torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).to(params["shared"][k].dtype)
            for k, s in shapes.items()}}
        updates, fopt = tstate.optimizer_update(cfg, grads, fopt)
        fparams = tstate.apply_updates(fparams, updates)
        ptrs = [v.data_ptr() for v in params["shared"].values()]
        tstate.optimizer_step_(cfg, params, grads, opt_state)
        assert [v.data_ptr() for v in params["shared"].values()] == ptrs
        for k in shapes:
            assert params["shared"][k].dtype == fparams["shared"][k].dtype
            assert torch.equal(params["shared"][k], fparams["shared"][k]), k
        for name, tree in opt_state.items():
            if name == "count":
                assert torch.equal(tree, fopt["count"])
                continue
            for k in shapes:
                assert torch.equal(tree["shared"][k], fopt[name]["shared"][k])


@pytest.mark.parametrize("kind", ["joint", "per_side", "raw", "seq",
                                  "stacked", "rotate"])
def test_static_block_fill_bit_equal_to_batch_to_torch(pairs, kind):
    arch = "cnn" if kind == "seq" else "mlp"
    _, tc = _cfgs(arch, branch={"per_side": "per_side",
                                "raw": "raw"}.get(kind, "joint"))
    batches = _batches(pairs, tc, 3)
    batch = stack_batches(batches) if kind == "stacked" else batches[0]
    if kind == "rotate":
        batch = dict(batch, rot_offsets=np.arange(1, 16, dtype=np.int32))
    want = bridge.batch_to_torch(batch, "cpu", vocab_size=V)
    wire = bridge.batch_to_device(batch, "cpu", vocab_size=V)
    static = torch.full((wire.nbytes,), 0xAB, dtype=torch.uint8)
    wire.copy_to(static)
    for got in (wire.fields(static), wire.fields(),
                bridge.pack_fields(want).fields()):
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    # The signature: the same layout for the stream's next batch of the
    # same shapes, another for another K.
    same = bridge.batch_to_device(
        stack_batches(batches) if kind == "stacked" else
        dict(batches[1], **({"rot_offsets": batch["rot_offsets"]}
                            if kind == "rotate" else {})), "cpu")
    if kind != "raw" and kind != "seq":
        assert same.layout == wire.layout
    if kind == "stacked":
        two = bridge.batch_to_device(stack_batches(batches[:2]), "cpu")
        assert two.layout != wire.layout


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_k_bodies_a_call_bit_equal_to_single_steps(pairs, table_dtype):
    """One call of make_multi_train_step (K = 3 bodies; on the card one
    graph) against three calls of make_train_step and three eager steps,
    from one state: the same state bit for bit (the bf16 table's scatter
    seeds from each body's own device counter), the aux stacked."""
    _, tc = _cfgs("mlp", table_dtype)
    batches = _batches(pairs, tc, 3)
    state0 = tstate.create_run_state(tc, tbase.init_params(tc.tower, seed=2,
                                                           device="cpu"))
    multi, single = _clone_state(state0), _clone_state(state0)
    eager = _clone_state(state0)
    multi, auxes = make_multi_train_step(tc)(
        multi, bridge.batch_to_device(stack_batches(batches), "cpu"))
    step, eager_step = make_train_step(tc), make_eager_train_step(tc)
    singles = []
    for b in batches:
        single, aux = step(single, bridge.batch_to_torch(b, "cpu"))
        eager, _ = eager_step(eager, bridge.batch_to_torch(b, "cpu"))
        singles.append(aux)
    _states_equal(multi, single)
    _states_equal(single, eager)
    assert int(multi.step) == multi.host_step == 3
    for k, v in auxes.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([a[k] for a in singles])), k
    assert not torch.equal(multi.params["shared"]["W0"],
                           state0.params["shared"]["W0"])


def test_compiled_step_is_the_body_on_the_cpu(pairs):
    """On a CPU state the compiled step is its body run eagerly, in place:
    the same object back, its tensors where they were; the routing name is
    the body's."""
    _, tc = _cfgs("mlp")
    step = make_train_step(tc)
    assert isinstance(step, CompiledStep)
    assert step.__qualname__.startswith("make_sparse_train_step_body")
    state = tstate.create_run_state(tc, tbase.init_params(tc.tower, seed=0,
                                                          device="cpu"))
    ptrs = [t.data_ptr() for t in state_tensors(state)]
    table0 = state.params["shared"]["W0"].clone()
    w1 = state.params["shared"]["W1"].clone()
    out, aux = step(state, bridge.batch_to_device(_batches(pairs, tc, 1)[0],
                                                  "cpu"))
    assert out is state and step.num_graphs == 0
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    assert state.host_step == int(state.step) == 1
    assert np.isfinite(float(aux["loss"]))
    assert not torch.equal(state.params["shared"]["W0"], table0)
    assert not torch.equal(state.params["shared"]["W1"], w1)


def test_earlier_checkpoint_format_restores_into_device_counters(
        pairs, tmp_path):
    """A checkpoint whose step and adam count are ints (the format the
    port wrote before its counters lived on the device) restores into
    int32 device counters and continues as the saved state does; a new
    checkpoint stores them as tensors."""
    _, tc = _cfgs("mlp", optimizer="adam", branch="joint")
    tc = tc.replace(train=tc.train.replace(table_optimizer="adagrad"))
    batches = _batches(pairs, tc, 3)
    state = tstate.create_run_state(tc, tbase.init_params(tc.tower, seed=4,
                                                          device="cpu"))
    step = make_train_step(tc)
    for b in batches[:2]:
        state, _ = step(state, bridge.batch_to_torch(b, "cpu"))
    os.makedirs(tmp_path / CHECKPOINT_DIR)
    cpu = lambda t: t.detach().clone()  # noqa: E731
    torch.save({"step": 2,
                "params": {t: {k: cpu(v) for k, v in tp.items()}
                           for t, tp in state.params.items()},
                "opt_state": {"count": 2,
                              "mu": tstate.tree_map(cpu, state.opt_state["mu"]),
                              "nu": tstate.tree_map(cpu, state.opt_state["nu"])}},
               tmp_path / CHECKPOINT_DIR / "step_2.pt")
    old = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert old.step.dtype == torch.int32 and old.step.dim() == 0
    assert old.opt_state["count"].dtype == torch.int32
    assert old.host_step == int(old.step) == int(old.opt_state["count"]) == 2
    _states_equal(old, state)
    old, aux_old = make_train_step(tc)(old, bridge.batch_to_torch(batches[2],
                                                                  "cpu"))
    state, aux = step(state, bridge.batch_to_torch(batches[2], "cpu"))
    _states_equal(old, state)
    assert torch.equal(aux_old["loss"], aux["loss"])
    Checkpointer(str(tmp_path)).save(3, state)
    payload = torch.load(tmp_path / CHECKPOINT_DIR / "step_3.pt",
                         weights_only=True)
    assert payload["step"].dtype == torch.int32 and int(payload["step"]) == 3
    assert int(payload["opt_state"]["count"]) == 3
    _states_equal(Checkpointer(str(tmp_path)).restore(device="cpu"), state)
