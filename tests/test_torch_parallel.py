"""The multi-device path's single-process parts against dssm_tpu on the CPU:
the loader's process shards and per-shard slot spaces bit for bit, the
single-device step on a one-shard slot space (sel_local [1, cap]) against
dssm_tpu's and against the port's own step on the batch before re-slotting,
the parallel step on a mesh of one process against the single-device step,
and the mesh's layout and errors. The spawned ranks are in
tests/test_torch_multidevice.py.

Tolerances: f32 compute against dssm_tpu's XLA path 1e-5 (sums in another
order), as tests/test_torch_train.py; the port against itself bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import loader as jloader
from dssm_tpu.data import toy as jtoy
from dssm_tpu.models import base as jbase
from dssm_tpu.parallel import mesh as jmesh
from dssm_tpu.train import sparse_update as jsparse
from dssm_tpu.train import state as jstate
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import loader as tloader
from dssm_tpu_torch.data import toy as ttoy
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.parallel import dist as tdist
from dssm_tpu_torch.parallel import mesh as tmesh
from dssm_tpu_torch.parallel.train_step import (
    create_sharded_state, gather_tree, make_parallel_train_step,
    param_pspec, shard_tree)
from dssm_tpu_torch.train.loop import make_train_step
from dssm_tpu_torch.train.state import create_run_state

VOCAB, BATCH, CAP = 4096, 64, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _cfgs(table_dtype="float32", max_unique=2048, **train_kw):
    kw = dict(
        tower=dict(vocab_size=VOCAB, embed_width=32, hidden_dims=(24,),
                   semantic_dim=16, table_dtype=table_dtype),
        data=dict(max_trigrams=32, max_trigrams_query=16,
                  max_unique=max_unique, max_unique_rows=512),
        train=dict(batch_size=BATCH, learning_rate=0.1, **train_kw),
    )

    def build(m):
        return m.validate(m.RunConfig(
            tower=m.TowerConfig(**kw["tower"]),
            data=m.DataConfig(**kw["data"]),
            train=m.TrainConfig(**kw["train"])))

    return build(jcfg), build(tcfg)


@pytest.fixture(scope="module")
def hashed():
    jc, tc = _cfgs()
    pairs = jtoy.make_toy_pairs(640, 96, 5)
    return (jloader.hash_pairs(pairs, jc.tower, jc.data),
            tloader.hash_pairs(ttoy.ToyPairs(pairs.queries, pairs.titles),
                               tc.tower, tc.data))


def _joint(h, rows, group=8, max_unique=2048):
    return tloader.select_batch(h, rows, max_unique, group, 512, True)


@pytest.mark.parametrize("shards,cap", [(1, CAP), (2, CAP), (4, CAP),
                                        (2, 48)])
def test_reslot_local_bit_equal(hashed, shards, cap):
    """Both packages' third dedupe level on one joint batch, also where the
    cap drops a shard's rarest slots (cap 48)."""
    _, th = hashed
    batch = _joint(th, np.arange(BATCH))
    got = tloader.reslot_local(batch, cap, shards)
    _assert_batches_equal(got, jloader.reslot_local(dict(batch), cap, shards))
    assert got["sel_local"].shape == (shards, cap)
    if cap == 48:
        assert (got["q_wgt"] != batch["q_wgt"]).any()
    else:
        np.testing.assert_array_equal(got["q_wgt"], batch["q_wgt"])
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        tloader.reslot_local(batch, cap, 3)


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("joint,sequence", [(True, False), (False, False),
                                            (True, True)])
def test_global_dedup_local_batch_bit_equal(impl, joint, sequence):
    """A process's shard with the whole batch's dedupe, the C++ and the
    numpy dedupe alike, equals dssm_tpu's and the whole batch sliced."""
    kw = dict(arch="lstm" if sequence else "mlp", vocab_size=VOCAB)
    dkw = dict(max_words=5, max_trigrams_per_word=6, max_trigrams=32)
    pairs = jtoy.make_toy_pairs(200, 96, 2)
    jh = jloader.hash_pairs(pairs, jcfg.TowerConfig(**kw),
                            jcfg.DataConfig(**dkw))
    th = tloader.hash_pairs(ttoy.ToyPairs(pairs.queries, pairs.titles),
                            tcfg.TowerConfig(**kw), tcfg.DataConfig(**dkw))
    rows = np.random.default_rng(0).permutation(200)[:64]
    whole = tloader.select_batch(th, rows, 1024, 8, 256, joint,
                                 sequence=sequence, impl="plain")
    for lo in (0, 16, 48):
        got = tloader._global_dedup_local_batch(
            th, rows, sequence, 1024, 8, 256, joint, lo, 16, impl=impl)
        _assert_batches_equal(got, jloader._global_dedup_local_batch(
            jh, rows, sequence, 1024, 8, 256, joint, lo, 16))
        _assert_batches_equal(got, {
            k: v if tdist.is_batch_wide(k) else v[lo:lo + 16]
            for k, v in whole.items()})


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_process_shards_bit_equal(hashed, impl):
    """batch_iterator's process shards with per-process slot spaces, sorted
    and compressed as cli.train builds them, equal dssm_tpu's stream; each
    process's [1, cap] slot space is row d of reslot_local over the whole
    unsorted batch, as a one-process-a-GPU mesh needs."""
    jh, th = hashed
    kw = dict(seed=3, dedup_unique=2048, dedup_unique_rows=512,
              dedup_joint=True, local_sel_cap=CAP, local_sel_shards=1)
    for d in range(4):
        for sort in (False, True):
            it = tloader.batch_iterator(th, BATCH, process_index=d,
                                        process_count=4, sort_rows=sort,
                                        wire_compress=sort, impl=impl, **kw)
            jt = jloader.batch_iterator(jh, BATCH, process_index=d,
                                        process_count=4, sort_rows=sort,
                                        wire_compress=sort, **kw)
            for _ in range(2):
                _assert_batches_equal(next(it), next(jt))
    whole_it = tloader.batch_iterator(th, BATCH, seed=3, dedup_unique=2048,
                                      dedup_unique_rows=512, dedup_joint=True)
    whole = tloader.reslot_local(next(whole_it), CAP, 4)
    mesh = tmesh.Mesh(shape={"data": 4, "model": 1},
                      coords={"data": 0, "model": 0}, device="cpu")
    for d in range(4):
        mesh.coords["data"] = d
        shard = next(tloader.batch_iterator(th, BATCH, process_index=d,
                                            process_count=4, **kw))
        _assert_batches_equal(shard, tdist.local_shard(whole, mesh))


def _states(jc, tc):
    js = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=1))
    ts = bridge.state_from_jax(
        int(js.step), jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.opt_state), tc, "cpu")
    return js, ts


def _tables_equal(a, b, atol=0.0):
    for tower in a.params:
        for k, v in a.params[tower].items():
            np.testing.assert_allclose(v.float().numpy(),
                                       b.params[tower][k].float().numpy(),
                                       rtol=0, atol=atol, err_msg=k)


def test_one_shard_slot_space_steps_match_dssm_tpu(hashed):
    """Three steps on batches with one slot space ([1, cap]) against
    dssm_tpu's single-device step on the same batches."""
    jh, th = hashed
    jc, tc = _cfgs()
    it = tloader.batch_iterator(th, BATCH, seed=4, dedup_unique=2048,
                                dedup_unique_rows=512, dedup_joint=True,
                                sort_rows=True, wire_compress=True,
                                local_sel_cap=CAP)
    batches = [next(it) for _ in range(3)]
    assert batches[0]["sel_local"].shape == (1, CAP)
    js, ts = _states(jc, tc)
    jstep = jax.jit(jsparse.make_sparse_train_step_body(jc, "xla"))
    tstep = make_train_step(tc)
    for b in batches:
        js, jaux = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, taux = tstep(ts, bridge.batch_to_torch(b, "cpu"))
        for k in ("loss", "in_batch_recall@1", "pos_cos"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
    got = bridge.params_to_numpy(ts.params)["shared"]
    for k, w in js.params["shared"].items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_one_shard_slot_space_step_matches_global_slots(hashed,
                                                        table_dtype):
    """The step on a batch re-slotted into one slot space is the step on the
    batch before it: the lookups read the same rows and the
    stochastic-rounding scatters draw from the same stream. The plain
    versions sum a lookup over its slots in slot order (a count-matrix
    product), so on the CPU the two orders agree to f32 rounding (on the
    card the kernels sum in lookup order: bit-equal, tests/test_torch_cuda.
    py). A slot space of two shards is refused."""
    _, th = hashed
    group = {"float32": 8, "bfloat16": 16, "int8": 32}[table_dtype]
    _, tc = _cfgs(table_dtype, max_unique=1024)
    batches = [_joint(th, np.arange(i * BATCH, (i + 1) * BATCH), group, 1024)
               for i in range(3)]
    params = tbase.init_params(tc.tower, seed=2, device="cpu")
    a = create_run_state(tc, {t: {k: v.clone() for k, v in tp.items()}
                              for t, tp in params.items()})
    b = create_run_state(tc, params)
    step = make_train_step(tc)
    for batch in batches:
        a, aux_a = step(a, bridge.batch_to_torch(batch, "cpu"))
        b, aux_b = step(b, bridge.batch_to_torch(
            tloader.reslot_local(batch, CAP), "cpu"))
        np.testing.assert_allclose(float(aux_a["loss"]),
                                   float(aux_b["loss"]), rtol=1e-6)
    # A table element rounds to a neighbouring grid value where the f32
    # update differs in its last bit (bf16: 2^-8 of 0.05; int8: a step of
    # the row's grid, scale <= 0.05 * 1.25 / 127 here).
    _tables_equal(a, b, atol={"float32": 1e-6, "bfloat16": 4e-4,
                              "int8": 5e-4}[table_dtype])
    with pytest.raises(ValueError, match="local_sel_shards=1"):
        step(b, bridge.batch_to_torch(tloader.reslot_local(batches[0], CAP,
                                                           2), "cpu"))


@pytest.mark.parametrize("kind", ["joint_local", "joint", "per_side", "raw"])
def test_parallel_step_on_one_process_is_the_single_device_step(hashed,
                                                                kind):
    """With no process group the parallel step over a 1 x 1 mesh computes
    what the single-device step computes, bit for bit (on the card the
    same holds over an NCCL group of one: tests/test_torch_cuda.py)."""
    _, th = hashed
    _, tc = _cfgs()
    rows = [np.arange(i * BATCH, (i + 1) * BATCH) for i in range(3)]
    if kind == "raw":
        batches = [tloader.select_batch(th, r) for r in rows]
    else:
        batches = [tloader.select_batch(th, r, 2048, 8, 512, kind != "per_side")
                   for r in rows]
    if kind == "joint_local":
        batches = [tloader.reslot_local(b, CAP) for b in batches]
    mesh = tmesh.make_mesh(tc.mesh, "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    params = tbase.init_params(tc.tower, seed=2, device="cpu")
    a = create_run_state(tc, {t: {k: v.clone() for k, v in tp.items()}
                              for t, tp in params.items()})
    b = create_sharded_state(tc, mesh, params)
    single, par = make_train_step(tc), make_parallel_train_step(tc, mesh)
    for batch in batches:
        a, aux_a = single(a, bridge.batch_to_torch(batch, "cpu"))
        b, aux_b = par(b, bridge.batch_to_torch(
            tdist.local_shard(batch, mesh), "cpu"))
        if kind != "raw":
            assert float(aux_a["loss"]) == float(aux_b["loss"])
        else:
            # dssm_tpu's dispatch: a raw batch takes the dense step, whose
            # table update is sgd over the bag's d_table (a segment sum)
            # where the single-device step adds each lookup's update.
            np.testing.assert_allclose(float(aux_a["loss"]),
                                       float(aux_b["loss"]), rtol=1e-6)
    _tables_equal(a, b, atol=1e-7 if kind == "raw" else 0.0)


def test_make_mesh_errors_and_layout():
    """dssm_tpu's mesh errors (tests/test_parallel.py::test_mesh_validation)
    and its data-major layout: rank = data * mp + model."""
    for cfg in (tcfg.MeshConfig(data_parallel=3, model_parallel=2),
                tcfg.MeshConfig(data_parallel=-1, model_parallel=3)):
        with pytest.raises(ValueError) as got:
            tmesh.mesh_shape(cfg, 8)
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(jcfg.MeshConfig(
                data_parallel=cfg.data_parallel,
                model_parallel=cfg.model_parallel))
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_mesh(tcfg.MeshConfig(model_parallel=2), "cpu",
                        world_size=8, rank=5)
    with pytest.raises(ValueError, match="1 devices not divisible"):
        tmesh.make_mesh(tcfg.MeshConfig(model_parallel=2), "cpu")
    assert tmesh.mesh_shape(tcfg.MeshConfig(model_parallel=2), 8) == (4, 2)
    jm = jmesh.make_mesh(jcfg.MeshConfig(data_parallel=4, model_parallel=2))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        d, m = rank // 2, rank % 2
        assert ids[d, m] == jax.devices()[rank].id


def test_shard_and_gather_state_on_one_rank():
    """param_pspec cuts only W0 / Wc / Win, and only at mp > 1; a mesh of
    one rank cuts and gathers nothing."""
    assert param_pspec(("shared", "W0"), 2) == ("model", None)
    assert param_pspec(("shared", "Wc"), 2) == ("model", None)
    assert param_pspec(("query", "Win"), 4) == ("model", None)
    assert param_pspec(("shared", "W1"), 2) == ()
    assert param_pspec(("shared", "W0_scale"), 2) == ()
    assert param_pspec(("shared", "W0"), 1) == ()
    _, tc = _cfgs(optimizer="adam", sparse_embed_update=False)
    mesh = tmesh.make_mesh(tc.mesh, "cpu")
    state = create_run_state(tc, tbase.init_params(tc.tower, device="cpu"))
    _tables_equal(bridge.shard_state(state, mesh), state)
    assert gather_tree(state.params, mesh) == state.params
    two = tmesh.Mesh(shape={"data": 1, "model": 2},
                     coords={"data": 0, "model": 1}, device="cpu")
    rows = shard_tree(state.opt_state, two)["mu"]["shared"]["W0"]
    assert rows.shape == (VOCAB // 2, 128)
