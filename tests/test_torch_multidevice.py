"""The multi-device path across processes: gloo ranks of dssm_tpu_torch
(tools/multihost_worker.py, one process a rank) against dssm_tpu's mesh of
the same shape on the first dp * mp of the 8 virtual CPU devices, at
(dp, mp) = (2, 1), (1, 2) and (2, 2); and cli.train on two ranks against
one process with the same global batch.

Each mesh shape is one spawn whose ranks run every check; dssm_tpu's side
is computed while they run. From one init and the same batches:

  - three sparse steps on joint batches with per-shard slot spaces
    (sel_local, reslot_local(batch, cap, dp)), on joint batches without,
    and on per-side batches;
  - three steps on raw-index batches: sgd through dssm_tpu's dispatch to
    the dense step, and the dense adam step (its moments cut like the
    table);
  - K = 2 steps a call over a stacked batch with slot spaces, and K = 4
    against four single steps from one state (bit-equal on every rank);
  - three slot-space steps on a bf16 collective wire;
  - three joint steps of the rotate loss (its candidates over the whole
    batch, the docs all-gathered);
  - the sharded loss (the global pool), its gradients, its sum_shards sums
    and its local-pool value;
  - the sharded bag and the gradient of its sum.

Every step takes its batch as a wire block (bridge.batch_to_device), as
cli.train feeds it, and updates the state in place: every rank's state
tensors keep their addresses, and its step counter lives on the state's
device (on the card the steps are CUDA graphs; on gloo they run eagerly).

Tolerances: f32 wire, losses and parameters rtol 1e-5 / atol 1e-6 (sums
in another order), as tests/test_multihost.py; adam's parameters atol 1e-4
(tests/test_torch_train.py: adam rescales cancellation noise to the
learning rate); in-batch recall within two rows of the batch (the fused
loss counts an exact tie as a hit, dssm_tpu's XLA argmax the first maximum
only); the bf16 wire: losses rtol 1e-3, parameters atol 1e-3 (both packages
round the same rows and gradients to bf16 once; the f32 sums around the
roundings differ in their last bits, which moves a bf16 rounding by one
step of 2^-8 relative).

Every spawn is joined with a timeout of its own and killed on expiry, so a
rank that hangs in a collective fails the test in seconds.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import loader as jloader
from dssm_tpu.data import toy as jtoy
from dssm_tpu.kernels.sharded_embed import embedding_bag_sharded
from dssm_tpu.loss.cosine_softmax import in_batch_loss_sharded
from dssm_tpu.models import base as jbase
from dssm_tpu.parallel import mesh as jmesh
from dssm_tpu.parallel.train_step import (
    create_sharded_state, make_parallel_eval_fn, make_parallel_multi_step,
    make_parallel_train_step, shard_batch)
from dssm_tpu.oracle.numpy_oracle import rotation_offsets
from dssm_tpu.train.loop import stack_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, CAP, GAMMA = 64, 512, 20.0
SPAWN_TIMEOUT = 90  # seconds for a spawn's ranks to finish every check
MESHES = [(2, 1), (1, 2), (2, 2)]
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side (the spawned ranks
    run with OMP_NUM_THREADS=1 and one intra-op thread too)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("DSSM_COORDINATOR", None)
    return env


def _spawn(argvs, logs):
    return [subprocess.Popen([sys.executable, "-m",
                              "dssm_tpu_torch.tools.multihost_worker", *a],
                             cwd=REPO, env=_env(), stdout=open(log, "w"),
                             stderr=subprocess.STDOUT)
            for a, log in zip(argvs, logs)]


def _join(procs, logs, timeout=SPAWN_TIMEOUT):
    """Wait for every rank; on a timeout or a failure kill the others and
    fail with the logs' ends."""
    import time

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
    tails = ""
    for log in logs:
        with open(log) as f:
            tails += f"--- {os.path.basename(log)}\n{f.read()[-3000:]}"
    assert not hung, f"ranks still running after {timeout} s:\n{tails}"
    assert all(p.returncode == 0 for p in procs), tails


def _cfg_dict(dp, mp, **over):
    d = dict(tower=dict(vocab_size=4096, embed_width=32, hidden_dims=[24],
                        semantic_dim=16),
             data=dict(max_trigrams=32, max_unique=2048,
                       max_unique_rows=512),
             loss=dict(mode="in_batch", gamma=GAMMA),
             mesh=dict(data_parallel=dp, model_parallel=mp),
             train=dict(batch_size=B, learning_rate=0.1))
    for k, v in over.items():
        sec, field = k.split(".")
        d[sec] = dict(d[sec], **{field: v})
    return d


def _jax_cfg(d):
    kw = {s: {k: tuple(v) if isinstance(v, list) else v
              for k, v in fields.items()} for s, fields in d.items()}
    kw["train"] = dict(kw["train"], use_pallas=False)
    return jcfg.validate(jcfg.RunConfig(
        tower=jcfg.TowerConfig(**kw["tower"]),
        data=jcfg.DataConfig(**kw["data"]),
        loss=jcfg.LossConfig(**kw["loss"]),
        mesh=jcfg.MeshConfig(**kw["mesh"]),
        train=jcfg.TrainConfig(**kw["train"])))


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(dp, mp):
    """The spec's runs and arrays, and {run: (jax config, batches)}."""
    base = _cfg_dict(dp, mp)
    jc = _jax_cfg(base)
    hashed = jloader.hash_pairs(jtoy.make_toy_pairs(4 * B, 64, 13),
                                jc.tower, jc.data)
    rows = [np.arange(i * B, (i + 1) * B) for i in range(3)]

    def batches(**kw):
        return [jloader.select_batch(hashed, r, False, **kw) for r in rows]

    dedup = dict(dedup_unique=2048, dedup_unique_rows=512)
    joint = batches(dedup_joint=True, **dedup)
    local = [jloader.reslot_local(dict(b), CAP, dp) for b in joint]
    raw = batches()
    runs = {
        "joint_local": (base, local),
        "joint": (base, joint),
        "per_side": (base, batches(dedup_joint=False, **dedup)),
        "raw_sgd": (base, raw),
        "dense_adam": (_cfg_dict(dp, mp, **{
            "train.optimizer": "adam", "train.learning_rate": 0.01,
            "train.sparse_embed_update": False}), raw),
        "bf16_wire": (_cfg_dict(dp, mp, **{
            "mesh.collective_dtype": "bfloat16"}), local),
        "multi": (_cfg_dict(dp, mp, **{"train.steps_per_call": 2}),
                  local[:2]),
        "rotate": (_cfg_dict(dp, mp, **{"loss.mode": "rotate",
                                        "loss.num_negatives": 20}),
                   [dict(b, rot_offsets=rotation_offsets(B, 20, i)
                         .astype(np.int32)) for i, b in enumerate(joint)]),
    }
    params = jax.tree.map(np.asarray, jbase.init_params(jc.tower, seed=0))
    arrays = {f"p/{t}/{k}": v for t, tp in params.items()
              for k, v in tp.items()}
    spec_runs = []
    for name, (cfg, bs) in runs.items():
        run = dict(name=name, kind="steps", cfg=cfg, params="p")
        if name == "multi":
            run["stacked"] = f"{name}/stk"
            arrays.update({f"{name}/stk/{k}": v
                           for k, v in stack_batches(iter(bs)).items()})
        else:
            run["batches"] = [f"{name}/b{i}" for i in range(len(bs))]
            for i, b in enumerate(bs):
                arrays.update({f"{name}/b{i}/{k}": v for k, v in b.items()})
        spec_runs.append(run)
    # K = 4 steps a call against four single steps, on batches the runs
    # above hold.
    spec_runs.append(dict(name="k4", kind="k_steps", cfg=base, params="p",
                          batches=[f"joint_local/b{i}" for i in (0, 1, 2, 0)]))
    rng = np.random.default_rng(1)
    arrays.update(q=_unit_rows(rng, B, 16), d=_unit_rows(rng, B, 16),
                  table=rng.normal(size=(64, 16)).astype(np.float32),
                  idx=rng.integers(0, 64, size=(8, 5)).astype(np.int32),
                  wgt=rng.uniform(0, 2, size=(8, 5)).astype(np.float32))
    spec_runs += [dict(name="loss", kind="loss", q="q", d="d", gamma=GAMMA),
                  dict(name="bag", kind="bag", table="table", idx="idx",
                       wgt="wgt")]
    # One step of each with its collectives recorded: slot spaces on a
    # bf16 wire (the multihost preset's step), and plain joint batches on
    # an f32 wire.
    for name, (over, kind) in COLLECTIVE_RUNS.items():
        cfg = _cfg_dict(dp, mp, **over)
        batch = (local if kind == "local" else joint)[0]
        arrays.update({f"{name}/b/{k}": v for k, v in batch.items()})
        spec_runs.append(dict(name=name, kind="collectives", cfg=cfg,
                              params="p", batch=f"{name}/b"))
    for name, b in (("eval_joint", joint[0]), ("eval_raw", raw[0])):
        arrays.update({f"{name}/b/{k}": v for k, v in b.items()})
        spec_runs.append(dict(name=name, kind="eval", cfg=base, params="p",
                              batch=f"{name}/b"))
    arrays["spec"] = np.asarray(json.dumps(
        dict(dp=dp, mp=mp, runs=spec_runs)))
    return arrays, runs, params


def _reference(dp, mp, runs, params, arrays):
    """dssm_tpu's results on its mesh of the first dp * mp devices."""
    out = {}
    devices = jax.devices()[:dp * mp]
    for name, (cfg, bs) in runs.items():
        jc = _jax_cfg(cfg)
        mesh = jmesh.make_mesh(jc.mesh, devices)
        state = create_sharded_state(jc, mesh, jax.tree.map(jnp.asarray,
                                                            params))
        with mesh:
            if name == "multi":
                multi = make_parallel_multi_step(jc, mesh, impl="xla")
                state, auxes = multi(state, shard_batch(
                    stack_batches(iter(bs)), mesh, stacked=True))
                losses = [float(x) for x in auxes["loss"]]
            else:
                step = make_parallel_train_step(jc, mesh, impl="xla")
                losses = []
                for b in bs:
                    state, aux = step(state, shard_batch(b, mesh))
                    losses.append(float(aux["loss"]))
        out[name] = (losses, jax.tree.map(
            lambda a: np.asarray(a, np.float32), state.params))
    mesh = jmesh.make_mesh(jcfg.MeshConfig(data_parallel=dp,
                                           model_parallel=mp), devices)
    q, d = jnp.asarray(arrays["q"]), jnp.asarray(arrays["d"])
    with mesh:
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda a, b: in_batch_loss_sharded(a, b, GAMMA, mesh, impl="xla"),
            argnums=(0, 1), has_aux=True))(q, d)
        sums, _ = jax.jit(lambda a, b: in_batch_loss_sharded(
            a, b, GAMMA, mesh, impl="xla", reduce="sum_shards"))(q, d)
        local, _ = jax.jit(lambda a, b: in_batch_loss_sharded(
            a, b, GAMMA, mesh, impl="xla", global_pool=False))(q, d)
    out["loss"] = dict(loss=float(loss), aux={k: float(v)
                                              for k, v in aux.items()},
                       dq=np.asarray(grads[0]), dd=np.asarray(grads[1]),
                       sums=np.asarray(sums), local=float(local))
    from jax.sharding import NamedSharding, PartitionSpec as P

    with mesh:
        t = jax.device_put(jnp.asarray(arrays["table"]),
                           NamedSharding(mesh, P("model", None)))
        idx, wgt = jnp.asarray(arrays["idx"]), jnp.asarray(arrays["wgt"])
        bag = embedding_bag_sharded(t, idx, wgt, mesh)
        g = jax.grad(lambda t_: embedding_bag_sharded(
            t_, idx, wgt, mesh).sum())(t)
    out["bag"] = dict(out=np.asarray(bag), grad=np.asarray(g))
    jc = _jax_cfg(_cfg_dict(dp, mp))
    mesh = jmesh.make_mesh(jc.mesh, devices)
    state = create_sharded_state(jc, mesh, jax.tree.map(jnp.asarray, params))
    fwd = make_parallel_eval_fn(jc, mesh, impl="xla")
    for name in ("eval_joint", "eval_raw"):
        b = runs["joint" if name == "eval_joint" else "raw_sgd"][1][0]
        with mesh:
            q, d = fwd(state.params, shard_batch(b, mesh))
        out[name] = dict(q=np.asarray(q, np.float32),
                         d=np.asarray(d, np.float32))
    return out


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"dp{d}_mp{m}" for d, m in MESHES])
def ranks(request, tmp_path_factory):
    """One spawn of dp * mp gloo ranks running every check, dssm_tpu's side
    computed meanwhile: (dp, mp, [each rank's results], reference)."""
    dp, mp = request.param
    tmp = tmp_path_factory.mktemp(f"mesh_{dp}x{mp}")
    arrays, runs, params = _inputs(dp, mp)
    spec = str(tmp / "spec.npz")
    np.savez(spec, **arrays)
    n = dp * mp
    outs = [str(tmp / f"out_{r}.npz") for r in range(n)]
    logs = [str(tmp / f"rank_{r}.log") for r in range(n)]
    procs = _spawn([["parity", f"file://{tmp}/init", str(n), str(r), spec,
                     outs[r], "--cpu"] for r in range(n)], logs)
    try:
        ref = _reference(dp, mp, runs, params, arrays)
    finally:
        _join(procs, logs)
    return dp, mp, [dict(np.load(o)) for o in outs], ref


COLLECTIVE_RUNS = {
    "coll_local_bf16": ({"mesh.collective_dtype": "bfloat16",
                         "data.max_unique_rows_local": CAP}, "local"),
    "coll_joint_f32": ({}, "joint"),
}

RUNS = ["joint_local", "joint", "per_side", "raw_sgd", "dense_adam",
        "multi", "bf16_wire", "rotate"]


@pytest.mark.parametrize("run", RUNS)
def test_steps_match_dssm_tpu_mesh(ranks, run):
    dp, mp, outs, ref = ranks
    want_losses, want_params = ref[run]
    for o in outs:  # every rank reports the global loss
        np.testing.assert_allclose(
            o[f"{run}/losses"], want_losses,
            **(dict(rtol=1e-3) if run == "bf16_wire" else LOSS_TOL))
    ptol = {"dense_adam": dict(rtol=0, atol=1e-4),
            "bf16_wire": dict(rtol=0, atol=1e-3)}.get(
                run, dict(rtol=1e-5, atol=1e-6))
    for tower, tp in want_params.items():
        for k, w in tp.items():
            np.testing.assert_allclose(outs[0][f"{run}/params/{tower}/{k}"],
                                       w, err_msg=f"{run} {tower}/{k}",
                                       **ptol)
    if run == "dense_adam":
        assert int(outs[0][f"{run}/count"]) == 3


@pytest.mark.parametrize("run", RUNS)
def test_steps_update_the_state_in_place(ranks, run):
    """On every rank the steps wrote the new state into the tensors it
    lives in (their addresses before and after are the same), and the step
    counter is on the state's device and mirrored on the host."""
    dp, mp, outs, _ = ranks
    n = 2 if run == "multi" else 3
    for o in outs:
        assert bool(o[f"{run}/in_place"]), (run, o["coords"])
        assert o[f"{run}/step"].tolist() == [n, n, 1], o[f"{run}/step"]


def test_k_steps_a_call_bit_equal_to_single_steps(ranks):
    """K = 4 steps in one call of make_parallel_multi_step and four calls
    of make_parallel_train_step, from one state: every state tensor
    bit-equal on every rank."""
    dp, mp, outs, _ = ranks
    for o in outs:
        assert bool(o["k4/bit_equal"]), o["coords"]


def _by_data_shard(outs, key, mp):
    """The model-coordinate-0 ranks' `key` rows, in data order."""
    rows = sorted((int(o["coords"][0]), o[key]) for o in outs
                  if int(o["coords"][1]) == 0)
    return np.concatenate([r for _, r in rows])


def test_sharded_loss_and_grads_match(ranks):
    dp, mp, outs, ref = ranks
    want = ref["loss"]
    for o in outs:
        np.testing.assert_allclose(float(o["loss/loss"]), want["loss"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(o["loss/aux/pos_cos"]),
                                   want["aux"]["pos_cos"], **LOSS_TOL)
        np.testing.assert_allclose(float(o["loss/aux/in_batch_recall@1"]),
                                   want["aux"]["in_batch_recall@1"], rtol=0,
                                   atol=2 / B)
        np.testing.assert_allclose(float(o["loss/local_pool"]),
                                   want["local"], **LOSS_TOL)
    sums = sorted((int(o["coords"][0]), float(o["loss/sum"])) for o in outs
                  if int(o["coords"][1]) == 0)
    np.testing.assert_allclose([s for _, s in sums], want["sums"],
                               **LOSS_TOL)
    np.testing.assert_allclose(sum(s for _, s in sums) / B, want["loss"],
                               **LOSS_TOL)
    for k in ("dq", "dd"):
        np.testing.assert_allclose(_by_data_shard(outs, f"loss/{k}", mp),
                                   want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_sharded_bag_and_grad_match(ranks):
    dp, mp, outs, ref = ranks
    want = ref["bag"]
    np.testing.assert_allclose(_by_data_shard(outs, "bag/out", mp),
                               want["out"], rtol=1e-5, atol=1e-6)
    grads = sorted((int(o["coords"][1]), o["bag/grad"]) for o in outs
                   if int(o["coords"][0]) == 0)
    np.testing.assert_allclose(np.concatenate([g for _, g in grads]),
                               want["grad"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("run", list(COLLECTIVE_RUNS))
def test_collectives_match_comm_model(ranks, run):
    """The collectives parallel/dist.py issues in one step, recorded on
    every rank, are parallel/comm_model.py's terms for the mesh and the
    step's options: the same ops on the same axes with the same bytes, in
    the same order. A group of one rank (an axis of size 1) still has its
    all-reduce issued; it moves nothing and the model leaves it out."""
    from dssm_tpu_torch.parallel import comm_model
    from dssm_tpu_torch.tools.multihost_worker import run_config

    dp, mp, outs, _ = ranks
    cfg = run_config(_cfg_dict(dp, mp, **COLLECTIVE_RUNS[run][0]))
    terms = comm_model.step_collectives(cfg, dp, mp,
                                        **comm_model.step_options(cfg))

    def kind(t):
        op = ("all_gather_into_tensor" if "all-gather" in t.name
              else "reduce_scatter_tensor" if "reduce-scatter" in t.name
              else "all_reduce")
        return op, "model" if "(mp)" in t.name else "data"

    want = [(*kind(t), round(t.mbytes * 1e6)) for t in terms]
    assert len(want) == {(2, 1): 5, (1, 2): 1, (2, 2): 6}[(dp, mp)]
    for o in outs:
        log = json.loads(str(o[f"{run}/log"]))
        assert all(r["ranks"] == {"data": dp, "model": mp}[r["axis"]]
                   for r in log)
        moved = [(r["op"], r["axis"], r["nbytes"]) for r in log
                 if r["ranks"] > 1]
        assert moved == want, (moved, want)
        assert len(log) - len(moved) == (2 if dp == 1 else 0)


@pytest.mark.parametrize("name", ["eval_joint", "eval_raw"])
def test_eval_forward_matches(ranks, name):
    """make_parallel_eval_fn on a dedupe batch (the sharded compact gather)
    and a raw one (the sharded bag): each rank's rows of (q, d)."""
    dp, mp, outs, ref = ranks
    for k in ("q", "d"):
        np.testing.assert_allclose(_by_data_shard(outs, f"{name}/{k}", mp),
                                   ref[name][k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ---- cli.train on two ranks against one process ---------------------------

SMALL = ["--preset=tiny", "--cpu", "--tower.vocab_size=4096",
         "--tower.embed_width=40", "--tower.hidden_dims=64",
         "--tower.semantic_dim=32", "--data.max_trigrams=16",
         "--data.max_trigrams_query=8", "--data.max_unique=512",
         "--data.max_unique_rows=128", "--data.max_unique_rows_local=128",
         "--data.toy_num_pairs=400", "--data.toy_vocab_words=64",
         "--train.batch_size=64", "--train.max_steps=5",
         "--train.log_every=1", "--train.eval_every=2",
         "--train.checkpoint_every=2", "--train.steps_per_call=2",
         "--mesh.collective_dtype=float32"]


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """cli.train in this process, no process group: its records and
    checkpoint steps."""
    from dssm_tpu_torch.cli import train as cli_train
    from dssm_tpu_torch.io.checkpoint import Checkpointer

    work = str(tmp_path_factory.mktemp("cli_one"))
    cli_train.main(SMALL + [f"--io.workdir={work}"])
    return _records(work), Checkpointer(work).all_steps()


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_cli_train_two_ranks_match_one_process(one_process, tmp_path, dp,
                                               mp, capsys):
    """Two gloo ranks (tools/multihost_worker.py cli, the DSSM_* variables)
    train the same global batches as one process: the same losses, the
    same train / eval records and checkpoint steps (K = 2 blocks), process
    0 alone writing them; its checkpoint is whole and cli.eval reads it."""
    from dssm_tpu_torch.cli import eval as cli_eval
    from dssm_tpu_torch.io.checkpoint import Checkpointer

    work = str(tmp_path / "run")
    flags = SMALL + [f"--io.workdir={work}",
                     f"--mesh.model_parallel={mp}"]
    logs = [str(tmp_path / f"rank_{r}.log") for r in range(2)]
    _join(_spawn([["cli", f"file://{tmp_path}/init", "2", str(r), *flags]
                  for r in range(2)], logs), logs)
    one_records, one_steps = one_process
    records = _records(work)
    assert ([(r["tag"], r["step"]) for r in records]
            == [(r["tag"], r["step"]) for r in one_records])
    for got, want in zip(records, one_records):
        for k in ("loss", "pos_cos", "recall@1", "ndcg@10", "mrr"):
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{got}")
    ckpt = Checkpointer(work)
    assert ckpt.all_steps() == one_steps
    state = ckpt.restore(device="cpu")
    assert tuple(state.params["shared"]["W0"].shape) == (4096, 128)
    capsys.readouterr()
    cli_eval.main([*SMALL, f"--io.workdir={work}"])
    reported = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    final = records[-1]
    assert final["tag"] == "eval_final" and reported["step"] == 5
    for k in ("recall@1", "ndcg@10", "mrr"):
        np.testing.assert_allclose(reported[k], final[k], rtol=1e-6)
    if mp == 2:
        # --resume on two ranks: each restores its cut of the whole
        # checkpoint and the run goes on from step 5.
        logs = [str(tmp_path / f"resume_{r}.log") for r in range(2)]
        _join(_spawn([["cli", f"file://{tmp_path}/init2", "2", str(r),
                       *flags, "--resume", "--train.max_steps=7"]
                      for r in range(2)], logs), logs)
        for log in logs:
            with open(log) as f:
                assert "resumed from step 5" in f.read()
        assert Checkpointer(work).latest_step() == 7
        assert _records(work)[-1]["tag"] == "eval_final"
