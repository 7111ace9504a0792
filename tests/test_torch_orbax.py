"""dssm_tpu's orbax checkpoints read by dssm_tpu_torch on the CPU: the reader
(io/orbax_reader.py) against the state dssm_tpu saved, the one restore
(io/checkpoint.py::restore_run) and the command lines over a workdir
dssm_tpu trained.

The checkpoints are written in tmp_path by dssm_tpu's own Checkpointer (and
its cli.train), at small sizes: vocab 256, embed 8, hidden 8, semantic 4;
the command lines run the `tiny` preset at the SMALL widths of
tests/test_torch_serve.py.

Tolerances: the reader's leaves are bit-equal to dssm_tpu's
(``jax.tree.map(np.asarray, state)``); the port's cli.eval on a dssm_tpu
workdir reports dssm_tpu's cli.eval metrics within 1e-6
(tests/test_torch_eval.py's tolerance, f32 compute); the first losses of
cli.train --resume are dssm_tpu's within 1e-5 (f32 compute: sums in another
order, and dssm_tpu's CLI runs its step on a mesh of 8 CPU devices).
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from dssm_tpu.cli import eval as jeval_cli
from dssm_tpu.cli import train as jtrain_cli
from dssm_tpu.config import configs as jcfg
from dssm_tpu.io.checkpoint import Checkpointer as JaxCheckpointer
from dssm_tpu.models import base as jbase
from dssm_tpu.train import state as jstate
from dssm_tpu_torch import bridge
from dssm_tpu_torch.cli import eval as teval_cli
from dssm_tpu_torch.cli import export as texport_cli
from dssm_tpu_torch.cli import train as ttrain_cli
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.io import orbax_reader
from dssm_tpu_torch.io.checkpoint import Checkpointer, restore_run
from dssm_tpu_torch.train.state import create_run_state

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "dssm_tpu_workdir")
SMALL = ["--preset=tiny", "--tower.vocab_size=4096", "--tower.embed_width=40",
         "--tower.hidden_dims=64", "--tower.semantic_dim=32",
         "--data.max_trigrams=16", "--data.max_trigrams_query=8",
         "--data.max_unique=512", "--data.max_unique_rows=128",
         "--data.toy_num_pairs=400", "--data.toy_vocab_words=64",
         "--train.batch_size=64", "--data.freq_remap=true"]
SAVED = 3  # the steps of the dssm_tpu run the command lines read


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(table_dtype="float32", optimizer="sgd", dense=False):
    """dssm_tpu's and the port's configs of one small state. On the sparse
    path momentum and adam take the AdaGrad table optimizer (the dense
    subtree's optax state); dense=True differentiates the table too."""
    kw = dict(
        tower=dict(vocab_size=256, embed_width=8, hidden_dims=(8,),
                   semantic_dim=4, table_dtype=table_dtype),
        train=dict(optimizer=optimizer, sparse_embed_update=not dense,
                   table_optimizer=("adagrad" if optimizer != "sgd"
                                    and not dense else "sgd")),
    )
    # Built without validate: an int8 table with the AdaGrad table
    # optimizer trains nowhere, but its state is a state all the same.
    return tuple(m.RunConfig(tower=m.TowerConfig(**kw["tower"]),
                             train=m.TrainConfig(**kw["train"]))
                 for m in (jcfg, tcfg))


def _random_state(jc, seed):
    """dssm_tpu's run state with every leaf random (so that bit-equality
    says something) and the table in 4 row chunks, as a table sharded
    over 4 devices is saved."""
    state = jstate.create_run_state(jc, jbase.init_params(jc.tower, seed=0))
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int8:
            return jnp.asarray(rng.integers(-127, 128, x.shape, np.int8))
        if x.dtype.kind in "iu":
            return jnp.asarray(rng.integers(1, 1000, x.shape, x.dtype))
        return jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))

    state = jax.tree.map(fill, state)
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    table = state.params["shared"]["W0"]
    state.params["shared"]["W0"] = jax.device_put(
        table, NamedSharding(mesh, PartitionSpec("model", None)))
    return state


def _save(workdir, states, keep=3):
    ckpt = JaxCheckpointer(str(workdir), keep=keep)
    for step, state in states:
        ckpt.save(step, state, force=True)
    ckpt.wait()
    ckpt.close()


def _leaves(tree):
    """{path: leaf} of a numpy tree: dssm_tpu's state (a TrainState of
    dicts and optax namedtuples) or the reader's (dicts and lists)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "name", getattr(k, "key", getattr(
            k, "idx", k)))) for k in path)
        out[name] = leaf
    return out


def _assert_bit_equal(got_tree, want_tree):
    got, want = _leaves(got_tree), _leaves(jax.tree.map(np.asarray,
                                                        want_tree))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.dtype.name == "bfloat16":
            assert isinstance(g, orbax_reader.BFloat16Array), name
            w = w.view(np.uint16)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name


CASES = [(d, o, False) for d in ("float32", "bfloat16", "int8")
         for o in ("sgd", "momentum", "adam")] + [("float32", "adam", True)]


@pytest.mark.parametrize("table_dtype,optimizer,dense", CASES, ids=[
    f"{d}-{o}" + ("-dense" if dense else "") for d, o, dense in CASES])
def test_reader_is_bit_equal_to_saved_state(tmp_path, table_dtype, optimizer,
                                            dense):
    """Every leaf the reader returns is the saved one, bit for bit: f32,
    bf16 and int8 tables (the int8 table with its scale) under sgd,
    momentum and adam on the sparse path, and adam over the whole tree on
    the dense-table step; the table read whole from its 4 chunks. Through
    restore_run the port's state is bridge.state_from_jax's of the saved
    state, which the port's other tests hold to dssm_tpu."""
    jc, tc = _cfgs(table_dtype, optimizer, dense)
    state = _random_state(jc, seed=len(table_dtype) + len(optimizer))
    _save(tmp_path, [(7, state)])
    step, tree = orbax_reader.read_checkpoint(str(tmp_path))
    assert step == 7
    _assert_bit_equal({"step": tree["step"], "params": tree["params"],
                       "opt_state": [s for s in tree["opt_state"]
                                     if s is not None]},
                      {"step": state.step, "params": state.params,
                       "opt_state": [s for s in state.opt_state
                                     if jax.tree.leaves(s)]})
    got, source = restore_run(str(tmp_path), tc, "cpu")
    assert "dssm_tpu (orbax) checkpoint" in source
    np_state = jax.tree.map(np.asarray, state)
    want = bridge.state_from_jax(int(np_state.step), np_state.params,
                                 np_state.opt_state, tc, "cpu")
    assert got.step == want.step == int(np_state.step)
    assert _torch_leaves(got.params) == _torch_leaves(want.params)
    assert _torch_leaves(got.opt_state) == _torch_leaves(want.opt_state)


def _torch_leaves(tree, path=""):
    """{path: (dtype, shape, bytes)} of a tree of tensors and ints."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        return {path: (t.dtype, tuple(t.shape),
                       t.reshape(-1).view(torch.uint8).numpy().tobytes()
                       if t.numel() else b"")}
    return {path: tree}


def test_steps_newest_explicit_stale_and_partial(tmp_path):
    """A keep-3 workdir: the newest whole step by default, an explicit
    step, a `<step>.stale` directory and a step directory without its
    metadata ignored; a workdir of partial steps only raises."""
    jc, tc = _cfgs()
    states = {s: _random_state(jc, seed=s) for s in range(1, 6)}
    _save(tmp_path, sorted(states.items()), keep=3)
    ckdir = tmp_path / "checkpoints"
    shutil.copytree(ckdir / "5", ckdir / "9.stale")
    (ckdir / "8" / "default").mkdir(parents=True)
    assert orbax_reader.checkpoint_steps(str(tmp_path)) == [3, 4, 5]
    for asked, want in ((None, 5), (4, 4), (3, 3)):
        step, tree = orbax_reader.read_checkpoint(str(tmp_path), asked)
        assert step == want
        np.testing.assert_array_equal(tree["params"]["shared"]["W1"],
                                      np.asarray(states[want].params[
                                          "shared"]["W1"]))
    with pytest.raises(FileNotFoundError, match="step 2"):
        orbax_reader.read_checkpoint(str(tmp_path), 2)
    state, _ = restore_run(str(tmp_path), tc, "cpu")
    assert torch.equal(state.params["shared"]["b0"], torch.from_numpy(
        np.array(states[5].params["shared"]["b0"])))
    for s in ("3", "4", "5"):
        shutil.rmtree(ckdir / s)
    with pytest.raises(orbax_reader.OrbaxFormatError,
                       match=os.path.join("8", "default", "_METADATA")):
        restore_run(str(tmp_path), tc, "cpu")


def test_the_ports_own_checkpoints_win(tmp_path):
    """A workdir holding both formats: the port's own newest checkpoint is
    read, and dssm_tpu's are left in place; an empty torch_checkpoints/
    gives way to dssm_tpu's."""
    jc, tc = _cfgs(optimizer="momentum")
    _save(tmp_path, [(5, _random_state(jc, seed=1))])
    (tmp_path / "torch_checkpoints").mkdir()
    state, source = restore_run(str(tmp_path), tc, "cpu")
    assert state.step > 0 and "dssm_tpu (orbax)" in source
    own = create_run_state(tc, bridge.params_from_jax(jax.tree.map(
        np.asarray, _random_state(jc, seed=2).params), tc.tower, "cpu"))
    own.step = 2
    Checkpointer(str(tmp_path)).save(2, own)
    state, source = restore_run(str(tmp_path), tc, "cpu")
    assert state.step == 2 and "dssm_tpu_torch checkpoint" in source
    assert torch.equal(state.params["shared"]["W1"],
                       own.params["shared"]["W1"])
    assert orbax_reader.checkpoint_steps(str(tmp_path)) == [5]


@pytest.mark.parametrize("saved,asked", [
    (dict(optimizer="momentum"), dict(optimizer="adam")),
    (dict(optimizer="adam"), dict(optimizer="adam", dense=True)),
], ids=["another-optimizer", "another-optimized-tree"])
def test_restore_refuses_another_optimizer_state(tmp_path, saved, asked):
    """--resume under an optimizer, or an optimized tree, other than the
    run's raises, naming the flags; evaluating and serving read the
    parameters whatever the optimizer."""
    jc, _ = _cfgs(**saved)
    _save(tmp_path, [(5, _random_state(jc, seed=4))])
    _, tc = _cfgs(**asked)
    with pytest.raises(ValueError, match="--train"):
        restore_run(str(tmp_path), tc, "cpu")
    state, _ = restore_run(str(tmp_path), tc, "cpu", opt_state=False)
    assert state.opt_state == {} and "W1" in state.params["shared"]


def _node_file(workdir, step):
    """The file of the step's top B-tree node."""
    d = os.path.join(workdir, "checkpoints", str(step), "default", "d")
    (name,) = os.listdir(d)
    return os.path.join(d, name)


def _chunk_file(workdir, step):
    """The data file that holds the table's chunks."""
    d = os.path.join(workdir, "checkpoints", str(step), "default",
                     "ocdbt.process_0", "d")
    return max((os.path.join(d, n) for n in os.listdir(d)),
               key=os.path.getsize)


def _damage(path, how):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if how == "magic":
        data[0] ^= 0xFF
    else:
        data = data[:len(data) // 2]
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("how,where", [
    ("magic", _node_file), ("truncate", _node_file),
    ("truncate", _chunk_file)], ids=["flipped-magic", "truncated-node",
                                     "truncated-data-file"])
def test_undecodable_checkpoint_raises_naming_the_file(tmp_path, how, where):
    """A node's magic or length that is not what its frame says, or a
    chunk past the end of its data file, raises naming the file. (Nodes
    and manifests carry a CRC-32C; the chunks orbax writes carry none, so
    their bits are as good as the disk's.)"""
    jc, _ = _cfgs()
    _save(tmp_path, [(5, _random_state(jc, seed=3))])
    path = where(str(tmp_path), 5)
    _damage(path, how)
    with pytest.raises(orbax_reader.OrbaxFormatError) as err:
        orbax_reader.read_checkpoint(str(tmp_path))
    assert os.path.basename(path) in str(err.value)
    assert err.value.path == path


@pytest.mark.parametrize("compression", ["zstd", None])
def test_store_walks_interior_nodes_and_many_versions(tmp_path, compression):
    """An OCDBT store tensorstore wrote with 600-byte nodes and 20-byte
    inline values, one commit a key: a B-tree of interior nodes (keys
    stored under each subtree's common prefix), 63 versions (older ones in
    version tree nodes), values inline and in many data files, compressed
    or not. Every key reads back as tensorstore reads it."""
    import tensorstore as ts

    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 600,
                   "max_inline_value_bytes": 20,
                   "compression": compression and {"id": compression}},
    }).result()
    rng = np.random.default_rng(0)
    for i in range(60):
        kv.write(f"key/{i:04d}/.zarray",
                 rng.bytes(4 + 5 * (i % 8))).result()
    for i in range(3):
        kv.write(f"many/{i}", rng.bytes(50)).result()
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    store = orbax_reader._Store(str(tmp_path))
    assert sorted(k.decode() for k in store.values) == sorted(want)
    for key, value in want.items():
        assert store.get(key) == value, key


def test_committed_fixture_decodes_to_its_stored_arrays():
    """tests/fixtures/dssm_tpu_workdir (tests/fixtures/
    make_dssm_tpu_workdir.py): every leaf of the checkpoint dssm_tpu wrote
    is the one orbax's own restore gave, bit for bit."""
    with open(os.path.join(FIXTURE, "reference.json")) as f:
        ref = json.load(f)
    work = os.path.join(FIXTURE, "workdir")
    step, tree = orbax_reader.read_checkpoint(work)
    assert step == ref["steps"] == int(tree["step"])
    got = _leaves(tree)
    with np.load(os.path.join(FIXTURE, "reference.npz")) as z:
        want = {k[len("state/"):]: z[k] for k in z.files
                if k.startswith("state/")}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert (name in ref["bfloat16_leaves"]) == isinstance(
            g, orbax_reader.BFloat16Array), name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert "params/shared/W0" in ref["bfloat16_leaves"]
    assert got["params/shared/W0"].shape[0] == 2048


# ---- the command lines over a workdir dssm_tpu trained -------------------

@pytest.fixture(scope="module")
def jax_workdir(tmp_path_factory):
    """dssm_tpu's cli.train: SAVED steps of `tiny` at the SMALL widths,
    with the frequency remap; its orbax checkpoint of step SAVED."""
    work = str(tmp_path_factory.mktemp("dssm_tpu_run"))
    jtrain_cli.main(["--cpu", *SMALL, f"--io.workdir={work}",
                     f"--train.max_steps={SAVED}", "--train.log_every=1"])
    assert orbax_reader.checkpoint_steps(work) == [SAVED]
    return work


def _stdout(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    cap = capsys.readouterr()
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err


def test_eval_cli_evaluates_a_dssm_tpu_workdir(jax_workdir, capsys):
    """cli.eval on a workdir dssm_tpu trained reports the metrics that
    dssm_tpu's cli.eval reports there, at the saved step (it once
    evaluated the fresh init at step 0)."""
    want, _ = _stdout(jeval_cli.main, ["--cpu", *SMALL,
                                       f"--io.workdir={jax_workdir}"], capsys)
    got, err = _stdout(teval_cli.main, ["--cpu", *SMALL,
                                        f"--io.workdir={jax_workdir}"],
                       capsys)
    assert f"restored step {SAVED} from the dssm_tpu (orbax) checkpoint" in err
    assert got["step"] == want["step"] == SAVED
    assert got["num_queries"] == want["num_queries"]
    for k in ("recall@1", "recall@10", "ndcg@10", "mrr"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def _train_records(work, after):
    """(step, loss) of the train records a run appended to the workdir's
    metrics.jsonl, which held `after` lines before it."""
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads,
                                                    f.readlines()[after:])
                if r["tag"] == "train"]


def test_train_cli_resumes_a_dssm_tpu_workdir(jax_workdir, tmp_path,
                                              capsys):
    """cli.train --resume on a workdir dssm_tpu trained continues at the
    saved step + 1 from the saved weights and optimizer state, with the
    losses dssm_tpu's own --resume gives (it once started over at step 0
    from the fresh init); it saves its own checkpoints beside dssm_tpu's,
    which stay."""
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(jax_workdir, ref)
    shutil.copytree(jax_workdir, port)
    with open(os.path.join(jax_workdir, "metrics.jsonl")) as f:
        before = len(f.readlines())
    resume = ["--cpu", *SMALL, "--resume", f"--train.max_steps={SAVED + 2}",
              "--train.log_every=1"]
    jtrain_cli.main([*resume, f"--io.workdir={ref}"])
    capsys.readouterr()
    ttrain_cli.main([*resume, f"--io.workdir={port}"])
    err = capsys.readouterr().err
    assert f"resumed from step {SAVED} (the dssm_tpu (orbax)" in err
    want, got = _train_records(ref, before), _train_records(port, before)
    assert [s for s, _ in got] == [s for s, _ in want] == [SAVED, SAVED + 1]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=0, atol=1e-5)
    assert Checkpointer(port).all_steps() == [SAVED + 2]
    assert orbax_reader.checkpoint_steps(port) == [SAVED]


@pytest.mark.parametrize("cli", ["eval", "export", "train"])
def test_clis_raise_on_an_undecodable_dssm_tpu_workdir(jax_workdir, tmp_path,
                                                       cli):
    """None of the three command lines starts from the fresh init while a
    dssm_tpu checkpoint is there: one that cannot be decoded raises,
    naming the file."""
    work = str(tmp_path / "run")
    shutil.copytree(jax_workdir, work)
    node = _node_file(work, SAVED)
    _damage(node, "magic")
    argv = ["--cpu", *SMALL, f"--io.workdir={work}"]
    main = {"eval": teval_cli.main, "export": texport_cli.main,
            "train": ttrain_cli.main}[cli]
    extra = {"eval": [], "export": [f"--out={tmp_path / 'index.npz'}"],
             "train": ["--resume", f"--train.max_steps={SAVED + 1}"]}[cli]
    with pytest.raises(orbax_reader.OrbaxFormatError,
                       match=os.path.basename(node)):
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv + extra)
    assert not (tmp_path / "index.npz").exists()
