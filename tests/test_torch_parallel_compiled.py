"""The compiled parallel steps' parts on the CPU, where their bodies run
eagerly (the graphs, with their NCCL collectives inside, run only on the
card: tests/test_torch_cuda.py; the gloo meshes against dssm_tpu's:
tests/test_torch_multidevice.py).

- With no process group (a 1 x 1 mesh, every collective the identity) the
  parallel bodies equal the single-device bodies bit for bit, in place:
  the sparse body train/sparse_update.py's on joint batches (with and
  without a slot space, sgd and the AdaGrad table with adam) and per-side
  batches, the dense body train/loop.py's on raw-index batches under sgd
  and adam. Every state tensor, the optimizer's included, keeps its
  address; the step counter and adam's count advance on the device.
- The constructors hand out compiled objects: make_parallel_train_step and
  make_parallel_multi_step a CompiledStep that captures with collectives,
  make_parallel_eval_fn a CompiledForward, whose eager run on a wire block
  is the towers' embedding of its fields.
- What keeps a collective capturable (parallel/dist.py): a blocking wait
  or NCCL_GRAPH_MIXING_SUPPORT=0 is refused, and a collective on a group
  that has run none yet, issued under capture, raises.

Sizes: vocab 4096, embed 32, hidden 24, semantic 16, batch 64 (those of
test_torch_multidevice.py). Everything is held bit for bit: both sides run
the same plain versions in the same order.
"""

import numpy as np
import pytest
import torch

from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import loader as tloader
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.parallel import dist as pdist
from dssm_tpu_torch.parallel.mesh import make_mesh
from dssm_tpu_torch.parallel.train_step import (
    create_sharded_state, make_eager_parallel_train_step,
    make_parallel_eval_fn, make_parallel_multi_step, make_parallel_train_step,
    make_parallel_train_step_body)
from dssm_tpu_torch.train.compiled import (
    CompiledForward, CompiledStep, state_tensors)
from dssm_tpu_torch.train.loop import (
    make_dense_train_step_body, make_train_step_body)
from dssm_tpu_torch.train.state import create_run_state

VOCAB, BATCH, CAP = 4096, 64, 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**train):
    return tcfg.validate(tcfg.RunConfig(
        tower=tcfg.TowerConfig(vocab_size=VOCAB, embed_width=32,
                               hidden_dims=(24,), semantic_dim=16),
        data=tcfg.DataConfig(max_trigrams=32, max_unique=2048,
                             max_unique_rows=512),
        train=tcfg.TrainConfig(batch_size=BATCH, **train)))


@pytest.fixture(scope="module")
def hashed():
    cfg = _cfg()
    return tloader.hash_pairs(make_toy_pairs(4 * BATCH, 64, 13), cfg.tower,
                              cfg.data)


# branch: (train config, batch kind); the reference body is the
# single-device one of the same config, the dense one where the parallel
# dispatch takes a raw batch to the dense body.
BRANCHES = {
    "joint": (dict(learning_rate=0.1), "joint"),
    "joint_local": (dict(learning_rate=0.1), "joint_local"),
    "adagrad_adam": (dict(optimizer="adam", table_optimizer="adagrad",
                          learning_rate=0.01), "joint_local"),
    "per_side": (dict(learning_rate=0.1), "per_side"),
    "raw": (dict(learning_rate=0.1), "raw"),
    "dense_adam": (dict(optimizer="adam", learning_rate=0.01,
                        sparse_embed_update=False), "raw"),
}


def _batches(hashed, kind):
    rows = [np.arange(i * BATCH, (i + 1) * BATCH) for i in range(3)]
    if kind == "raw":
        return [tloader.select_batch(hashed, r) for r in rows]
    out = [tloader.select_batch(hashed, r, 2048, 8, 512, kind != "per_side")
           for r in rows]
    if kind == "joint_local":
        out = [tloader.reslot_local(b, CAP) for b in out]
    return out


def _fresh(cfg, init, sharded_on=None):
    params = {t: {k: v.clone() for k, v in tp.items()}
              for t, tp in init.items()}
    if sharded_on is not None:
        return create_sharded_state(cfg, sharded_on, params)
    return create_run_state(cfg, params)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_parallel_bodies_are_the_single_device_bodies_in_place(hashed,
                                                               branch):
    """Three steps of the parallel body over a 1 x 1 mesh (no process
    group) and of the single-device body, from one state: every state
    tensor bit-equal after every step, the aux equal, and each state's
    tensors where they were."""
    train, kind = BRANCHES[branch]
    cfg = _cfg(**train)
    mesh = make_mesh(cfg.mesh, "cpu")
    assert mesh.groups == {"data": None, "model": None}
    init = tbase.init_params(cfg.tower, seed=2, device="cpu")
    single = (make_dense_train_step_body(cfg) if kind == "raw"
              else make_train_step_body(cfg))
    par = make_parallel_train_step_body(cfg, mesh)
    a, b = _fresh(cfg, init), _fresh(cfg, init, mesh)
    where = {id(s): [t.data_ptr() for t in state_tensors(s)] for s in (a, b)}
    for i, batch in enumerate(_batches(hashed, kind)):
        fields = bridge.batch_to_torch(pdist.local_shard(batch, mesh), "cpu")
        aux_a, aux_b = single(a, fields), par(b, fields)
        assert aux_a.keys() == aux_b.keys()
        for k in aux_a:
            assert torch.equal(aux_a[k], aux_b[k]), (i, k)
        for x, y in zip(state_tensors(a), state_tensors(b), strict=True):
            assert torch.equal(x, y), i
    for s in (a, b):
        assert [t.data_ptr() for t in state_tensors(s)] == where[id(s)]
        assert s.step.device.type == "cpu" and int(s.step) == 3
    if cfg.train.optimizer == "adam":
        assert int(b.opt_state["count"]) == 3


def test_parallel_steps_are_compiled_objects(hashed):
    """make_parallel_train_step / make_parallel_multi_step are CompiledSteps
    that capture their collectives, make_parallel_eval_fn a CompiledForward;
    on a CPU state the compiled step is its eager body (the state updated
    in place, the host step advanced), and the eval forward on a wire block
    is the towers' embedding of its fields."""
    cfg = _cfg(learning_rate=0.1)
    mesh = make_mesh(cfg.mesh, "cpu")
    step = make_parallel_train_step(cfg, mesh)
    multi = make_parallel_multi_step(cfg, mesh)
    fwd = make_parallel_eval_fn(cfg, mesh)
    assert isinstance(step, CompiledStep) and step.collectives
    assert isinstance(multi, CompiledStep) and multi.collectives
    assert multi.multi and not step.multi
    assert isinstance(fwd, CompiledForward) and fwd.collectives
    init = tbase.init_params(cfg.tower, seed=2, device="cpu")
    a, b = _fresh(cfg, init, mesh), _fresh(cfg, init, mesh)
    eager = make_eager_parallel_train_step(cfg, mesh)
    for batch in _batches(hashed, "joint"):
        a, aux_a = step(a, bridge.batch_to_device(batch, "cpu"))
        b, aux_b = eager(b, bridge.batch_to_torch(batch, "cpu"))
        assert torch.equal(aux_a["loss"], aux_b["loss"])
    assert a.host_step == b.host_step == 3 and step.num_graphs == 0
    assert all(torch.equal(x, y) for x, y in zip(
        state_tensors(a), state_tensors(b), strict=True))
    batch = _batches(hashed, "joint")[0]
    q, d = fwd(a.params, bridge.batch_to_device(batch, "cpu"))
    fields = bridge.batch_to_torch(batch, "cpu")
    with torch.no_grad():
        assert torch.equal(q, tbase.embed(a.params, cfg.tower, "q", fields))
        assert torch.equal(d, tbase.embed(a.params, cfg.tower, "d", fields))


@pytest.mark.parametrize("var,value", [
    ("TORCH_NCCL_BLOCKING_WAIT", "1"), ("NCCL_BLOCKING_WAIT", "1"),
    ("NCCL_GRAPH_MIXING_SUPPORT", "0")])
def test_environment_that_keeps_collectives_out_of_a_graph_is_refused(
        monkeypatch, var, value):
    """A blocking wait, or NCCL without graph mixing, is refused when a
    parallel step is built; their defaults pass."""
    cfg = _cfg()
    mesh = make_mesh(cfg.mesh, "cpu")
    for v in ("TORCH_NCCL_BLOCKING_WAIT", "NCCL_BLOCKING_WAIT",
              "NCCL_GRAPH_MIXING_SUPPORT"):
        monkeypatch.delenv(v, raising=False)
    make_parallel_train_step(cfg, mesh)
    monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match=var):
        make_parallel_train_step(cfg, mesh)
    with pytest.raises(RuntimeError, match=var):
        make_parallel_eval_fn(cfg, mesh)


def test_collective_on_a_new_group_under_capture_raises(monkeypatch):
    """Under a capture, a collective on a group that has run none in this
    process would create its NCCL communicator inside the graph: it
    raises before it reaches torch.distributed. A group that has run one
    (the warm step's) passes the guard."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(pdist.dist, "all_reduce",
                        lambda t, group=None: seen.append(group))
    group = object()
    with pytest.raises(RuntimeError, match="communicator"):
        pdist.all_reduce(torch.ones(3), group)
    assert seen == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    pdist.all_reduce(torch.ones(3), group)  # the warm step's
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    pdist.all_reduce(torch.ones(3), group)
    assert seen == [group, group]
    pdist.shutdown()  # no process group: only forgets the groups
    with pytest.raises(RuntimeError, match="communicator"):
        pdist.all_reduce_tree({"t": {"w": torch.ones(2)}}, group)
