"""The parallel train steps over a mesh of ranks, one process a GPU.

Each rank holds its data shard of every batch and a state whose embedding
table (W0, Wc or Win: VOCAB_TABLE_KEYS) is cut by rows over the model axis
when mp > 1; every other parameter is whole on every rank. Where dssm_tpu
writes the step on global arrays and XLA's partitioner derives the
collectives, the steps here call them on the mesh's groups:

  - the doc pool all-gathered over the data group for the global negative
    pool, its gradient reduce-scattered back (loss/cosine_softmax.py);
  - the table lookups on mp > 1 as a local partial + a sum over the model
    group (kernels/sharded_embed.py, routed inside sharded_lookup_context);
  - the gradients of the replicated parameters summed over the data group
    only: the mp ranks of one data coordinate compute the same ones.

make_parallel_train_step_body dispatches as dssm_tpu's step does: on the
sparse path (sgd or the AdaGrad table optimizer, with dedupe lookups) a
dedupe batch takes the sparse body (parallel/sparse_step.py) and a
raw-index batch the dense one, which differentiates the whole tree (the
table's shard through the sharded bag) and runs the dense optimizer over
it, this rank's shard of the table and of its optimizer state included.
Both bodies update the state in place and read nothing back, so the steps
are compiled as the single-device ones are (train/compiled.py):
make_parallel_train_step a CUDA graph a batch signature on the card, the
NCCL collectives captured inside it (dssm_tpu's jitted, donated step),
make_parallel_multi_step one graph of K bodies (its lax.scan), and
make_parallel_eval_fn a replayed forward; on the CPU (gloo) the same
bodies run eagerly. Counterpart of dssm_tpu/parallel/train_step.py.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch

from dssm_tpu_torch.config import RunConfig
from dssm_tpu_torch.kernels.sharded_embed import sharded_lookup_context
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.parallel import dist as pdist
from dssm_tpu_torch.parallel.mesh import MODEL_AXIS
from dssm_tpu_torch.parallel.sparse_step import (
    make_loss, make_parallel_sparse_step_body)
from dssm_tpu_torch.train.compiled import (
    CompiledForward, CompiledStep, eager_step)
from dssm_tpu_torch.train.loop import make_loss_fn
from dssm_tpu_torch.train.sparse_update import uses_sparse_update
from dssm_tpu_torch.train.state import (
    TrainState, check_dense_table, create_run_state, optimizer_step_)

# The first-layer trigram tables (one per model family): the only
# parameters cut over the model axis.
VOCAB_TABLE_KEYS = frozenset({"W0", "Wc", "Win"})


def param_pspec(path: Tuple[str, ...], model_parallel: int) -> Tuple:
    """The layout of the parameter at `path` (tower, name): (MODEL_AXIS,
    None), rows cut over the model axis, for a vocab table at mp > 1; ()
    whole on every rank."""
    if model_parallel > 1 and path and path[-1] in VOCAB_TABLE_KEYS:
        return (MODEL_AXIS, None)
    return ()


def _map_tables(tree: Any, fn, mp: int, path: Tuple[str, ...] = ()) -> Any:
    """fn over the leaves of a params or optimizer-state tree that
    param_pspec cuts; every other leaf as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if param_pspec(path, mp) else tree
    if isinstance(tree, dict):
        return {k: _map_tables(v, fn, mp, path + (k,))
                for k, v in tree.items()}
    return tree


def shard_tree(tree: Any, mesh) -> Any:
    """This rank's rows of every cut leaf of a whole tree (params, or an
    optimizer state over them)."""
    mp, m = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]

    def cut(t):
        if t.shape[0] % mp:
            raise ValueError(f"vocab {t.shape[0]} not divisible by "
                             f"model_parallel {mp}")
        rows = t.shape[0] // mp
        return t[m * rows:(m + 1) * rows].clone()

    return _map_tables(tree, cut, mp)


def gather_tree(tree: Any, mesh) -> Any:
    """The whole tree on every rank of the model group: each cut leaf
    all-gathered over it (in rank order, the table's row order)."""
    group = mesh.groups[MODEL_AXIS]
    return _map_tables(
        tree, lambda t: pdist.all_gather_rows(t.contiguous(), group),
        mesh.shape[MODEL_AXIS])


def create_sharded_state(cfg: RunConfig, mesh, params) -> TrainState:
    """A fresh run state over this rank's cut of whole `params`."""
    return create_run_state(cfg, shard_tree(params, mesh))


def make_parallel_train_step_body(cfg: RunConfig, mesh,
                                  impl: str = "auto") -> Callable:
    """(state, local batch) -> aux, in place, dispatched by the batch's
    keys as dssm_tpu's make_parallel_train_step dispatches: on the sparse
    path a dedupe batch takes the sparse body, a raw-index batch the dense
    one. The compiled step keys its graphs on the batch's wire layout, so
    each branch gets a graph of its own."""
    dense_body = _make_dense_parallel_step_body(cfg, mesh, impl)
    if not (uses_sparse_update(cfg) and cfg.data.dedup_lookup):
        return dense_body
    sparse_body = make_parallel_sparse_step_body(cfg, mesh, impl)

    def body(state, batch):
        if "q_uniq" in batch or "uniq" in batch:
            return sparse_body(state, batch)
        return dense_body(state, batch)

    return body


def make_parallel_train_step(cfg: RunConfig, mesh,
                             impl: str = "auto") -> CompiledStep:
    """(state, local batch) -> (state, aux), compiled (train/compiled.py):
    on a CUDA state a replayed CUDA graph a batch signature, its NCCL
    collectives inside, on the state's own tensors; eager on a CPU state
    (gloo). batch: a bridge.WireBatch or fields on the state's device."""
    pdist.check_graph_safe()
    return CompiledStep(make_parallel_train_step_body(cfg, mesh, impl),
                        collectives=True)


def make_parallel_multi_step(cfg: RunConfig, mesh,
                             impl: str = "auto") -> CompiledStep:
    """(state, stacked local batch) -> (state, aux stacked [K]): the
    parallel body K times over the [K, ...] fields, one CUDA graph of K
    bodies and K times their collectives on the card (dssm_tpu's jitted
    lax.scan), as train/loop.py::make_multi_train_step runs the
    single-device body."""
    pdist.check_graph_safe()
    return CompiledStep(make_parallel_train_step_body(cfg, mesh, impl),
                        multi=True, collectives=True)


def make_eager_parallel_train_step(cfg: RunConfig, mesh, impl: str = "auto",
                                   multi: bool = False) -> Callable:
    """make_parallel_train_step's (with multi, make_parallel_multi_step's)
    body run eagerly on any device: what the compiled step is held to."""
    return eager_step(make_parallel_train_step_body(cfg, mesh, impl), multi)


def _lookup_context(cfg: RunConfig, mesh, impl: str):
    if mesh.shape[MODEL_AXIS] > 1:
        return sharded_lookup_context(mesh, impl, cfg.mesh.collective_dtype)
    return contextlib.nullcontext()


def _make_dense_parallel_step_body(cfg: RunConfig, mesh,
                                   impl: str = "auto") -> Callable:
    """(state, raw-index batch) -> aux: the dense-table step, IN PLACE, as
    train/loop.py::make_dense_train_step_body: autograd over the whole tree
    through the (sharded) bag, the gradients summed over the data group,
    optimizer_step_ over this rank's tree (its table shard and that
    shard's optimizer state included), the step counter advanced."""
    table_key = model_base.TABLE_KEY[cfg.tower.arch]
    loss_fn = make_loss_fn(cfg, impl, make_loss(cfg, mesh, impl))
    data_group = mesh.groups["data"]

    def body(state: TrainState, batch: Dict) -> Dict:
        if "uniq" in batch or "q_uniq" in batch:
            raise ValueError(
                "the dense-table step takes raw-index batches: dedupe "
                "batches (data.dedup_lookup) belong to the sparse path")
        check_dense_table(state.params, table_key)
        params = {tower: {k: v.detach().requires_grad_(True)
                          for k, v in tp.items()}
                  for tower, tp in state.params.items()}
        with _lookup_context(cfg, mesh, impl):
            loss, aux = loss_fn(params, batch)
            leaves = [v for tp in params.values() for v in tp.values()]
            it = iter(torch.autograd.grad(loss, leaves))
        grads = {tower: {k: next(it) for k in tp}
                 for tower, tp in params.items()}
        with torch.no_grad():
            optimizer_step_(cfg.train, state.params,
                            pdist.all_reduce_tree(grads, data_group),
                            state.opt_state)
            state.step.add_(1)
        return aux

    return body


def make_parallel_eval_fn(cfg: RunConfig, mesh,
                          impl: str = "auto") -> CompiledForward:
    """(params, local batch) -> (q, d) unit vectors of this rank's rows,
    forward only, the lookups over the (sharded) table: a CompiledForward
    (train/compiled.py; dssm_tpu's jitted fwd), a replayed CUDA graph on
    the card with the model group's sums inside, eager on the CPU. batch:
    a bridge.WireBatch (batch_to_device), copied into a static block a
    layout; the parameters are read where they lie."""
    pdist.check_graph_safe()

    def fwd(params, batch):
        with _lookup_context(cfg, mesh, impl):
            q = model_base.embed(params, cfg.tower, "q", batch, impl=impl)
            d = model_base.embed(params, cfg.tower, "d", batch, impl=impl)
        return q, d

    return CompiledForward(fwd, collectives=True)
