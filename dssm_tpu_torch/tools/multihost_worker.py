"""One rank of a multi-process run on one host, for the multi-device tests
and as a runnable demo of the multi-device path.

    python -m dssm_tpu_torch.tools.multihost_worker parity <init> <world> \
        <rank> <spec.npz> <out.npz> [--cpu]
    python -m dssm_tpu_torch.tools.multihost_worker cli <init> <world> \
        <rank> [cli.train flags ...]

<init> is the process group's rendezvous (tcp://host:port, or file://path,
which needs no free port). `cli` runs cli.train as process <rank> of
<world> (the DSSM_* variables set from the arguments). `parity` joins the
group (gloo with --cpu, else NCCL), makes the mesh of the spec's
(dp, mp), and runs each of the spec's runs on this rank's shard of whole
numpy inputs, writing this rank's results to <out.npz>:

  steps   the parallel train step over the spec's batches from the spec's
          initial parameters (whole; this rank's cut, bridge.shard_state),
          or K steps a call over one stacked batch ("stacked"), each batch
          a wire block (bridge.batch_to_device) as cli.train feeds it: the
          losses, the final parameters gathered whole (rank 0 writes
          them), whether every state tensor kept its address and the
          device step counter
  k_steps the spec's batches ("batches", K of them) as one call of K steps
          and as K single steps from one state: whether the two end
          states are bit-equal on this rank
  loss    in_batch_loss_sharded of this rank's q, d rows, its pmean value
          and aux, the gradients of its rows, the sum_shards sums and the
          local-pool loss
  bag     embedding_bag_sharded of this rank's rows over its table rows,
          and the gradient of the whole batch's sum in its table rows
  eval    make_parallel_eval_fn's (q, d) of this rank's rows of the spec's
          batch ("batch"), from the spec's parameters cut to this rank
  collectives
          one parallel train step on the spec's batch ("batch"), with every
          torch.distributed collective it issues recorded in order (op,
          mesh axis, ranks, bytes), as JSON under "<name>/log"

The spec is an npz: a JSON string under "spec" ({"dp", "mp", "runs": [{
"name", "kind", "cfg": {section: {field: value}}, "params", "batches" |
"stacked", ...}]}) and the arrays the runs name ("<prefix>/<key>" for a
parameter tree or a batch).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict

import numpy as np


def _tree(arrays, prefix: str) -> Dict:
    """"<prefix>/<tower>/<name>" arrays -> {tower: {name: array}}."""
    out: Dict = {}
    for k in arrays.files:
        if k.startswith(prefix + "/"):
            tower, name = k[len(prefix) + 1:].split("/")
            out.setdefault(tower, {})[name] = arrays[k]
    return out


def _batch(arrays, prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix) + 1:]: arrays[k] for k in arrays.files
            if k.startswith(prefix + "/")}


def run_config(d: Dict):
    """The port's RunConfig of {section: {field: value}} (JSON lists back
    to tuples), validated."""
    from dssm_tpu_torch.config import configs

    sections = dict(tower=configs.TowerConfig, data=configs.DataConfig,
                    loss=configs.LossConfig, mesh=configs.MeshConfig,
                    train=configs.TrainConfig)
    kw = {s: cls(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in d.get(s, {}).items()})
          for s, cls in sections.items()}
    return configs.validate(configs.RunConfig(**kw))


@contextlib.contextmanager
def record_collectives(mesh):
    """Every all_reduce, all_gather_into_tensor and reduce_scatter_tensor
    issued inside the block, in order: {"op", "axis" ("data" / "model"),
    "ranks", "nbytes"}; nbytes is the reduced buffer's, the
    gathered output's and the scattered input's (the totals
    parallel/comm_model.py counts)."""
    import torch.distributed as tdist

    axis_of = {id(g): a for a, g in mesh.groups.items()}
    log = []
    # Which positional argument holds the counted tensor.
    counted = {"all_reduce": 0, "all_gather_into_tensor": 0,
               "reduce_scatter_tensor": 1}
    originals = {op: getattr(tdist, op) for op in counted}

    def wrap(op):
        def wrapped(*args, group=None, **kw):
            t = args[counted[op]]
            log.append(dict(op=op, axis=axis_of[id(group)],
                            ranks=tdist.get_world_size(group),
                            nbytes=t.numel() * t.element_size()))
            return originals[op](*args, group=group, **kw)
        return wrapped

    for op in counted:
        setattr(tdist, op, wrap(op))
    try:
        yield log
    finally:
        for op, fn in originals.items():
            setattr(tdist, op, fn)


def parity(spec_path: str, out_path: str, device) -> None:
    import torch

    from dssm_tpu_torch import bridge
    from dssm_tpu_torch.config import MeshConfig
    from dssm_tpu_torch.kernels.sharded_embed import embedding_bag_sharded
    from dssm_tpu_torch.loss.cosine_softmax import in_batch_loss_sharded
    from dssm_tpu_torch.parallel import dist as pdist
    from dssm_tpu_torch.parallel.mesh import make_mesh
    from dssm_tpu_torch.parallel.train_step import (
        create_sharded_state, gather_tree, make_parallel_eval_fn,
        make_parallel_multi_step, make_parallel_train_step, shard_tree)
    from dssm_tpu_torch.train.compiled import state_tensors
    from dssm_tpu_torch.train.loop import stack_batches, state_device

    arrays = np.load(spec_path)
    spec = json.loads(str(arrays["spec"]))
    mesh = make_mesh(MeshConfig(data_parallel=spec["dp"],
                                model_parallel=spec["mp"]), device)
    out: Dict[str, np.ndarray] = {}

    def to_dev(batch, stacked=False):
        return bridge.batch_to_device(
            pdist.local_shard(batch, mesh, stacked=stacked), device)

    def addresses(state):
        return [t.data_ptr() for t in state_tensors(state)]

    for run in spec["runs"]:
        name, kind = run["name"], run["kind"]
        if kind == "steps":
            cfg = run_config(run["cfg"])
            params = bridge.params_from_jax(_tree(arrays, run["params"]),
                                            cfg.tower, device)
            state = create_sharded_state(cfg, mesh, params)
            before = addresses(state)
            if "stacked" in run:
                multi = make_parallel_multi_step(cfg, mesh)
                state, auxes = multi(state, to_dev(
                    _batch(arrays, run["stacked"]), stacked=True))
                losses = [float(x) for x in auxes["loss"]]
            else:
                step = make_parallel_train_step(cfg, mesh)
                losses = []
                for b in run["batches"]:
                    state, aux = step(state, to_dev(_batch(arrays, b)))
                    losses.append(float(aux["loss"]))
            out[f"{name}/losses"] = np.asarray(losses)
            out[f"{name}/in_place"] = np.asarray(addresses(state) == before)
            # (device counter, host mirror, counter on the state's device)
            out[f"{name}/step"] = np.asarray(
                [int(state.step), state.host_step,
                 state.step.device == state_device(state)])
            whole = gather_tree(state.params, mesh)
            if mesh.rank == 0:
                for tower, tp in bridge.params_to_numpy(whole).items():
                    for k, v in tp.items():
                        out[f"{name}/params/{tower}/{k}"] = v
            if state.opt_state.get("count") is not None:
                out[f"{name}/count"] = np.asarray(int(state.opt_state["count"]))
            # This rank's state is its cut of the whole one.
            cut = shard_tree(whole, mesh)
            if not all(torch.equal(cut[t][k], state.params[t][k])
                       for t in cut for k in cut[t]):
                raise RuntimeError(f"{name}: the gathered state's cut is "
                                   "not this rank's state")
        elif kind == "k_steps":
            cfg = run_config(run["cfg"])
            batches = [_batch(arrays, b) for b in run["batches"]]

            def fresh():  # the steps update the parameters they are given
                return create_sharded_state(cfg, mesh, bridge.params_from_jax(
                    _tree(arrays, run["params"]), cfg.tower, device))

            one = fresh()
            step = make_parallel_train_step(cfg, mesh)
            for b in batches:
                one, _ = step(one, to_dev(b))
            k, _ = make_parallel_multi_step(cfg, mesh)(
                fresh(), to_dev(stack_batches(batches), stacked=True))
            out[f"{name}/bit_equal"] = np.asarray(
                int(k.step) == int(one.step) == len(batches)
                and all(torch.equal(a, b) for a, b in zip(
                    state_tensors(k), state_tensors(one), strict=True)))
        elif kind == "loss":
            q, d = (torch.from_numpy(a).to(device) for a in pdist.local_shard(
                {"q": arrays[run["q"]], "d": arrays[run["d"]]}, mesh).values())
            q.requires_grad_(True)
            d.requires_grad_(True)
            loss, aux = in_batch_loss_sharded(q, d, run["gamma"], mesh)
            loss.backward()
            out[f"{name}/loss"] = np.asarray(float(loss))
            for k, v in aux.items():
                out[f"{name}/aux/{k}"] = np.asarray(float(v))
            out[f"{name}/dq"] = q.grad.cpu().numpy()
            out[f"{name}/dd"] = d.grad.cpu().numpy()
            with torch.no_grad():
                s, saux = in_batch_loss_sharded(q, d, run["gamma"], mesh,
                                                reduce="sum_shards")
                out[f"{name}/sum"] = np.asarray(float(s))
                out[f"{name}/sum_recall"] = np.asarray(
                    float(saux["in_batch_recall@1"]))
                lp, _ = in_batch_loss_sharded(q, d, run["gamma"], mesh,
                                              global_pool=False)
                out[f"{name}/local_pool"] = np.asarray(float(lp))
        elif kind == "bag":
            table = shard_tree({"t": {"W0": torch.from_numpy(
                arrays[run["table"]]).to(device)}}, mesh)["t"]["W0"]
            table.requires_grad_(True)
            loc = pdist.local_shard({"idx": arrays[run["idx"]],
                                     "wgt": arrays[run["wgt"]]}, mesh)
            bag = embedding_bag_sharded(
                table, torch.from_numpy(loc["idx"]).to(device),
                torch.from_numpy(loc["wgt"]).to(device), mesh)
            bag.sum().backward()
            out[f"{name}/out"] = bag.detach().cpu().numpy()
            out[f"{name}/grad"] = pdist.all_reduce(
                table.grad, mesh.groups["data"]).cpu().numpy()
        elif kind == "eval":
            cfg = run_config(run["cfg"])
            params = shard_tree(bridge.params_from_jax(
                _tree(arrays, run["params"]), cfg.tower, device), mesh)
            q, d = make_parallel_eval_fn(cfg, mesh)(
                params, to_dev(_batch(arrays, run["batch"])))
            out[f"{name}/q"] = q.cpu().numpy()
            out[f"{name}/d"] = d.cpu().numpy()
        elif kind == "collectives":
            cfg = run_config(run["cfg"])
            state = create_sharded_state(cfg, mesh, bridge.params_from_jax(
                _tree(arrays, run["params"]), cfg.tower, device))
            step = make_parallel_train_step(cfg, mesh)
            batch = to_dev(_batch(arrays, run["batch"]))
            with record_collectives(mesh) as log:
                step(state, batch)
            out[f"{name}/log"] = np.asarray(json.dumps(log))
        else:
            raise ValueError(f"unknown run kind {kind!r}")
    out["coords"] = np.asarray([mesh.coords["data"], mesh.coords["model"]])
    np.savez(out_path, **out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode, init, world, rank = argv[:4]
    rest = argv[4:]
    os.environ.update(DSSM_COORDINATOR=init, DSSM_NUM_PROCS=world,
                      DSSM_PROC_ID=rank)
    if mode == "cli":
        from dssm_tpu_torch.cli import train as cli_train

        cli_train.main(rest)
        return 0
    if mode != "parity":
        raise SystemExit(f"unknown mode {mode!r} (parity or cli)")
    import torch

    from dssm_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(1)
    device = pdist.initialize(cpu="--cpu" in rest)
    try:
        parity(rest[0], rest[1], device)
        pdist.barrier()
    finally:
        pdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
