"""Checkpoint / resume of a TrainState with torch.save, and the one restore
the command lines start from.

A checkpoint is one file, workdir/torch_checkpoints/step_<N>.pt, holding the
step counter, the parameters and the optimizer state (adam's count
included) as CPU tensors; a checkpoint whose step and count are ints (the
port's format before its counters lived on the device) restores the same. It is written
to a temporary name and renamed, so a reader never sees a partial file; the
newest `keep` are kept. Saving is synchronous. A state sharded over a
mesh (parallel/train_step.py) is written whole, in the same format: its
table is all-gathered over the model group and rank 0 writes; restoring
onto a mesh cuts it again, so cli.eval and cli.export read a multi-device
workdir as they read a single-device one. The API follows
dssm_tpu/io/checkpoint.py.

restore_run is what cli.train --resume, cli.eval and cli.export read: the
port's own newest checkpoint when torch_checkpoints/ holds any step;
otherwise dssm_tpu's newest orbax checkpoint under workdir/checkpoints
(io/orbax_reader.py, then bridge.state_from_jax), so a model dssm_tpu
trained is served, evaluated or trained on; otherwise nothing, and the
caller starts from the fresh init. The port never writes or deletes
dssm_tpu's checkpoints, and a dssm_tpu checkpoint that cannot be decoded
raises, naming the file, rather than giving way to fresh weights.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Tuple

import torch

from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.io import orbax_reader
from dssm_tpu_torch.train.state import TrainState, counter

CHECKPOINT_DIR = "torch_checkpoints"
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


class Checkpointer:
    def __init__(self, workdir: str, keep: int = 3):
        self._dir = os.path.join(os.path.abspath(workdir), CHECKPOINT_DIR)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep

    @property
    def directory(self) -> str:
        return self._dir

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, mesh=None) -> None:
        """Write the state as step `step`, replacing a checkpoint of the
        same step, and drop all but the newest `keep`. With the mesh a
        sharded state is on, every rank calls it (the table's all-gather)
        and rank 0 writes."""
        if mesh is not None:
            from dssm_tpu_torch.parallel.train_step import gather_tree

            state = TrainState(step=state.step,
                               params=gather_tree(state.params, mesh),
                               opt_state=gather_tree(state.opt_state, mesh),
                               host_step=state.host_step)
            if mesh.rank != 0:
                return
        payload = {
            "step": counter(state.step, torch.device("cpu")),
            "params": _map_tensors(state.params, lambda t: t.detach().cpu()),
            "opt_state": _map_tensors(state.opt_state,
                                      lambda t: t.detach().cpu()),
        }
        tmp = f"{self._path(step)}.tmp.{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self._keep and self._keep > 0:
            for old in self.all_steps()[:-self._keep]:
                os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = "cuda",
                mesh=None) -> Optional[TrainState]:
        """The checkpoint of `step` (default: the latest) on `device`, or
        None when the workdir holds none; with a mesh, this rank's cut of
        it (bridge.shard_state)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        dev = as_device(device)
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        # The step and adam's count: int32 tensors, or the ints of a
        # checkpoint written before they lived on the device.
        state = TrainState(
            step=payload["step"],
            params=_map_tensors(payload["params"], lambda t: t.to(dev)),
            opt_state=_map_tensors(payload["opt_state"],
                                   lambda t: t.to(dev)),
        )
        if mesh is not None:
            from dssm_tpu_torch.bridge import shard_state

            state = shard_state(state, mesh)
        return state

    def clear(self) -> None:
        for step in self.all_steps():
            os.remove(self._path(step))


def _check_opt_trees(state: TrainState, cfg) -> None:
    """The optimizer state covers the tree the config's step optimizes:
    the dense subtree on the sparse path, the whole tree off it."""
    from dssm_tpu_torch.models.base import TABLE_KEY
    from dssm_tpu_torch.train.sparse_update import (
        _dense_subtree, uses_sparse_update)

    covered = (_dense_subtree(state.params, TABLE_KEY[cfg.tower.arch])
               if uses_sparse_update(cfg) else state.params)
    want = {t: {k: tuple(v.shape) for k, v in tp.items()}
            for t, tp in covered.items()}
    for name, tree in state.opt_state.items():
        if name == "count":
            continue
        got = {t: {k: tuple(v.shape) for k, v in tp.items()}
               for t, tp in tree.items()}
        if got != want:
            raise ValueError(
                f"the checkpoint's optimizer state {name!r} covers "
                f"{got}, the config's step optimizes {want}: pass the "
                "--train.* flags the run was trained with (optimizer, "
                "table_optimizer, sparse_embed_update)")


def restore_run(workdir: str, cfg, device: DeviceLike = "cuda", mesh=None,
                opt_state: bool = True
                ) -> Tuple[Optional[TrainState], Optional[str]]:
    """(state, what was read) for a command line over `workdir`: the port's
    newest checkpoint when torch_checkpoints/ holds any step, else
    dssm_tpu's newest orbax checkpoint, else (None, None) for the fresh
    init. With a mesh, this rank's cut of the state. opt_state=False
    (evaluating, serving) reads the parameters only, whatever optimizer
    the run used."""
    own = os.path.join(os.path.abspath(workdir), CHECKPOINT_DIR)
    if os.path.isdir(own) and any(map(_NAME.match, os.listdir(own))):
        ckpt = Checkpointer(workdir)
        return (ckpt.restore(device=device, mesh=mesh),
                f"the dssm_tpu_torch checkpoint under {ckpt.directory}")
    if not orbax_reader.has_checkpoint(workdir):
        return None, None
    from dssm_tpu_torch.bridge import (
        params_from_jax, shard_state, state_from_jax)

    step, tree = orbax_reader.read_checkpoint(workdir)
    if opt_state:
        state = state_from_jax(tree["step"], tree["params"],
                               tree["opt_state"], cfg, device)
        _check_opt_trees(state, cfg)
    else:
        state = TrainState(step=int(tree["step"]), opt_state={},
                           params=params_from_jax(tree["params"], cfg.tower,
                                                  device))
    if mesh is not None:
        state = shard_state(state, mesh)
    where = os.path.join(os.path.abspath(workdir),
                         orbax_reader.CHECKPOINT_DIR, str(step))
    return state, f"the dssm_tpu (orbax) checkpoint {where}"
