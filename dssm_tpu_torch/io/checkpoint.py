"""Checkpoint / resume of a TrainState with torch.save.

A checkpoint is one file, workdir/torch_checkpoints/step_<N>.pt, holding the
step, the parameters and the optimizer state as CPU tensors. It is written
to a temporary name and renamed, so a reader never sees a partial file; the
newest `keep` are kept. Saving is synchronous. A state sharded over a
mesh (parallel/train_step.py) is written whole, in the same format: its
table is all-gathered over the model group and rank 0 writes; restoring
onto a mesh cuts it again, so cli.eval and cli.export read a multi-device
workdir as they read a single-device one. The API follows
dssm_tpu/io/checkpoint.py (whose orbax checkpoints live under
workdir/checkpoints and are a different format: the port does not read
them).
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from dssm_tpu_torch.device import DeviceLike, as_device
from dssm_tpu_torch.train.state import TrainState

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
                               opt_state=gather_tree(state.opt_state, mesh))
            if mesh.rank != 0:
                return
        payload = {
            "step": int(state.step),
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
        state = TrainState(
            step=int(payload["step"]),
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
