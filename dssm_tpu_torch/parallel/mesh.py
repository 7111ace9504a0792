"""The ('data', 'model') grid of ranks, one process per GPU.

  data  — batch sharding (data parallelism) and the axis the doc-embedding
          all-gather of the global negative pool rides
  model — row sharding of the trigram embedding table

Ranks are laid out data-major, as dssm_tpu's make_mesh lays out devices
(dssm_tpu/parallel/mesh.py: devices.reshape(dp, mp)): rank = d * mp + m.
Each rank belongs to one data group, the dp ranks of its model coordinate
(what a collective over 'data' spans), and one model group, the mp ranks of
its data coordinate (what a collective over 'model' spans). Counterpart of
dssm_tpu/parallel/mesh.py; where XLA derives the collectives from a layout
there, the parallel steps here call torch.distributed on these groups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from dssm_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[int, int]:
    """(dp, mp) of a mesh over n ranks, with dssm_tpu's errors."""
    mp = cfg.model_parallel
    dp = cfg.data_parallel
    if dp == -1:
        if n % mp != 0:
            raise ValueError(f"{n} devices not divisible by "
                             f"model_parallel={mp}")
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    return dp, mp


@dataclass
class Mesh:
    """This rank's place in the grid and the groups its collectives span.

    The groups are None when no process group is initialized (one process,
    no torch.distributed): every collective of the parallel steps is then
    the identity."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, Optional[dist.ProcessGroup]] = field(
        default_factory=lambda: {DATA_AXIS: None, MODEL_AXIS: None})

    @property
    def rank(self) -> int:
        return self.coords[DATA_AXIS] * self.shape[MODEL_AXIS] + self.coords[
            MODEL_AXIS]


def make_mesh(cfg: MeshConfig, device: torch.device,
              world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh over the ranks of the initialized process group (one rank
    when there is none). Every rank creates every data and model group, in
    one order (torch.distributed.new_group requires it). world_size / rank
    default to the process group's."""
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    dp, mp = mesh_shape(cfg, world_size)
    mesh = Mesh(shape={DATA_AXIS: dp, MODEL_AXIS: mp},
                coords={DATA_AXIS: rank // mp, MODEL_AXIS: rank % mp},
                device=torch.device(device))
    if not initialized:
        if world_size != 1:
            raise RuntimeError(f"a mesh over {world_size} ranks needs an "
                               "initialized process group (parallel/dist.py)")
        return mesh
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if m == mesh.coords[MODEL_AXIS]:
            mesh.groups[DATA_AXIS] = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if d == mesh.coords[DATA_AXIS]:
            mesh.groups[MODEL_AXIS] = g
    return mesh
