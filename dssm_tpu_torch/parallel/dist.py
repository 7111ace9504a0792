"""Process groups, one process per GPU, and the collectives of the parallel
steps.

initialize() reads dssm_tpu's variables (or takes them as arguments):

  DSSM_COORDINATOR  host:port of process 0 (or an init URL, e.g. file://...)
  DSSM_NUM_PROCS    number of processes
  DSSM_PROC_ID      this process's id
  DSSM_LOCAL_PROC_ID  this process's GPU on its host (default: DSSM_PROC_ID)

and joins the group: NCCL when the run is on the GPU (each process binds
its local GPU, and a host with fewer GPUs than local processes raises),
gloo only for a CPU run. It is a no-op when none is set (one process, no
group). A failed init raises; nothing falls back to gloo or to the CPU.

There is no global array in PyTorch: each process holds its rank's local
shard of a batch (local_shard: this data coordinate's rows of every per-row
field, the batch-wide dedupe fields whole) and the collectives are explicit
(all_reduce, AllReduceSum, AllGather). A collective over a group of None
(no process group) is the identity. Counterpart of
dssm_tpu/parallel/dist.py.

The collectives can be captured into a CUDA graph (train/compiled.py
captures the parallel steps with their NCCL collectives inside): none reads
a value back, waits on the host or hands out async work to wait on. Three
rules keep it so:

  - TORCH_NCCL_BLOCKING_WAIT stays unset: a blocking wait blocks the host
    on the collective's event, which a stream under capture cannot do;
  - NCCL_GRAPH_MIXING_SUPPORT keeps its default of 1: the same
    communicators run captured collectives (the steps) and eager ones
    (gather_tree, the checkpoints' barriers);
  - NCCL creates a group's communicator at the group's first collective,
    which a capture cannot hold. The compiled step runs its body once
    before it captures it (a real step), which reaches every collective
    the graph holds; a collective on a group that has run none yet in this
    process, issued under capture, raises (_enter) rather than hang.

check_graph_safe() raises when either variable says otherwise.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from dssm_tpu_torch.device import as_device

# How long a collective waits for its peers before it raises.
TIMEOUT = datetime.timedelta(minutes=10)

# The ids of the groups that have run a collective in this process (their
# communicators exist); cleared by shutdown().
_LIVE_GROUPS: set = set()


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               cpu: bool = False) -> torch.device:
    """Join the process group from the arguments or the DSSM_* variables;
    returns this process's device (the CPU with cpu=True, else its GPU).
    Without a coordinator or a process count it joins nothing and returns
    the device a single process runs on."""
    coordinator = coordinator or os.environ.get("DSSM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DSSM_NUM_PROCS", "0")) or None
    if process_id is None:
        pid = os.environ.get("DSSM_PROC_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator is None and num_processes is None:
        return as_device("cpu" if cpu else "cuda")
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs DSSM_COORDINATOR, DSSM_NUM_PROCS and "
            f"DSSM_PROC_ID (got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r})")
    if cpu:
        device, backend = torch.device("cpu"), "gloo"
    else:
        local = int(os.environ.get("DSSM_LOCAL_PROC_ID", process_id))
        as_device("cuda")
        n_gpu = torch.cuda.device_count()
        if local >= n_gpu:
            raise RuntimeError(
                f"process {process_id} is local process {local} on a host "
                f"with {n_gpu} GPU(s): one process a GPU")
        device, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if not dist.is_initialized():
        kwargs = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT, **kwargs)
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _LIVE_GROUPS.clear()


def check_graph_safe() -> None:
    """Raise when the environment keeps NCCL collectives out of a CUDA
    graph (the module docstring): TORCH_NCCL_BLOCKING_WAIT set, or
    NCCL_GRAPH_MIXING_SUPPORT=0."""
    for var in ("TORCH_NCCL_BLOCKING_WAIT", "NCCL_BLOCKING_WAIT"):
        if os.environ.get(var, "0") not in ("", "0"):
            raise RuntimeError(
                f"{var}={os.environ[var]}: a blocking wait cannot run while "
                "a stream is captured, and the parallel steps are captured "
                "CUDA graphs; unset it")
    if os.environ.get("NCCL_GRAPH_MIXING_SUPPORT", "1") == "0":
        raise RuntimeError(
            "NCCL_GRAPH_MIXING_SUPPORT=0: the parallel steps' captured "
            "collectives share their communicators with eager ones "
            "(gather_tree, barriers); leave it at its default of 1")


def _enter(group) -> None:
    """Before a collective on `group`: under a CUDA graph capture the
    group's communicator must exist already (a warm step ran its
    collectives), since creating one cannot be captured."""
    if (id(group) not in _LIVE_GROUPS and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            "a collective on a process group that has run none in this "
            "process, under CUDA graph capture: its NCCL communicator "
            "would be created inside the graph. Run the step once eagerly "
            "first (train/compiled.py's warm step does)")
    _LIVE_GROUPS.add(id(group))


def is_batch_wide(key: str) -> bool:
    """The dedupe fields that describe the whole batch (replicated in every
    process) rather than one row each; sel_local holds one row a data
    shard."""
    return (key in ("rot_offsets", "uniq", "sel")
            or key.endswith("_uniq") or key.endswith("_sel"))


def local_shard(batch: Mapping[str, np.ndarray], mesh,
                stacked: bool = False) -> Dict[str, np.ndarray]:
    """This rank's part of a whole numpy batch: its data coordinate's
    contiguous block of every per-row field, the batch-wide fields whole,
    and its row of `sel_local` (the [dp, cap] slot spaces of
    reslot_local(batch, cap, dp)) as a [1, cap] slot space. stacked: the
    fields carry a leading [K] axis. The counterpart of dssm_tpu's
    make_global_batch from the other side: a process that holds the whole
    batch (a test) cuts it as the loader's process shards would."""
    d, dp = mesh.coords["data"], mesh.shape["data"]
    ax = 1 if stacked else 0
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if is_batch_wide(k):
            out[k] = v
            continue
        n = v.shape[ax]
        if n % dp:
            raise ValueError(f"{k}: {n} rows not divisible by {dp} data "
                             "shards")
        per = n // dp
        out[k] = np.take(v, np.arange(d * per, (d + 1) * per), axis=ax)
    return out


def _quiet(fn, *args, **kwargs):
    # all_gather_into_tensor / reduce_scatter_tensor: the calls both the
    # GPU machine's torch and newer ones have; the newer ones mark them
    # deprecated.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, wire_dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """The sum of t over `group` (a new tensor; t when group is None). With
    wire_dtype the sum rides that dtype and is widened back to t's."""
    if group is None:
        return t
    _enter(group)
    if wire_dtype is not None and wire_dtype != t.dtype:
        w = t.to(wire_dtype)
        dist.all_reduce(w, group=group)
        return w.to(t.dtype)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_tree(tree: Dict, group) -> Dict:
    """Every leaf of a two-level {tower: {name: tensor}} tree summed over
    `group`, by one all_reduce a dtype (the leaves flattened into one
    buffer)."""
    if group is None:
        return tree
    _enter(group)
    leaves = [(t, k) for t, tp in tree.items() for k in tp]
    out = {t: {} for t in tree}
    by_dtype: Dict[torch.dtype, list] = {}
    for t, k in leaves:
        by_dtype.setdefault(tree[t][k].dtype, []).append((t, k))
    for names in by_dtype.values():
        flat = torch.cat([tree[t][k].reshape(-1) for t, k in names])
        dist.all_reduce(flat, group=group)
        at = 0
        for t, k in names:
            n = tree[t][k].numel()
            out[t][k] = flat[at:at + n].view_as(tree[t][k])
            at += n
    return {t: {k: out[t][k] for k in tp} for t, tp in tree.items()}


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """[n * B, ...]: the group's ranks' t stacked in rank order."""
    if group is None:
        return t
    _enter(group)
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _quiet(dist.all_gather_into_tensor, out, t.contiguous(), group=group)
    return out


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """[B, ...]: this rank's block of rows of t summed over `group`."""
    if group is None:
        return t
    _enter(group)
    n = dist.get_world_size(group)
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _quiet(dist.reduce_scatter_tensor, out, t.contiguous(), group=group)
    return out


class AllReduceSum(torch.autograd.Function):
    """y = sum of x over `group`, whose every rank then holds the same
    cotangent of y (the ranks of a model group compute the same thing
    downstream): the backward passes it through, and each rank keeps the
    gradient of its own partial."""

    @staticmethod
    def forward(ctx, x, group, wire_dtype=None):
        return all_reduce(x, group, wire_dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllGather(torch.autograd.Function):
    """[n * B, ...] = the group's x in rank order; the backward sums the
    pool's cotangent over the group and keeps this rank's rows (the
    reduce-scatter that is the all-gather's transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None
