"""Per-step collective traffic of the port's multi-device sparse step,
derived from the config and the mesh shape, re-derived for NVLink / NCCL.

Counterpart of dssm_tpu/parallel/comm_model.py, with its interface
(Term, step_collectives, scaling_efficiency). The terms are the
collectives that parallel/dist.py issues in one dedupe step of
parallel/sparse_step.py, in the order the step issues them:

  - mp > 1: the compact gather's all-reduce of the shards' partials over
    the model group (kernels/sharded_embed.py::gather_compact_sharded), a
    [max_unique // 8 * group, H] block a side (group: the table's row
    group, 8 / 16 / 32 rows at f32 / bf16 / int8), on a bf16 wire when the
    collective is bf16 and the table f32;
  - dp > 1, the global pool (or the rotate loss): the doc-pool all-gather
    over the data group (loss/cosine_softmax.py, dist.AllGather), the
    [B_global, D] f32 pool;
  - dp > 1: the loss and aux pmean (cosine_softmax._pmean), the loss and its
    three aux metrics in f32 (dssm_tpu's model does not list it);
  - dp > 1, global pool: the all-gather's backward, a reduce-scatter of the
    pool's gradient, the same bytes;
  - dp > 1: the lookup input's gradient all-reduce over the data group
    (sparse_step.py): in the sel basis, [max_unique_rows, H] on the wire's
    dtype (per-shard slot spaces, sel_basis_grad), else the group-padded
    compact block at the compact's own dtype (one a side on a per-side
    step);
  - dp > 1: the dense gradients' all-reduce (dist.all_reduce_tree: one
    flat buffer of every dense parameter).

The table's scatters are shard-local and the evals are not per step. A
group of one rank (dp = 1 or mp = 1 inside a process group) still has its
all-reduce issued; it moves no bytes, and the model leaves it out.

Exposure follows from the port's code too: parallel/dist.py calls every
collective synchronously (no async_op), so NCCL's kernels run on the
step's stream between its compute kernels and no compute overlaps any of
them. Every term is exposed; the overlap of the doc-pool all-gather that
dssm_tpu's model credits to XLA's scheduler does not happen here.

Link rates are datasheet figures, not measured: the card's machine has one
GPU and NCCL refuses two ranks on one GPU. NVLink 4 on an H100 SXM5 moves
900 GB/s a GPU both ways, 450 GB/s a direction (NVIDIA H100 datasheet);
between nodes each GPU has one 400 Gb/s NDR InfiniBand port, 50 GB/s a
direction (the DGX H100 layout). A group rides NVLink when its ranks lie on
one node of gpus_per_node consecutive ranks (parallel/mesh.py's data-major
grid: rank = d * mp + m), InfiniBand when one of the axis's groups spans
nodes. Ring times: an all-reduce moves 2 (p - 1) / p of its buffer, an
all-gather or reduce-scatter (p - 1) / p of the gathered total, over the
link rate; latencies are left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

NVLINK_BW = 450e9  # bytes/s a direction, NVLink 4, H100 SXM5 (datasheet)
IB_BW = 50e9       # bytes/s a direction, one NDR 400 Gb/s port a GPU
GPUS_PER_NODE = 8  # DGX H100

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


@dataclass
class Term:
    name: str
    mbytes: float
    ms: float
    exposed: bool
    note: str


def axis_bandwidth(axis: str, dp: int, mp: int,
                   gpus_per_node: int = GPUS_PER_NODE) -> float:
    """The link rate of the axis's collectives: NVLink when each of its
    groups lies on one node, else InfiniBand."""
    if axis == "data":
        groups = [[d * mp + m for d in range(dp)] for m in range(mp)]
    else:
        groups = [[d * mp + m for m in range(mp)] for d in range(dp)]
    spans = any(len({r // gpus_per_node for r in g}) > 1 for g in groups)
    return IB_BW if spans else NVLINK_BW


def _allreduce_ms(payload_bytes: float, p: int, bw: float) -> float:
    return 2 * (p - 1) / p * payload_bytes / bw * 1e3


def _allgather_ms(total_bytes: float, p: int, bw: float) -> float:
    return (p - 1) / p * total_bytes / bw * 1e3


def step_options(cfg) -> Dict:
    """The step_collectives keywords of the step the port runs at cfg: the
    sel-basis gradient when a joint batch carries per-shard slot spaces
    (data.max_unique_rows_local, as cli.train sets it), the wire's
    itemsize from mesh.collective_dtype."""
    return dict(
        sel_basis_grad=bool(cfg.data.max_unique_rows_local
                            and cfg.tower.shared_weights),
        collective_itemsize=_ITEMSIZE[cfg.mesh.collective_dtype])


def step_collectives(cfg, dp: int, mp: int, *,
                     sel_basis_grad: bool = False,
                     gather_allgather: bool = False,
                     collective_itemsize: int = 4,
                     gpus_per_node: int = GPUS_PER_NODE) -> List[Term]:
    """Every collective of ONE multi-device dedupe step, in issue order.

    cfg: the RunConfig. dp / mp: the mesh's axis sizes. sel_basis_grad:
    the gradient all-reduce in the sel basis (joint batches with per-shard
    slot spaces). collective_itemsize: the wire's bytes an element
    (mesh.collective_dtype); step_options(cfg) gives both as the port's
    step at cfg takes them. gather_allgather is dssm_tpu's what-if of an
    all-gather compact gather, which the port does not have.
    """
    if gather_allgather:
        raise ValueError(
            "the port's compact gather is an all-reduce of the shards' "
            "partials (kernels/sharded_embed.py); it has no all-gather "
            "variant")
    from dssm_tpu_torch.models.base import TABLE_KEY, arch_module

    t = cfg.tower
    shapes = arch_module(t).param_shapes(t)
    h = shapes[TABLE_KEY[t.arch]][1]
    table_itemsize = _ITEMSIZE[t.table_dtype_resolved or "float32"]
    # The compact block's dtype: the table's, an int8 table dequantized
    # to f32.
    compact_itemsize = 2 if table_itemsize == 2 else 4
    wire_itemsize = min(compact_itemsize, collective_itemsize)
    sides = [""] if t.shared_weights else [" q side", " d side"]
    towers = 1 if t.shared_weights else 2
    dense = towers * sum(int(np.prod(s)) for k, s in shapes.items()
                         if k != TABLE_KEY[t.arch]) * _ITEMSIZE[t.param_dtype]
    # Compact rows a side: the loader's group-slot budget max_unique // 8
    # at the table's row group (data/loader.py::add_dedup_fields).
    group = {4: 8, 2: 16, 1: 32}[table_itemsize]
    u1_rows = (cfg.data.max_unique // 8) * group
    u2 = cfg.data.max_unique_rows
    b_global = cfg.train.batch_size
    bw_model = axis_bandwidth("model", dp, mp, gpus_per_node)
    bw_data = axis_bandwidth("data", dp, mp, gpus_per_node)
    link = {NVLINK_BW: "NVLink", IB_BW: "InfiniBand"}
    terms: List[Term] = []

    if mp > 1:
        payload = u1_rows * h * min(table_itemsize, collective_itemsize)
        for side in sides:
            terms.append(Term(
                f"fwd compact gather (mp){side}: all-reduce of the partials",
                payload / 1e6, _allreduce_ms(payload, mp, bw_model), True,
                f"{u1_rows} rows x {h} x "
                f"{min(table_itemsize, collective_itemsize)} B over the "
                f"model group ({link[bw_model]}); synchronous, before the "
                "lookup"))

    if dp > 1:
        pooled = cfg.loss.mode == "rotate" or cfg.mesh.global_negatives
        pool = b_global * t.semantic_dim * 4
        if pooled:
            terms.append(Term(
                "doc-pool all-gather (data)", pool / 1e6,
                _allgather_ms(pool, dp, bw_data), True,
                f"the [{b_global}, {t.semantic_dim}] f32 pool over the data "
                f"group ({link[bw_data]}); synchronous, between the d tower "
                "and the loss kernels: no compute overlaps it"))
        vals = 4 * 4  # the loss and its three aux metrics, f32
        terms.append(Term(
            "loss and aux pmean (data): all-reduce", vals / 1e6,
            _allreduce_ms(vals, dp, bw_data), True,
            "4 f32 values; latency-bound"))
        if pooled:
            terms.append(Term(
                "loss bwd reduce-scatter (data)", pool / 1e6,
                _allgather_ms(pool, dp, bw_data), True,
                "the all-gather's transpose, the pool's gradient; "
                "synchronous, before the tower backward"))
        if sel_basis_grad and t.shared_weights:
            grows, gsize, basis = u2, wire_itemsize, " [sel basis]"
        else:
            grows, gsize, basis = u1_rows, compact_itemsize, \
                " [group-padded]"
        gpay = grows * h * gsize
        for side in sides:
            terms.append(Term(
                f"compact-grad psum (data){side}{basis}: all-reduce",
                gpay / 1e6, _allreduce_ms(gpay, dp, bw_data), True,
                f"{grows} rows x {h} x {gsize} B; the end of the backward, "
                "the scatter waits for it"))
        terms.append(Term(
            "dense-grad psum (data): all-reduce", dense / 1e6,
            _allreduce_ms(dense, dp, bw_data), True,
            f"every dense parameter, {dense} B in one flat buffer"))
    return terms


def scaling_efficiency(t_step_ms: float, cfg, dp: int, mp: int,
                       **kw) -> tuple:
    """(efficiency, exposed_ms, terms): t_compute / (t_compute + exposed)."""
    terms = step_collectives(cfg, dp, mp, **kw)
    exposed = sum(t.ms for t in terms if t.exposed)
    return t_step_ms / (t_step_ms + exposed), exposed, terms
