"""Time the port's lookup, gather and rank kernels beside other builds of
them, on one NVIDIA GPU.

    python -m dssm_tpu_torch.tools.eval_kernels
        [--cases eval|lookup|scatter|multihost] [--source NAME=DIR ...]

Builds the group's sources as they stand (`eval`: count.cu and rank.cu;
`lookup`: count.cu, joint.cu, gather.cu and embed.cu; `scatter`:
scatter.cu and scatter_sr.cu; `multihost`: joint.cu, tower.cu and
loss.cu) and, for each
--source, the same files in DIR (the same C entry points, e.g. an earlier
commit's csrc/, with the headers they include), all at once; holds every
build to the plain versions and says whether its outputs are bit-equal to
this tree's build; then times each with CUDA-graph replays (median of 11
replays of 20 calls, 5 for the rank count; L2-warm), builds in turns,
forward then backward through the list.

`--cases eval` (the default), the eval path's two heaviest kernels:

  - the count lookup at the `full` shapes: a 1024 x 384 compact2 (bf16 and
    f32), 1024 rows of K = 64 and of 32 lookups, about half live; and at
    narrow widths no preset has (bf16 h = 100, f32 h = 36);
  - at the cnn and lstm eval shapes: the first union-dedupe batch of the
    cnn toy corpus (16384 word rows of 8 a side) into bf16 compact2 blocks
    1024 (cnn) and 384 (lstm) wide;
  - the rank count over unit vectors of width 128 at 3276 (the smoke's eval
    pass), 6553 (`full`'s eval pairs) and 13107 (`multihost`'s).

Beside them, once a case: the plain version, and PyTorch calls as
yardsticks: the count matrix built and multiplied into compact2 (the same
function), and for the rank count `(q @ d.T > t).sum(1)` (the same
function) and cuBLAS's f32 product `q @ d.T` alone (TF32 off).

`--cases lookup`, the training path's lookup kernels:

  - the count lookup's backward at the `full` per-side step's shapes: the
    first per-side batch of the `full` preset's toy stream (1024 rows, d
    side K = 64, q side K = 32, into u2 = 1024 compact rows, h = 384), g
    f32 (the step's dtype) and bf16;
  - the joint lookup at the smoke's shape (the first union-dedupe batch of
    that stream over an f32 compact block of 256 slots x 8 rows, and over a
    bf16 one of 256 x 16), at the int8 step's (the int8 stream's batch over
    the dequantized f32 block, 256 slots x 32 rows = 8192 x 384) and at the
    cnn's (the first union-dedupe batch of the cnn toy stream's training
    split, 16384 word rows a side, over a 1024 x 8 x 1024 f32 block);
  - the gather at the `full` eval shape (256 slots of one 12 KB row group
    of the 500000 x 384 table: 8 f32, 16 bf16 or 32 int8 rows; the
    slots of the joint batches) and at the cnn shape (1024 slots of 8 rows
    of Wc [30000, 1024] f32), against `index_select` of the same rows;
  - the raw-index bag forward on the `full` raw batch (q side K = 32, d
    side K = 64, from the 500000 x 384 table) and on the cnn raw batch's
    doc side (16384 word rows of Kw = 8, from Wc [30000, 1024] and from
    the lstm's Win [30000, 384]), f32 and bf16 tables, against
    `F.embedding_bag`; and the count lookup on the same inputs (compact2 =
    the table), which must give the bag's bits; and the bag's weight
    gradient d_wgt on the same inputs with an f32 g, against
    `(table[idx] * g[..., None, :]).sum(-1)`, two calls bit-equal;
  - the kernels that share code with these two: the joint lookup's
    backward (csrc/segsum.cuh) at the `full` shapes with bf16 gradients,
    and the fused gather + joint lookup (the lookup warp body) from an f32
    table of 65536 rows with the same batch.

Beside them, once a case: the plain version, one PyTorch call of the same
function as a yardstick (`index_add_`; the count matrices built and
multiplied; `index_select`; `F.embedding_bag`), and the bound: the larger
of the bytes read and written once at 3.35 TB/s and the f32 FMAs at 67
TFLOP/s.

`--cases scatter`, the row-group scatters of a training step (in place;
timed on a copy of the table, each build's first call checked on a fresh
copy, bit-equal to the plain version):

  - the stochastic-rounding scatters of a bf16 or int8 table, at the
    smoke's shapes: the first batch of `chip_smoke.py`'s `full` stream (its
    32768-pair cut, split and frequency-remapped) deduped at 16-row (bf16)
    and 32-row (int8) groups, 256 slots of which 54 / 27 are real, into the
    500000 x 384 table; with all 256 slots real (distinct random groups),
    both dtypes; and at cnn width: a 30000 x 1024 bf16 table and the first
    batch of the cnn toy stream's training split deduped at 16-row groups
    (1024 slots);
  - the scatter-add (scatter.cu), f32 at the smoke's shape (the same
    stream deduped at 8-row groups, 256 slots) and with all 256 slots
    real, bf16 (rounded to nearest) at the 16-row batch, and f32 at the cnn
    and lstm widths (Wc [30000, 1024], Win [30000, 384]) with the cnn toy
    stream's first batch deduped at 8-row groups (1024 slots).

Beside them, once a case: the plain version (eager for the stochastic
rounding: its row mask cannot be captured), a PyTorch call (`index_add_`
of the real rows for the scatter-add, the same function; for the
stochastic rounding the `index_copy_` of the finished rows as a floor, not
the same function: no PyTorch call rounds stochastically), and the bound:
the bytes (each real group read and written once, its vals read once) at
3.35 TB/s; for the stochastic rounding the larger of those and the
instructions the kernel issues for them in this tree's build (`cuobjdump
-sass` of a thread's work over its elements, tools/sass.py), by class, at
the card's SM count and maximum SM clock.

`--cases multihost`, the kernels of a `multihost` step (model_parallel =
1: batch 65,536, 16,384 compact rows in 2048 slots of 8, one slot space
of 2048 rows; the 500000 x 384 table) at its shapes, the first batch of
its stream as chip_smoke.py's phase 6e builds it:

  - the fused gather + joint lookup, beside `index_select` and the two
    count matrices multiplied in (the lookup's library route);
  - the joint lookup's backward with f32 gradients, beside its two
    `index_add_`;
  - the tower with residuals at 131,072 rows (both sides stacked, bf16,
    300 -> 300 -> 128), beside the `addmm` + `tanh` chain keeping each
    layer's f32 activation;
  - the loss forward, dq and dd at 65,536^2 x 128 on unit rows (f32, TF32
    off), beside `F.cross_entropy(gamma * q @ d.T, arange(B))` and its
    autograd to q or to d (the forward inside the call), the gradients also
    after the forward kernel; the plain version on slices of 4096 query
    rows, eager; and a step's three loss kernels against one autograd call
    for both gradients.

Every case also reports the device memory each call takes above what was
allocated before it (this tree's build, the plain version, each PyTorch
call); a PyTorch call that does not fit in the card's memory reads "does
not fit" with the allocation it asked for.

Prints the card's name and power limit, one line per case and a JSON line
last. Needs one GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import get_preset, validate
from dssm_tpu_torch.data import (
    ToyPairs, batch_iterator, hash_pairs, make_toy_pairs, train_eval_split)
from dssm_tpu_torch.data.remap import apply_remap, build_freq_remap
from dssm_tpu_torch.kernels import (
    _build, count, embed, gather, joint, rank, scatter_sr)
from dssm_tpu_torch.tools import sass

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # f32 outside the tensor cores
BF16_FLOPS = 989e12        # dense bf16 on the tensor cores
PAIRS = 4096  # of the toy corpus: the first batch is the step's own batch
SMOKE_PAIRS = 32768  # chip_smoke.py's cut of the `full` toy corpus
# The scatter kernels' names in csrc/scatter_sr.cu's SASS, and the elements
# a thread updates: kUnits units of 4 (a Philox call each) in its Op.
SR_KERNELS = {"scatter_sr_row_groups": ("scatter_sr_kernel", "Bf16"),
              "scatter_sr_int8_row_groups": ("scatter_sr_kernel", "Int8")}
SR_THREAD_ELEMENTS = {"scatter_sr_row_groups": 8,
                      "scatter_sr_int8_row_groups": 16}


def build(dirs, sources, out):
    """{name: path of its shared library}, compiled in parallel from the
    `sources` (file names) of this tree's csrc/ and of each (name, dir) of
    dirs, under build/eval_kernels/<out>/<name>/."""
    builds = {"tree": _build.CSRC}
    builds.update({n: os.path.abspath(p) for n, p in dirs})
    root = os.path.join(_build.BUILD_DIR, "eval_kernels", out)
    with ThreadPoolExecutor(len(builds)) as ex:
        return dict(zip(builds, ex.map(
            lambda kv: _build.compile_library(
                [os.path.join(kv[1], s) for s in sources],
                os.path.join(root, kv[0], "lib.so")),
            builds.items())))


def graph_ms(fn, reps=20, replays=11):
    """Device ms per call: `reps` calls in a CUDA graph, median replay."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def eager_ms(fn, reps=5, trials=3):
    """Device ms per call launched eagerly from Python (host included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def eval_cases(dev, rng, libs=None):
    """(name, kernel call, plain call, tolerance check, reps, {yardstick
    name: PyTorch call}, {more of the case's record}) per case."""
    def lookup_case(name, c2, inv, wgt):
        def near(got, want):
            if c2.dtype == torch.float32:
                return bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5
                             * float(want.abs().max())).all())
            return bool(((got - want).abs() <= 1e-2 * want.norm(
                dim=-1, keepdim=True)).all())
        return (name, lambda: count.count_lookup(c2, inv, wgt, impl="kernel"),
                lambda: count.count_lookup_plain(c2, inv, wgt), near, 20,
                {"library": lambda: count.count_matrix(
                    inv, wgt, c2.shape[0]) @ c2.float()}, {})

    out = []
    for k in (64, 32):
        inv = rng.integers(0, 1024, size=(1024, k)).astype(np.int32)
        wgt = rng.integers(1, 4, size=(1024, k)).astype(np.float32)
        wgt[np.arange(k)[None, :] >= rng.integers(0, k + 1, size=(1024, 1))] = 0
        inv, wgt = torch.from_numpy(inv).to(dev), torch.from_numpy(wgt).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            c2 = torch.from_numpy(rng.normal(size=(1024, 384)).astype(
                np.float32)).to(dev, dtype)
            out.append(lookup_case(f"count_lookup full K={k} "
                                   f"{str(dtype).split('.')[-1]}", c2, inv,
                                   wgt))
    # Narrow rows no preset has: bf16 h = 100 (no whole 16-byte vectors: one
    # column at a time) and f32 h = 36 (9 vectors a row), K = 32.
    for h, dtype in ((100, torch.bfloat16), (36, torch.float32)):
        c2 = torch.from_numpy(rng.normal(size=(1024, h)).astype(
            np.float32)).to(dev, dtype)
        out.append(lookup_case(f"count_lookup K=32 h={h} "
                               f"{str(dtype).split('.')[-1]}", c2, inv, wgt))
    sc = validate(get_preset("cnn"))
    pairs = make_toy_pairs(sc.data.toy_num_pairs, sc.data.toy_vocab_words,
                           sc.data.seed)
    train_p, _ = train_eval_split(pairs, eval_frac=sc.data.eval_frac,
                                  seed=sc.data.seed)
    tb = batch_to_torch(next(batch_iterator(
        hash_pairs(train_p, sc.tower, sc.data), sc.train.batch_size, True,
        seed=sc.train.seed, dedup_unique=sc.data.max_unique, dedup_group=8,
        dedup_unique_rows=sc.data.max_unique_rows, dedup_joint=True)), dev)
    for arch, h in (("cnn", 1024), ("lstm", 384)):
        c2 = torch.from_numpy(rng.normal(size=(tb["sel"].numel(), h)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for side in ("d", "q"):
            inv = tb[f"{side}_inv"].contiguous()
            wgt = tb[f"{side}_wgt"].contiguous()
            out.append(lookup_case(
                f"count_lookup {arch} {side} side bf16 ({int((wgt != 0).sum())}"
                " live)", c2, inv, wgt))
    for n in (3276, 6553, 13107):
        q = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
            size=(n, 128)).astype(np.float32)).to(dev), dim=1)
        d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
            size=(n, 128)).astype(np.float32)).to(dev), dim=1)
        d = torch.nn.functional.normalize(d + 0.35 * q, dim=1).contiguous()
        gap = (q @ d.T - rank.true_scores(q, d)[:, None]).abs()
        gap[torch.arange(n), torch.arange(n)] = 1.0
        ties = (gap < 1e-5).sum(dim=1).to(torch.int32)
        del gap
        t = rank.true_scores(q, d)[:, None]
        out.append((f"rank_counts {n} x {n} x 128",
                    lambda q=q, d=d: rank.rank_counts(q, d, impl="kernel"),
                    lambda q=q, d=d: rank.rank_counts_plain(q, d),
                    lambda got, want, ties=ties: bool(
                        ((got - want).abs() <= ties).all()), 5,
                    {"library": lambda q=q, d=d, t=t: (q @ d.T > t).sum(1),
                     "cublas_product_alone": lambda q=q, d=d: q @ d.T}, {}))
    return out


def padded(width):
    """A table's width padded to whole 128 lanes, as the model's tables are
    (`full`: W0 [500000, 384]; cnn: Wc [30000, 1024])."""
    return -(-width // 128) * 128


def bound_us(nbytes, fmas, flops_per_s=F32_FLOPS):
    return max(nbytes / HBM_BYTES_PER_S, 2.0 * fmas / flops_per_s) * 1e6


def _near(scale_of):
    """Within 1e-5 of the largest |value| of the plain version."""
    def near(got, want):
        got, want = [x if isinstance(x, tuple) else (x,) for x in (got, want)]
        tol = 1e-5 * max(float(scale_of(w)) for w in want)
        return all(float((a - b).abs().max()) <= tol
                   for a, b in zip(got, want))
    return near


def _batches(preset, stream_kw, n_pairs=None, split=False):
    """The first batch of each stream (dict of batch_iterator arguments)
    over the preset's toy corpus: cut to n_pairs and frequency-remapped;
    with split, of the cut's training split, as chip_smoke.py trains
    `full`; or, without n_pairs, of the corpus's training split, as
    chip_smoke.py trains the sequence presets."""
    cfg = validate(get_preset(preset))
    pairs = make_toy_pairs(cfg.data.toy_num_pairs, cfg.data.toy_vocab_words,
                           cfg.data.seed)
    if n_pairs is not None:
        pairs = ToyPairs(queries=pairs.queries[:n_pairs],
                         titles=pairs.titles[:n_pairs])
    if n_pairs is None or split:
        pairs, _ = train_eval_split(pairs, eval_frac=cfg.data.eval_frac,
                                    seed=cfg.data.seed)
    hashed = hash_pairs(pairs, cfg.tower, cfg.data)
    if n_pairs is not None:
        hashed = apply_remap(hashed, build_freq_remap(hashed,
                                                      cfg.tower.vocab_size))
    out = {}
    for name, kw in stream_kw.items():
        out[name] = next(batch_iterator(
            hashed, cfg.train.batch_size, seed=cfg.train.seed,
            **{"dedup_unique": cfg.data.max_unique,
               "dedup_unique_rows": cfg.data.max_unique_rows, **kw}))
    return cfg, out


def lookup_cases(dev, rng, libs=None):
    """(name, kernel call, plain call, tolerance check, reps, {yardstick
    name: PyTorch call}, {"bound_us": the case's bound, "what": its
    inputs}) per case."""
    def normal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dtype)

    cfg, full = _batches("full", {
        name: dict(dedup_group=grp, dedup_joint=jnt, wire_compress=True,
                   sort_rows=True)
        for name, grp, jnt in (("per_side", 8, False), ("joint8", 8, True),
                               ("joint16", 16, True), ("joint32", 32, True))}
        | {"raw": dict(dedup_unique=None)}, PAIRS)
    h = padded(cfg.tower.embed_width)
    out = []
    ps = batch_to_torch(full["per_side"], dev)
    for side in ("d", "q"):
        inv = ps[f"{side}_inv"].contiguous()
        wgt = ps[f"{side}_wgt"].contiguous()
        u2 = ps[f"{side}_sel"].numel()
        rows, k = inv.shape
        valid = (inv >= 0) & (inv < u2)
        idx = torch.where(valid, inv, 0).long().reshape(-1)
        w0 = torch.where(valid, wgt, 0.0)
        nnz = int(((wgt != 0) & valid).sum())
        for gd in (torch.float32, torch.bfloat16):
            g = normal(rows, h, dtype=gd)
            out.append((
                f"count_lookup_bwd full {side} side K={k} g "
                f"{str(gd).split('.')[-1]}",
                lambda inv=inv, wgt=wgt, g=g, u2=u2: count.count_lookup_bwd(
                    inv, wgt, g, u2, impl="kernel"),
                lambda inv=inv, wgt=wgt, g=g, u2=u2:
                    count.count_lookup_bwd_plain(inv, wgt, g, u2),
                _near(lambda w: w.abs().max()),
                {"library": lambda idx=idx, w0=w0, g=g, u2=u2: torch.zeros(
                    (u2, h), device=dev).index_add_(0, idx, (
                        w0[..., None] * g.float()[:, None, :]).reshape(-1, h))},
                bound_us(inv.numel() * 8 + g.numel() * g.element_size()
                         + u2 * h * 4, nnz * h),
                f"{nnz} live lookups, u2 {u2}"))

    def joint_case(name, compact, fields):
        sel, q_inv, q_wgt, d_inv, d_wgt = fields
        u2 = sel.numel()
        live = [(w != 0) & (i >= 0) & (i < u2) for i, w in
                ((q_inv, q_wgt), (d_inv, d_wgt))]
        rows_named = torch.unique(torch.cat([
            sel.long()[q_inv[live[0]].long()],
            sel.long()[d_inv[live[1]].long()]])).numel()
        nnz = int(live[0].sum() + live[1].sum())
        n_rows = q_inv.numel() // q_inv.shape[-1]
        hh = compact.shape[1]

        def library():
            cq = count.count_matrix(q_inv, q_wgt, u2)
            cd = count.count_matrix(d_inv, d_wgt, u2)
            c2 = joint.select_rows_plain(compact.float(), sel)
            return ((cq @ c2).reshape(*q_inv.shape[:-1], hh),
                    (cd @ c2).reshape(*d_inv.shape[:-1], hh))

        return (name,
                lambda: joint.joint_lookup(compact, *fields, impl="kernel"),
                lambda: joint.joint_lookup_plain(compact, *fields),
                _near(lambda w: w.abs().max()), {"library": library},
                bound_us((q_inv.numel() + d_inv.numel()) * 8 + u2 * 4
                         + rows_named * hh * compact.element_size()
                         + 2 * n_rows * hh * 4, nnz * hh),
                f"compact {tuple(compact.shape)} {compact.dtype}, {nnz} live "
                f"lookups on {rows_named} rows")

    for key, dtype, what in (("joint8", torch.float32, "full f32 compact"),
                             ("joint16", torch.bfloat16, "full bf16 compact"),
                             ("joint32", torch.float32,
                              "int8 step (dequantized f32 compact)")):
        tb = batch_to_torch(full[key], dev)
        grp = int(key[5:])
        fields = [tb[f].contiguous() for f in ("sel", "q_inv", "q_wgt",
                                                "d_inv", "d_wgt")]
        compact = normal(tb["uniq"].numel() * grp, h, dtype=dtype)
        out.append(joint_case(f"joint_lookup {what}", compact, fields))
        if key != "joint8":
            continue
        # The kernels that share code with the two above: the joint
        # backward (segsum.cuh) with the step's bf16 gradients, and the
        # fused gather + joint lookup (the lookup warp) on an f32 table.
        gr = compact.shape[0]
        g_q, g_d = (normal(*fields[1].shape[:-1], h, dtype=torch.bfloat16)
                    for _ in range(2))
        flat = [fields[0].long()[torch.where(
            (i >= 0) & (i < fields[0].numel()), i, 0).long()].reshape(-1)
            for i in (fields[1], fields[3])]
        nnz = int((fields[2] != 0).sum() + (fields[4] != 0).sum())

        def bwd_library(fields=fields, g_q=g_q, g_d=g_d, flat=flat, gr=gr):
            dc = torch.zeros((gr, h), device=dev)
            for fl, w, g in ((flat[0], fields[2], g_q),
                             (flat[1], fields[4], g_d)):
                dc.index_add_(0, fl, (w[..., None] * g.float()[
                    :, None, :]).reshape(-1, h))
            return dc

        out.append((
            "joint_lookup_bwd full bf16 g",
            lambda fields=fields, g_q=g_q, g_d=g_d, gr=gr:
                joint.joint_lookup_bwd(*fields, g_q, g_d, gr, impl="kernel"),
            lambda fields=fields, g_q=g_q, g_d=g_d, gr=gr:
                joint.joint_lookup_bwd_plain(*fields, g_q, g_d, gr),
            _near(lambda w: w.abs().max()), {"library": bwd_library},
            bound_us((fields[1].numel() + fields[3].numel()) * 8
                     + fields[0].numel() * 4 + 2 * g_q.numel() * 2
                     + gr * h * 4, nnz * h),
            f"dc ({gr}, {h}), {nnz} live lookups"))
        table = normal(1 << 16, h)  # 8192 groups of 8 rows
        u = tb["uniq"]
        real = (u >= 0) & (u < cfg.tower.vocab_size // grp)
        uniq = torch.where(real, torch.remainder(u, table.shape[0] // grp),
                           u)  # the batch's groups folded into the table
        out.append((
            "fused_gather_joint_lookup full f32 table",
            lambda table=table, uniq=uniq, fields=fields, grp=grp:
                joint.fused_gather_joint_lookup(table, uniq, *fields, grp,
                                                impl="kernel"),
            lambda table=table, uniq=uniq, fields=fields, grp=grp:
                joint.fused_gather_joint_lookup_plain(table, uniq, *fields,
                                                      grp),
            _near(lambda w: w.abs().max()), {},
            bound_us((fields[1].numel() + fields[3].numel()) * 8
                     + fields[0].numel() * 4
                     + (int(real.sum()) + uniq.numel()) * grp * h * 4
                     + 2 * fields[1].shape[0] * h * 4, nnz * h),
            f"table {tuple(table.shape)}, {uniq.numel()} slots of {grp}"))

    def gather_case(what, tbl, uniq, grp):
        ng = tbl.shape[0] // grp
        real = (uniq >= 0) & (uniq < ng)
        rows = (torch.where(real, uniq, 0).long()[:, None] * grp
                + torch.arange(grp, device=dev)).reshape(-1)
        group_bytes = grp * tbl.shape[1] * tbl.element_size()
        return (f"gather_row_groups {what}",
                lambda: gather.gather_row_groups(tbl, uniq, grp,
                                                 impl="kernel"),
                lambda: gather.gather_row_groups_plain(tbl, uniq, grp),
                lambda got, want: bool(torch.equal(got, want)),
                {"library": lambda: tbl.index_select(0, rows)},
                bound_us((int(real.sum()) + uniq.numel()) * group_bytes
                         + uniq.numel() * 4, 0),
                f"{uniq.numel()} slots of {grp} rows, {int(real.sum())} real")

    def bag_cases(what, tbl, idx, wgt):
        """The bag forward, with F.embedding_bag beside it, and the count
        lookup on the same inputs (compact2 = the table), which must give
        the bag's bits."""
        k = idx.shape[-1]
        rows, hh = idx.numel() // k, tbl.shape[1]
        live = wgt != 0
        nnz = int(live.sum())
        bound = bound_us(idx.numel() * 8 + torch.unique(idx[live]).numel()
                         * hh * tbl.element_size() + rows * hh * 4, nnz * hh)
        idx2, w2 = idx.reshape(rows, k).long(), wgt.reshape(rows, k).to(
            tbl.dtype)
        near = _near(lambda w: w.abs().max())
        name = f"{what} {str(tbl.dtype).split('.')[-1]}"
        desc = (f"table {tuple(tbl.shape)}, idx {tuple(idx.shape)}, {nnz} "
                "live lookups")
        # d_wgt reads idx and g and each distinct row the lookups name
        # (padding's row 0 too), and writes [rows, K] f32.
        g = normal(*idx.shape[:-1], hh)
        idx_l = idx.long()
        dwgt_bound = bound_us(idx.numel() * 8 + rows * hh * 4
                              + torch.unique(idx[(idx >= 0) & (
                                  idx < tbl.shape[0])]).numel() * hh
                              * tbl.element_size(), idx.numel() * hh)

        def dwgt():
            return embed.embedding_bag_dwgt(tbl, idx, g, impl="kernel")

        return [
            (f"embedding_bag_dwgt {name}", dwgt,
             lambda: embed.embedding_bag_dwgt_plain(tbl, idx, g),
             lambda got, want: near(got, want) and bool(torch.equal(
                 got, dwgt())),
             {"library": lambda: (tbl[idx_l] * g[..., None, :]).sum(-1)},
             dwgt_bound, f"{desc}, g f32"),
            (f"embedding_bag {name}",
             lambda: embed._forward_kernel(tbl, idx, wgt),
             lambda: embed.embedding_bag_plain(tbl, idx, wgt), near,
             {"library": lambda: torch.nn.functional.embedding_bag(
                 idx2, tbl, per_sample_weights=w2, mode="sum")}, bound, desc),
            (f"count_lookup on the bag's inputs {name}",
             lambda: count.count_lookup(tbl, idx, wgt, impl="kernel"),
             lambda: embed.embedding_bag_plain(tbl, idx, wgt),
             lambda got, want: near(got, want) and bool(torch.equal(
                 got, embed._forward_kernel(tbl, idx, wgt))), {}, bound,
             desc)]

    # The gather at the `full` eval shape (256 slots of one 12 KB row group
    # of the 500000 x 384 table: 8 f32, 16 bf16 or 32 int8 rows) and the
    # bag on the `full` raw batch (q side K = 32, d side K = 64).
    w0 = {torch.float32: normal(cfg.tower.vocab_size, h)}
    w0[torch.bfloat16] = w0[torch.float32].to(torch.bfloat16)
    w0[torch.int8] = torch.from_numpy(rng.integers(
        -127, 128, size=(cfg.tower.vocab_size, h), dtype=np.int8)).to(dev)
    for key, dtype in (("joint8", torch.float32), ("joint16", torch.bfloat16),
                       ("joint32", torch.int8)):
        out.append(gather_case(f"full {str(dtype).split('.')[-1]}",
                               w0[dtype], batch_to_torch(full[key], dev)[
                                   "uniq"], int(key[5:])))
    raw = batch_to_torch(full["raw"], dev)
    for side in ("q", "d"):
        idx, wgt = (raw[f"{side}_{f}"].contiguous() for f in ("idx", "wgt"))
        for dtype in (torch.float32, torch.bfloat16):
            out += bag_cases(f"full {side} side K={idx.shape[-1]}", w0[dtype],
                             idx, wgt)
    del w0

    ccfg, cnn = _batches("cnn", {
        "joint": dict(sequence=True, dedup_group=8, dedup_joint=True),
        "raw": dict(sequence=True, dedup_unique=None)})
    tb = batch_to_torch(cnn["joint"], dev)
    hc = padded(ccfg.tower.conv_window * ccfg.tower.conv_channels)
    wc = normal(ccfg.tower.vocab_size, hc)
    uniq = tb["uniq"]
    fields = [tb[f].contiguous() for f in ("sel", "q_inv", "q_wgt", "d_inv",
                                            "d_wgt")]
    compact = gather.gather_row_groups(wc, uniq, 8, impl="kernel")
    out.append(joint_case("joint_lookup cnn f32 compact", compact, fields))
    out.append(gather_case("cnn float32", wc, uniq, 8))
    # The bag on the cnn raw batch's doc side (1024 x 16 words of Kw = 8)
    # from Wc and from the lstm's Win [30000, 384].
    raw = batch_to_torch(cnn["raw"], dev)
    idx, wgt = raw["d_idx"].contiguous(), raw["d_wgt"].contiguous()
    win = normal(ccfg.tower.vocab_size, padded(ccfg.tower.embed_width))
    for what, tbl in (("cnn", wc), ("lstm", win)):
        for dtype in (torch.float32, torch.bfloat16):
            out += bag_cases(f"{what} raw d side", tbl.to(dtype), idx, wgt)
    return [(name, kernel, plain, near, 20, calls,
             {"bound_us": round(bound, 2), "what": what})
            for name, kernel, plain, near, calls, bound, what in out]


def peak_gb(fn):
    """Device GB one call of fn takes above what was allocated before it
    (its outputs and its temporaries)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return round((torch.cuda.max_memory_allocated() - base) / 1e9, 3)


def run(libs, case_list):
    """{case: {us: {build or yardstick: [us, ...]}, bit_equal_to_tree:
    {...}, peak_above_resident_gb: {this tree's build, the plain version
    and each yardstick: GB}, ...}} for the builds in libs (bit-equality is
    to the first, this tree's), holding every build to the plain version;
    builds in turns, forward then backward through the list, the plain
    version and the yardsticks once (a yardstick that does not fit in the
    card's memory reads "does not fit" with its request). Prints a line a
    case."""
    results = {}
    for name, kernel, plain, near, reps, calls, more in case_list:
        # A case may time another call than the one it checks (an in-place
        # kernel on a copy it keeps), and time some calls eagerly.
        more = dict(more)
        timed, eager = more.pop("timed", kernel), more.pop("eager", ())
        want = plain()
        row, same, peak, ref = {}, {}, {}, None
        order = list(libs) + list(reversed(list(libs)))
        for i, build_name in enumerate(order):
            _build.load(libs[build_name])  # the wrappers launch through it
            got = kernel()
            torch.cuda.synchronize()
            if not near(got, want):
                raise RuntimeError(f"{build_name}, {name}: differs from the "
                                   "plain version beyond its tolerance")
            ref = got if ref is None else ref
            same[build_name] = all(
                torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)))
            row.setdefault(build_name, []).append(
                round(graph_ms(timed, reps=reps) * 1e3, 2))
            if i == len(libs) - 1:
                for call_name, call in {"plain": plain, **calls}.items():
                    try:
                        peak[call_name] = peak_gb(call)
                    except torch.OutOfMemoryError as e:
                        if call_name == "plain":
                            raise
                        # A yardstick too large for the card: its request.
                        row[call_name] = "does not fit: " + ". ".join(
                            str(e).split(". ")[:3])
                        torch.cuda.empty_cache()
                        continue
                    row[call_name] = [round((
                        eager_ms(call) if call_name in eager
                        else graph_ms(call, reps=reps)) * 1e3, 2)]
        peak["tree"] = peak_gb(kernel)  # the turns end on this tree's build
        results[name] = dict(us=row, bit_equal_to_tree=same,
                             peak_above_resident_gb=peak, **more)
        print(f"{name} (us, each build twice): {json.dumps(results[name])}",
              flush=True)
    return results


def sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def sr_instructions(lib):
    """{kernel: {class: instructions an element}} of the two scatter
    kernels in the shared library `lib`: a thread's SASS over its
    elements."""
    return {k: {c: n / SR_THREAD_ELEMENTS[k] for c, n in v.items()}
            for k, v in sass.library_counts(lib, SR_KERNELS).items()}


def scatter_bytes(real_slots, slots, group_elems, itemsize, vals_itemsize):
    """Bytes a row-group scatter call must move: each real group read and
    written once (itemsize an element), its vals read once, every slot's
    id read once."""
    return (real_slots * group_elems * (2 * itemsize + vals_itemsize)
            + slots * 4)


def add_bound_us(real_slots, slots, group_elems, itemsize):
    """Bound (bytes) of one scatter-add call, vals of the table's dtype."""
    return scatter_bytes(real_slots, slots, group_elems, itemsize,
                         itemsize) / HBM_BYTES_PER_S * 1e6


def sr_bound_us(per_element, real_slots, slots, group_elems, itemsize, sms,
                clock_hz):
    """(bound us, "bytes" or "operations", bytes us, issue us) of one
    stochastic-rounding scatter call: each real group read and written once
    and its f32 vals read once, against the kernel's instructions for its
    elements."""
    elements = real_slots * group_elems
    by_issue = sass.issue_bound_us(per_element, elements, sms, clock_hz)
    by_bytes = scatter_bytes(real_slots, slots, group_elems, itemsize,
                             4) / HBM_BYTES_PER_S * 1e6
    return (max(by_bytes, by_issue),
            "bytes" if by_bytes >= by_issue else "operations", by_bytes,
            by_issue)


def scatter_cases(dev, rng, libs):
    """As lookup_cases, for the row-group scatters."""
    per_element = sr_instructions(libs["tree"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    print(f"scatter kernels, instructions an element (cuobjdump -sass of "
          f"this tree's build): {json.dumps(per_element)}; {sms} SMs at "
          f"{clock / 1e6:.0f} MHz", flush=True)
    kinds = {torch.bfloat16: ("scatter_sr_row_groups", 16,
                              scatter_sr.scatter_sr_row_groups,
                              scatter_sr.scatter_sr_row_groups_plain),
             torch.int8: ("scatter_sr_int8_row_groups", 32,
                          scatter_sr.scatter_sr_int8_row_groups,
                          scatter_sr.scatter_sr_int8_row_groups_plain)}

    def table(rows, h, dtype):
        if dtype == torch.int8:
            return torch.from_numpy(rng.integers(
                -100, 101, size=(rows, h), dtype=np.int8)).to(dev)
        return torch.from_numpy((rng.normal(size=(rows, h)) * 0.05).astype(
            np.float32)).to(dev, dtype)

    def case(what, tbl, gids):
        name, grp, fn, plain = kinds[tbl.dtype]
        h, slots = tbl.shape[1], gids.numel()
        shape = (slots * grp, h)
        if tbl.dtype == torch.int8:
            vals = rng.uniform(-3, 3, size=shape)
        else:
            vals = rng.normal(size=shape) * 1e-4
        vals = torch.from_numpy(vals.astype(np.float32)).to(dev)
        real = (gids >= 0) & (gids < tbl.shape[0] // grp)
        rows = (gids[real].long()[:, None] * grp
                + torch.arange(grp, device=dev)).reshape(-1)
        work = tbl.clone()
        finished = work[rows].clone()
        # The seeds on the card, as the train step passes them (an int
        # seed is a synchronising copy, which a graph capture refuses).
        s5, s12345 = (torch.tensor([s], dtype=torch.int32, device=dev)
                      for s in (5, 12345))
        bound, by, by_bytes, by_issue = sr_bound_us(
            per_element[name], int(real.sum()), slots, grp * h,
            tbl.element_size(), sms, clock)
        return (f"{name} {what}",
                lambda: fn(tbl.clone(), gids, vals, grp, s12345,
                           impl="kernel"),
                lambda: plain(tbl.clone(), gids, vals, grp, s12345),
                lambda got, want: bool(torch.equal(got, want)), 20,
                {"plain": lambda: plain(work, gids, vals, grp, s5),
                 "index_copy_floor": lambda: work.index_copy_(0, rows,
                                                              finished)},
                {"timed": lambda: fn(work, gids, vals, grp, s5,
                                     impl="kernel"),
                 "eager": ("plain",), "bound_us": round(bound, 3),
                 "bound_by": by, "bytes_us": round(by_bytes, 3),
                 "issue_us": round(by_issue, 3),
                 "what": f"table {tuple(tbl.shape)} {tbl.dtype}, {slots} "
                         f"slots of {grp} rows, {int(real.sum())} real"})

    def add_case(what, tbl, gids, grp):
        h, slots = tbl.shape[1], gids.numel()
        vals = torch.from_numpy((rng.normal(size=(slots * grp, h)) * 1e-3)
                                .astype(np.float32)).to(dev, tbl.dtype)
        real = (gids >= 0) & (gids < tbl.shape[0] // grp)
        rows = (gids[real].long()[:, None] * grp
                + torch.arange(grp, device=dev)).reshape(-1)
        real_vals = vals.reshape(slots, grp, h)[real].reshape(-1, h)
        work = tbl.clone()
        return (f"scatter_add_row_groups {what}",
                lambda: gather.scatter_add_row_groups(tbl.clone(), gids, vals,
                                                      grp, impl="kernel"),
                lambda: gather.scatter_add_row_groups_plain(tbl.clone(), gids,
                                                            vals, grp),
                lambda got, want: bool(torch.equal(got, want)), 20,
                {"plain": lambda: gather.scatter_add_row_groups_plain(
                    work, gids, vals, grp),
                 "library": lambda: work.index_add_(0, rows, real_vals)},
                {"timed": lambda: gather.scatter_add_row_groups(
                    work, gids, vals, grp, impl="kernel"),
                 "bound_us": round(add_bound_us(
                     int(real.sum()), slots, grp * h, tbl.element_size()), 3),
                 "bound_by": "bytes",
                 "what": f"table {tuple(tbl.shape)} {tbl.dtype}, {slots} "
                         f"slots of {grp} rows, {int(real.sum())} real"})

    cfg, full = _batches("full", {
        grp: dict(dedup_group=grp, dedup_joint=True, wire_compress=True,
                  sort_rows=True) for grp in (8, 16, 32)}, SMOKE_PAIRS,
        split=True)
    h = padded(cfg.tower.embed_width)
    out = []
    for dtype, (_, grp, _, _) in kinds.items():
        tbl = table(cfg.tower.vocab_size, h, dtype)
        gids = batch_to_torch(full[grp], dev)["uniq"]
        out.append(case("smoke (full, first batch)", tbl, gids))
        every = np.sort(rng.choice(tbl.shape[0] // grp, gids.numel(),
                                   replace=False)).astype(np.int32)
        out.append(case("full, every slot real", tbl,
                        torch.from_numpy(every).to(dev)))
        if dtype == torch.bfloat16:
            out.append(add_case("smoke (full, first batch) bf16", tbl, gids,
                                grp))
        del tbl
    tbl = table(cfg.tower.vocab_size, h, torch.float32)
    gids = batch_to_torch(full[8], dev)["uniq"]
    out.append(add_case("smoke (full, first batch) f32", tbl, gids, 8))
    every = np.sort(rng.choice(tbl.shape[0] // 8, gids.numel(),
                               replace=False)).astype(np.int32)
    out.append(add_case("full, every slot real f32", tbl,
                        torch.from_numpy(every).to(dev), 8))
    del tbl
    ccfg, cnn = _batches("cnn", {
        grp: dict(sequence=True, dedup_group=grp, dedup_joint=True)
        for grp in (8, 16)})
    wc_width = padded(ccfg.tower.conv_window * ccfg.tower.conv_channels)
    wc = table(ccfg.tower.vocab_size, wc_width, torch.bfloat16)
    out.append(case("cnn width", wc, batch_to_torch(cnn[16], dev)["uniq"]))
    gids = batch_to_torch(cnn[8], dev)["uniq"]
    for what, width in (("cnn", wc_width),
                        ("lstm", padded(ccfg.tower.embed_width))):
        out.append(add_case(f"{what} width f32", table(
            ccfg.tower.vocab_size, width, torch.float32), gids, 8))
    return out


def multihost_cases(dev, rng, libs):
    """As lookup_cases, for the kernels of a `multihost` step at its
    shapes (model_parallel = 1: the first batch of the preset's stream, as
    chip_smoke.py's phase 6e builds it, and the 500000 x 384 table of a
    seeded init), the loss last: its library calls hold 17 GB logits."""
    import torch.nn.functional as F

    from dssm_tpu_torch.kernels import loss, tower
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.train.sparse_update import joint_fields, joint_row_sel

    _build.load(libs["tree"])  # the cases' inputs come through this build
    cfg, mh = _batches("multihost", {"joint": dict(
        dedup_group=8, dedup_joint=True, wire_compress=True, sort_rows=True,
        local_sel_cap=get_preset("multihost").data.max_unique_rows_local,
        reshuffle_each_epoch=False, cache_epoch_batches=True)},
        get_preset("multihost").data.toy_num_pairs, split=True)
    t = cfg.tower
    tb = batch_to_torch(mh["joint"], dev)
    fields = joint_fields(tb, joint_row_sel(tb))
    sel, q_inv, q_wgt, d_inv, d_wgt = fields
    params = model_base.init_params(t, seed=cfg.train.seed, device=dev)[
        "shared"]
    table, uniq = params["W0"], tb["uniq"]
    grp, h, u2 = 8, params["W0"].shape[1], sel.numel()
    gr = uniq.numel() * grp
    nnz = int((q_wgt != 0).sum() + (d_wgt != 0).sum())
    idx_bytes = (q_inv.numel() + d_inv.numel()) * 8 + u2 * 4
    near = _near(lambda w: w.abs().max())
    what = (f"multihost batch {q_inv.shape[0]} rows, {uniq.numel()} slots "
            f"of {grp} rows, {u2} local slots, {nnz} live lookups")
    out = []

    # Row 6: the fused gather + joint lookup; the library route gathers the
    # rows with index_select and multiplies the two count matrices in.
    real = (uniq >= 0) & (uniq < t.vocab_size // grp)
    rows = (torch.where(real, uniq, 0).long()[:, None] * grp
            + torch.arange(grp, device=dev)).reshape(-1)

    def fused_library():
        c = table.index_select(0, rows) * real.repeat_interleave(grp)[:, None]
        c2 = joint.select_rows_plain(c, sel)
        return (count.count_matrix(q_inv, q_wgt, u2) @ c2,
                count.count_matrix(d_inv, d_wgt, u2) @ c2)

    out.append((
        "fused_gather_joint_lookup multihost",
        lambda: joint.fused_gather_joint_lookup(table, uniq, *fields, grp,
                                                impl="kernel")[:2],
        lambda: joint.fused_gather_joint_lookup_plain(table, uniq, *fields,
                                                      grp)[:2],
        near, 20, {"library": fused_library},
        {"bound_us": round(bound_us(
            gr * h * 4 * 2 + idx_bytes + 2 * q_inv.shape[0] * h * 4,
            nnz * h), 2), "what": what}))

    # Row 5b: the joint backward at the step's f32 gradients; the library
    # route is two index_add_ into the compact gradient.
    lq, ld, _ = joint.fused_gather_joint_lookup(table, uniq, *fields, grp,
                                                impl="kernel")
    g_q, g_d = (torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(
        np.float32) * 1e-3).to(dev) for x in (lq, ld))
    flat = [sel.long()[torch.where((i >= 0) & (i < u2), i, 0).long()]
            .reshape(-1) for i in (q_inv, d_inv)]

    def bwd_library():
        dc = torch.zeros((gr, h), device=dev)
        for fl, w, g in ((flat[0], q_wgt, g_q), (flat[1], d_wgt, g_d)):
            dc.index_add_(0, fl, (w[..., None] * g[:, None, :]).reshape(
                -1, h))
        return dc

    out.append((
        "joint_lookup_bwd multihost",
        lambda: joint.joint_lookup_bwd(*fields, g_q, g_d, gr, impl="kernel"),
        lambda: joint.joint_lookup_bwd_plain(*fields, g_q, g_d, gr),
        near, 20, {"library": bwd_library},
        {"bound_us": round(bound_us(
            (g_q.numel() + g_d.numel() + gr * h) * 4 + idx_bytes, nnz * h),
            2), "what": what + ", g f32"}))

    # Row 4r: the tower with its residuals, both sides stacked (131,072
    # rows), on the step's layer-0 activations in bf16; the library route
    # is the addmm + tanh chain keeping each layer's f32 activation.
    bf = torch.bfloat16
    x = torch.tanh(torch.cat([lq, ld])[:, :t.embed_width].to(bf)
                   + params["b0"].to(bf)).contiguous()
    del lq, ld
    layers = [(params[f"W{i}"].to(bf), params[f"b{i}"].to(bf))
              for i in range(1, len(t.hidden_dims) + 2)]
    dims = [x.shape[1]] + [w.shape[1] for w, _ in layers]

    def tower_library():
        hh, keep = x, []
        for w, b in layers:
            hh = torch.tanh(torch.addmm(b, hh, w))
            keep.append(hh.float())
        return keep

    def y_and_residuals(y_hs):
        return (y_hs[0], *y_hs[1])

    out.append((
        f"dense_tower_residuals multihost {x.shape[0]} rows",
        lambda: y_and_residuals(tower.dense_tower_residuals(
            x, layers, "tanh", False, impl="kernel")),
        lambda: y_and_residuals(tower.dense_tower_residuals_plain(
            x, layers, "tanh", False)),
        lambda got, want: all(float((a - b).abs().max()) <= 2e-2
                              for a, b in zip(got, want)),
        20, {"library": tower_library},
        {"bound_us": round(bound_us(
            x.numel() * 2 + x.shape[0] * sum(dims[1:]) * 4 * 2,
            x.shape[0] * sum(a * b for a, b in zip(dims, dims[1:])),
            BF16_FLOPS), 2),
         "what": f"x {tuple(x.shape)} bf16, widths {dims}"}))

    # Rows 7, 7q, 7d: the loss kernels at 65,536^2 on unit vectors, f32,
    # TF32 off (main()); the plain version on slices of 4096 query rows
    # against the whole pool (its full logits would be 17 GB a tensor);
    # the library route F.cross_entropy of the scaled cosine matrix of the
    # unit rows (the product inside the call, as inside the kernel; the
    # tower normalised them, so a normalize in the call would change the
    # gradient's function) and its autograd to q or to d, the forward
    # included, as chip_smoke.py times it at 1024^2.
    b, gam = cfg.train.batch_size, cfg.loss.gamma
    q = F.normalize(torch.from_numpy(rng.normal(size=(b, t.semantic_dim))
                                     .astype(np.float32)).to(dev), dim=1)
    d = F.normalize(q + torch.from_numpy(rng.normal(
        size=(b, t.semantic_dim)).astype(np.float32)).to(dev), dim=1)
    lab = torch.arange(b, dtype=torch.int32, device=dev)
    g = torch.full((b,), 1.0 / b, device=dev)
    lse = loss.in_batch_nll_kernel(q, d, lab, gam)[1]
    slices = [slice(lo, lo + 4096) for lo in range(0, b, 4096)]

    def plain(part):
        outs = []
        dd = torch.zeros_like(d)
        for sl in slices:
            nll, lse_s, _, _ = loss.in_batch_nll_plain(q[sl], d, lab[sl], gam)
            if part == "nll":
                outs.append(nll)
                continue
            dq_s, dd_s = loss.in_batch_loss_grads_plain(q[sl], d, lab[sl],
                                                        gam, lse_s, g[sl])
            outs.append(dq_s)
            dd += dd_s
        return dd if part == "dd" else torch.cat(outs)

    def plain_part(part):
        return (plain("dq"), plain("dd")) if part == "step" else plain(part)

    def library(grad_to=""):
        qq = q.detach().requires_grad_("q" in grad_to)
        dd = d.detach().requires_grad_("d" in grad_to)
        ce = F.cross_entropy(gam * (qq @ dd.T), lab.long())
        if not grad_to:
            return ce
        return torch.autograd.grad(ce, [x for x in (qq, dd)
                                        if x.requires_grad])

    def step_kernels():
        lse_ = loss.in_batch_nll_kernel(q, d, lab, gam)[1]
        return (loss.in_batch_loss_dq(q, d, lab, gam, lse_, g, impl="kernel"),
                loss.in_batch_loss_dd(q, d, lab, gam, lse_, g, impl="kernel"))

    # chip_smoke.py's tolerances: nll 1e-4, the gradients 1e-4 of their
    # largest element.
    near_loss = {"nll": lambda got, want: float((got - want).abs().max())
                 <= 1e-4}
    near_loss["dq"] = near_loss["dd"] = lambda got, want: float(
        (got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    near_loss["step"] = lambda got, want: all(
        near_loss["dq"](a, b) for a, b in zip(got, want))
    io = (q.numel() + d.numel()) * 4 + b * 12
    fwd_fmas = b * b * t.semantic_dim
    loss_what = f"q, d ({b}, {t.semantic_dim}) f32 unit rows, gamma {gam}"
    for name, kernel, part, fmas, lib, more in (
            ("in_batch_loss", lambda: loss.in_batch_nll_kernel(
                q, d, lab, gam)[0], "nll", fwd_fmas, library, {}),
            ("in_batch_loss_dq", lambda: loss.in_batch_loss_dq(
                q, d, lab, gam, lse, g, impl="kernel"), "dq", 2 * fwd_fmas,
             lambda: library("q")[0], {"with_forward": lambda: (
                 loss.in_batch_nll_kernel(q, d, lab, gam),
                 loss.in_batch_loss_dq(q, d, lab, gam, lse, g,
                                       impl="kernel"))}),
            ("in_batch_loss_dd", lambda: loss.in_batch_loss_dd(
                q, d, lab, gam, lse, g, impl="kernel"), "dd", 2 * fwd_fmas,
             lambda: library("d")[0], {"with_forward": lambda: (
                 loss.in_batch_nll_kernel(q, d, lab, gam),
                 loss.in_batch_loss_dd(q, d, lab, gam, lse, g,
                                       impl="kernel"))}),
            # A step's three kernels against one autograd call for both
            # gradients, the forward included.
            ("in_batch_loss + dq + dd", step_kernels, "step", 5 * fwd_fmas,
             lambda: library("qd"), {})):
        out.append((
            f"{name} multihost {b}^2", kernel,
            lambda part=part: plain_part(part),
            near_loss[part], 2, {"library": lib, **more},
            {"bound_us": round(bound_us(io, fmas), 2),
             **({"with_forward_bound_us": round(bound_us(
                 io, fmas + fwd_fmas), 2)} if more else {}),
             "eager": ("plain", "library", "with_forward"),
             "what": loss_what}))
    return out


GROUPS = {"eval": (("count.cu", "rank.cu"), eval_cases),
          "lookup": (("count.cu", "joint.cu", "gather.cu", "embed.cu"),
                     lookup_cases),
          "scatter": (("scatter.cu", "scatter_sr.cu"), scatter_cases),
          "multihost": (("joint.cu", "tower.cu", "loss.cu"),
                        multihost_cases)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", choices=sorted(GROUPS), default="eval",
                    help="the case group to time (default eval)")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR", help="a csrc/ with the group's "
                    "sources to time beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eval_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sources, group_cases = GROUPS[args.cases]
    libs = build([s.split("=", 1) for s in args.source], sources, args.cases)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 yardsticks
    results = run(libs, group_cases(torch.device("cuda"),
                                    np.random.default_rng(0), libs))
    _build.load(_build.build())
    print(json.dumps({f"{args.cases}_kernels_us": results,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
