#!/usr/bin/env python3
"""Smoke run of dssm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from dssm_tpu_torch/csrc, holds each kernel
to its plain PyTorch version at the `full` preset's shapes and times both,
then drives the `full` preset end to end (500k x 384 table, towers
300->300->128 in bf16, batch 1024, union dedupe):

  - trains it from seeded fresh weights on the toy corpus's batch stream,
    12 steps through the kernels and the same steps from the same state
    through the plain versions, which must agree, with the loss falling
    (the joint step's lookup on an f32 or bf16 table is the fused gather +
    joint lookup kernel, bit-equal to the gather and joint lookup kernels
    it replaces there, which an int8 table's step still runs); then 3
    steps of the per-side branch (separate towers) the same way;
  - trains it the same way on a bf16 table and on an int8 table (12 steps
    each, the stochastic-rounding scatters, kernels against plain versions);
  - evaluates the f32, bf16 and int8 models on the held-out split (recall@1,
    NDCG@10, MRR), kernels against plain versions, the second pass from the
    cache of prepared batches;
  - saves the trained state with the port's Checkpointer, restores it,
  - serves from the restored weights: a doc index over 4096 toy titles and
    top-10 for 64 queries, through the kernels and through the plain
    versions, which must agree, and
  - runs cli.train (f32 table; then a bf16 table with periodic eval),
    cli.eval and cli.export on their workdirs.

Then the cnn (CLSM) and lstm presets at their published width (Wc [30000,
1024], Win [30000, 384], batch 1024, 16 words x 8 trigrams): the raw-index
embedding bag and its weight gradient against their plain versions at the
cnn, lstm and full raw shapes on f32 and bf16 tables; SEQ_STEPS steps of
each preset on the union-dedupe and on the raw-index branch, kernels against
plain versions; eval, save, restore and serving of the trained models; the
weight gradient's path through the bag; and cli.train + cli.eval +
cli.export for --preset=cnn and --preset=lstm, and cli.train on raw-index
batches.

It checks that every kernel was launched by the path it belongs to. The
next-to-last line is a JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero before
that line; with no GPU it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 CUDA cores
SEED = 0
TRAIN_STEPS = 12       # joint branch, kernels against plain, per table dtype
PER_SIDE_STEPS = 3     # per-side branch (separate towers)
SR_SEEDS = 64          # seeds averaged in the scatters' unbiasedness check
RANK_N = 6553          # eval pairs of the full preset (10% of 65536)
TRAIN_PAIRS = 32768    # of the preset's 65536 toy pairs: bounds hashing time
INDEX_BATCHES = 4      # served index: 4 batches of 1024 titles
CLI_PAIRS = 8192       # toy corpus of the command-line drive
CLI_STEPS = 4          # its training steps (f32 table)
CLI_LOWPREC_STEPS = 6  # bf16 table, eval every 3 steps
SEQ_STEPS = 8          # cnn / lstm, each branch, kernels against plain
SEQ_PROFILED_STEPS = 3  # then traced, from the trained state
SEQ_CLI_STEPS = 6      # cli.train of the cnn / lstm presets


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from dssm_tpu_torch.config import get_preset, validate
    from dssm_tpu_torch.bridge import batch_to_torch
    from dssm_tpu_torch.data import (
        ToyPairs, batch_iterator, eval_batches, hash_pairs, make_toy_pairs,
        train_eval_split)
    from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
    from dssm_tpu_torch.data.loader import pad_batch
    from dssm_tpu_torch.data.remap import (
        apply_remap, build_freq_remap, load_remap, save_remap)
    from dssm_tpu_torch.data.trigram import hash_batch
    from dssm_tpu_torch.device import resolve_device
    from dssm_tpu_torch.io.checkpoint import Checkpointer
    from dssm_tpu_torch.kernels import _build
    from dssm_tpu_torch.kernels import embed as embed_mod
    from dssm_tpu_torch.kernels.embed import (
        check_rows, embedding_bag, embedding_bag_dwgt,
        embedding_bag_dwgt_plain, embedding_bag_plain)
    from dssm_tpu_torch.kernels.count import (
        count_lookup, count_lookup_bwd, count_lookup_bwd_plain, count_matrix)
    from dssm_tpu_torch.kernels.gather import (
        gather_row_groups, scatter_add_row_groups,
        scatter_add_row_groups_plain)
    from dssm_tpu_torch.kernels.joint import (
        BWD_PIECE, fused_gather_joint_lookup, fused_gather_joint_lookup_plain,
        joint_lookup, joint_lookup_bwd, joint_lookup_bwd_plain,
        joint_lookup_plain)
    from dssm_tpu_torch.kernels.rank import (
        rank_counts, rank_counts_plain, true_scores)
    from dssm_tpu_torch.kernels.scatter_sr import (
        scatter_sr_int8_row_groups, scatter_sr_int8_row_groups_plain,
        scatter_sr_row_groups, scatter_sr_row_groups_plain)
    from dssm_tpu_torch.kernels.loss import (
        in_batch_loss_dd, in_batch_loss_dq, in_batch_loss_grads_plain,
        in_batch_nll_kernel, in_batch_nll_plain)
    from dssm_tpu_torch.kernels.tower import (
        dense_tower, dense_tower_residuals)
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.serve import build_doc_index, embed_queries, top_k
    from dssm_tpu_torch.train import eval as eval_mod
    from dssm_tpu_torch.train.loop import make_train_step
    from dssm_tpu_torch.train.state import create_run_state

    dev = resolve_device(cpu=False)
    Event = torch.cuda.Event

    # ---- phase 1: the card, and the kernels' build ----------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, "
          f"{len(_build.SOURCES)} sources in parallel + link)")
    print(_build.ptxas_report())
    _build.load()

    def graph_ms(fn, reps=20, replays=11):
        """Device time per call: `reps` calls captured in a CUDA graph,
        replayed; the median replay over reps (inputs stay L2-warm)."""
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
            a, b = Event(enable_timing=True), Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    def device_time_us(prof, top_n):
        """Device time one torch.profiler window recorded: (total us, the
        top_n kernels by time); (None, []) when it recorded no device
        event, which is then said and not read as an idle card."""
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[e.key[:60]] = by_kernel.get(e.key[:60], 0.0) + float(
                    getattr(e, "self_device_time_total", 0.0))
        total = sum(by_kernel.values())
        if total <= 0:
            print("torch.profiler recorded no device time in this window: "
                  "its device numbers below are null (not measured)")
            return None, []
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top_n]
        return total, top

    def bwd_segments(sel_, q_inv_, q_wgt_, d_inv_, d_wgt_, gr_):
        """The joint lookup backward's segments: live lookups of the
        longest compact row, the pieces of at most BWD_PIECE lookups the
        kernel sums (a warp each), and the rows some live lookup names."""
        named = []
        for inv_, wgt_ in ((q_inv_, q_wgt_), (d_inv_, d_wgt_)):
            live = (wgt_ != 0) & (inv_ >= 0) & (inv_ < sel_.numel())
            j_ = sel_.long()[inv_[live].long()]
            named.append(j_[(j_ >= 0) & (j_ < gr_)])
        per_row = torch.bincount(torch.cat(named), minlength=gr_)
        return dict(longest_segment=int(per_row.max()),
                    pieces=int(((per_row + BWD_PIECE - 1) // BWD_PIECE).sum()),
                    rows_named=int((per_row > 0).sum()), rows=gr_)

    def eager_ms(fn, reps=50, trials=7):
        """Time per call launched eagerly from Python (host included)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(trials):
            a, b = Event(enable_timing=True), Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    # ---- phase 2: the serving kernels against their plain versions -------
    cfg = validate(get_preset("full"))
    t = cfg.tower
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    params = model_base.init_params(t, seed=cfg.train.seed, device=dev)
    torch.cuda.synchronize()
    table = params["shared"]["W0"]
    print(f"fresh init of the full preset on the card: "
          f"{time.perf_counter() - t0:.1f} s, table {tuple(table.shape)} "
          f"{table.dtype}")
    results = {}

    # Gather: 256 slots, ~107 real sorted groups, the rest sentinel.
    group, slots, real = 8, cfg.data.max_unique // 8, 107
    num_groups = table.shape[0] // group
    gids_np = np.full((slots,), SKIP_SENTINEL_GID, np.int32)
    gids_np[:real] = np.sort(rng.choice(num_groups, real, replace=False))
    gids = torch.from_numpy(gids_np).to(dev)
    out_k = gather_row_groups(table, gids, group, impl="kernel")
    out_p = gather_row_groups(table, gids, group, impl="plain")
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "gather_row_groups differs from its "
          "plain version (bit-exact expected)")
    tbl16 = table[: 1 << 16].to(torch.bfloat16)  # a bf16 table: 16-row groups
    g16 = torch.tensor([5, 1 << 25, 4095, 0], dtype=torch.int32, device=dev)
    check(torch.equal(gather_row_groups(tbl16, g16, 16, impl="kernel"),
                      gather_row_groups(tbl16, g16, 16, impl="plain")),
          "gather_row_groups differs on a bf16 table")
    rows = (torch.where(gids < num_groups, gids, 0).long()[:, None] * group
            + torch.arange(group, device=dev)).reshape(-1)
    h = table.shape[1]
    nbytes = (real * group * h * 4 + slots * group * h * 4 + slots * 4)
    b_ms, b_by = bound_ms(nbytes, 0, "f32")
    results["gather_row_groups"] = dict(
        source="dssm_tpu_torch/csrc/gather.cu",
        replaces="dssm_tpu/kernels/pallas_gather.py:136",
        max_abs_err=float((out_k - out_p).abs().max()),
        ms=graph_ms(lambda: gather_row_groups(table, gids, group,
                                              impl="kernel")),
        plain_ms=graph_ms(lambda: gather_row_groups(table, gids, group,
                                                    impl="plain")),
        library_ms=graph_ms(lambda: table.index_select(0, rows)),
        eager_ms=eager_ms(lambda: gather_row_groups(table, gids, group,
                                                    impl="kernel")),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"table {tuple(table.shape)} f32, {slots} slots, {real} real",
    )

    # Count lookup: 1024 rows, K=64 (doc side) and 32 (query side), u2=1024,
    # ragged rows whose trailing weights are zero (junk inv past them).
    u2, rows_n = cfg.data.max_unique_rows, cfg.train.batch_size
    count_err = {}
    for k in (cfg.data.max_trigrams, cfg.data.max_trigrams_query):
        inv_np = rng.integers(0, u2, size=(rows_n, k)).astype(np.int32)
        wgt_np = rng.integers(1, 4, size=(rows_n, k)).astype(np.float32)
        nnz = rng.integers(0, k + 1, size=(rows_n,))
        wgt_np[np.arange(k)[None, :] >= nnz[:, None]] = 0.0
        inv = torch.from_numpy(inv_np).to(dev)
        wgt = torch.from_numpy(wgt_np).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            c2 = torch.from_numpy(rng.normal(size=(u2, h)).astype(
                np.float32)).to(dev).to(dtype)
            ok_ = count_lookup(c2, inv, wgt, impl="kernel")
            op_ = count_lookup(c2, inv, wgt, impl="plain")
            torch.cuda.synchronize()
            err = (ok_ - op_).abs()
            if dtype == torch.float32:
                tol = 1e-5 * op_.abs() + 1e-5 * float(op_.abs().max())
                check(bool((err <= tol).all()), f"count_lookup f32 K={k}: "
                      f"max err {float(err.max())} over rtol 1e-5")
            else:
                row_norm = op_.norm(dim=1, keepdim=True)
                check(bool((err <= 1e-2 * row_norm).all()),
                      f"count_lookup bf16 K={k}: max err {float(err.max())} "
                      "over 1e-2 x row norm")
            count_err[(k, dtype)] = float(err.max())
            if k == cfg.data.max_trigrams and dtype == torch.bfloat16:
                main_case = (c2, inv, wgt, wgt_np, inv_np)
    c2, inv, wgt, wgt_np, inv_np = main_case
    nz = wgt_np != 0
    touched = len(np.unique(inv_np[nz]))
    nbytes = inv.numel() * 4 + wgt.numel() * 4 + touched * h * 2 + rows_n * h * 4
    b_ms, b_by = bound_ms(nbytes, 2.0 * nz.sum() * h, "f32")
    cnt = count_matrix(inv, wgt, u2)
    c2f = c2.float()
    results["count_lookup"] = dict(
        source="dssm_tpu_torch/csrc/count.cu",
        replaces="dssm_tpu/kernels/pallas_count.py:218",
        max_abs_err=count_err[(cfg.data.max_trigrams, torch.bfloat16)],
        ms=graph_ms(lambda: count_lookup(c2, inv, wgt, impl="kernel")),
        plain_ms=graph_ms(lambda: count_lookup(c2, inv, wgt, impl="plain")),
        library_ms=graph_ms(lambda: cnt @ c2f),
        eager_ms=eager_ms(lambda: count_lookup(c2, inv, wgt, impl="kernel")),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"compact2 ({u2}, {h}) bf16, inv/wgt ({rows_n}, "
              f"{cfg.data.max_trigrams}), {int(nz.sum())} nonzero",
        errors={f"K={k} {str(d).split('.')[-1]}": e
                for (k, d), e in count_err.items()},
    )

    # Dense tower: x [1024, 300] bf16 -> 300 -> 128, tanh, no norm (the
    # model's call), plus an f32 relu normalized case for generality.
    tp = params["shared"]
    bf = torch.bfloat16
    dims = [t.embed_width, *t.hidden_dims, t.semantic_dim]
    layers = [(tp[f"W{l}"].to(bf), tp[f"b{l}"].to(bf))
              for l in range(1, len(dims))]
    x = torch.from_numpy(rng.uniform(-1, 1, size=(rows_n, dims[0])).astype(
        np.float32)).to(dev).to(bf)
    y_k = dense_tower(x, layers, "tanh", normalize=False, impl="kernel")
    y_p = dense_tower(x, layers, "tanh", normalize=False, impl="plain")
    torch.cuda.synchronize()
    tower_err = float((y_k - y_p).abs().max())
    check(tower_err <= 2e-2, f"dense_tower bf16: max err {tower_err} > 2e-2")
    lf = [(w.float(), b.float()) for w, b in layers]
    yf_k = dense_tower(x.float(), lf, "relu", normalize=True, impl="kernel")
    yf_p = dense_tower(x.float(), lf, "relu", normalize=True, impl="plain")
    torch.cuda.synchronize()
    f32_err = float((yf_k - yf_p).abs().max())
    check(f32_err <= 1e-5, f"dense_tower f32: max err {f32_err} > 1e-5")
    flops = 2.0 * rows_n * sum(w.shape[0] * w.shape[1] for w, _ in layers)
    nbytes = (x.numel() * 2 + sum(w.numel() * 2 + b.numel() * 2
                                  for w, b in layers) + y_k.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, flops, "bf16")

    def torch_chain(xx=x, ll=layers):
        hh = xx
        for w, b in ll:
            hh = torch.tanh(torch.addmm(b, hh, w))
        return hh

    # The `tiny` preset's call: x [256, 300] f32 through its f32 layers,
    # tanh, no norm; exact f32 FMAs, held to 1e-5 and timed.
    tcfg = validate(get_preset("tiny"))
    tparams = model_base.init_params(tcfg.tower, seed=cfg.train.seed,
                                     device=dev)["shared"]
    tdims = [tcfg.tower.embed_width, *tcfg.tower.hidden_dims,
             tcfg.tower.semantic_dim]
    tlayers = [(tparams[f"W{l}"], tparams[f"b{l}"])
               for l in range(1, len(tdims))]
    trng = np.random.default_rng(SEED + 1)  # leaves `rng`'s stream as it was
    tx = torch.from_numpy(trng.uniform(-1, 1, size=(
        tcfg.train.batch_size, tdims[0])).astype(np.float32)).to(dev)
    ty_k = dense_tower(tx, tlayers, "tanh", normalize=False, impl="kernel")
    ty_p = dense_tower(tx, tlayers, "tanh", normalize=False, impl="plain")
    torch.cuda.synchronize()
    tiny_err = float((ty_k - ty_p).abs().max())
    check(tiny_err <= 1e-5, f"dense_tower f32 at the tiny shapes: max err "
          f"{tiny_err} > 1e-5")
    tflops = 2.0 * tx.shape[0] * sum(w.numel() for w, _ in tlayers)
    tb_ms, tb_by = bound_ms(tx.numel() * 4 + ty_k.numel() * 4 + sum(
        w.numel() * 4 + b.numel() * 4 for w, b in tlayers), tflops, "f32")
    tiny_case = dict(
        shape=f"x {tuple(tx.shape)} f32, widths {tdims}",
        max_abs_err=tiny_err,
        ms=graph_ms(lambda: dense_tower(tx, tlayers, "tanh", normalize=False,
                                        impl="kernel")),
        plain_ms=graph_ms(lambda: dense_tower(tx, tlayers, "tanh",
                                              normalize=False, impl="plain")),
        library_ms=graph_ms(lambda: torch_chain(tx, tlayers)),
        bound_ms=tb_ms, bound_by=tb_by)
    print("dense_tower, tiny preset f32: " + json.dumps(tiny_case)
          + f" on {card}")
    print("ptxas, csrc/tower.cu:")
    print(_build.ptxas_report(("tower.cu",)))

    results["dense_tower"] = dict(
        source="dssm_tpu_torch/csrc/tower.cu",
        replaces="dssm_tpu/kernels/pallas_tower.py:180",
        max_abs_err=tower_err,
        ms=graph_ms(lambda: dense_tower(x, layers, "tanh", normalize=False,
                                        impl="kernel")),
        plain_ms=graph_ms(lambda: dense_tower(x, layers, "tanh",
                                              normalize=False, impl="plain")),
        library_ms=graph_ms(torch_chain),
        eager_ms=eager_ms(lambda: dense_tower(x, layers, "tanh",
                                              normalize=False,
                                              impl="kernel")),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"x ({rows_n}, {dims[0]}) bf16, widths {dims}",
        errors={"bf16 tanh": tower_err, "f32 relu normalized": f32_err,
                "f32 tiny tanh": tiny_err},
        tiny_f32=tiny_case, ms_tiny_f32=tiny_case["ms"],
    )
    for name, r in results.items():
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, eager call "
              f"{r['eager_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), max err {r['max_abs_err']:.3g} "
              f"[{r['shape']}] on {card}")

    # ---- phase 3: the training kernels against their plain versions -----
    # Inputs are the first batch of the training stream (built below as
    # cli/train builds it), so slots, weights and live lookups are the
    # step's own; gradients are seeded normals.
    t0 = time.perf_counter()
    pairs = make_toy_pairs(cfg.data.toy_num_pairs, cfg.data.toy_vocab_words,
                           cfg.data.seed)
    train_pairs, eval_pairs = train_eval_split(
        ToyPairs(queries=pairs.queries[:TRAIN_PAIRS],
                 titles=pairs.titles[:TRAIN_PAIRS]),
        eval_frac=cfg.data.eval_frac, seed=cfg.data.seed)
    hashed_train = hash_pairs(train_pairs, t, cfg.data)
    hashed_eval = hash_pairs(eval_pairs, t, cfg.data)
    tmp_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_")
    workdir = tmp_dir.name  # removed below, or at exit if a check fails
    train_remap = build_freq_remap(hashed_train, t.vocab_size)
    hashed_train = apply_remap(hashed_train, train_remap)
    hashed_eval = apply_remap(hashed_eval, train_remap)
    save_remap(workdir, train_remap)
    print(f"training corpus: {len(hashed_train)} pairs hashed + remapped in "
          f"{time.perf_counter() - t0:.1f} s (cut from "
          f"{cfg.data.toy_num_pairs} pairs; widths, vocab, batch and caps "
          "are the preset's)")

    def stream(joint, dedup_group=group):
        return batch_iterator(
            hashed_train, cfg.train.batch_size, seed=cfg.train.seed,
            dedup_unique=cfg.data.max_unique, dedup_group=dedup_group,
            dedup_unique_rows=cfg.data.max_unique_rows, dedup_joint=joint,
            wire_compress=True, sort_rows=True)

    host_batches_t, host_prep_ms = [], []
    it = stream(True)
    for _ in range(TRAIN_STEPS + 8):
        t0 = time.perf_counter()
        host_batches_t.append(next(it))
        host_prep_ms.append((time.perf_counter() - t0) * 1e3)
    tb0 = batch_to_torch(host_batches_t[0], dev)
    sel, uniq = tb0["sel"], tb0["uniq"]
    q_inv, q_wgt, d_inv, d_wgt = (tb0[k].contiguous() for k in
                                  ("q_inv", "q_wgt", "d_inv", "d_wgt"))
    gr = cfg.data.max_unique
    kq, kd = q_inv.shape[1], d_inv.shape[1]
    compact = gather_row_groups(table, uniq, group, impl="kernel")

    nnz_q, nnz_d = int((q_wgt != 0).sum()), int((d_wgt != 0).sum())
    real_slots_first = int((uniq < num_groups).sum())
    both_rows = torch.unique(torch.cat([
        sel.long()[q_inv.long()[q_wgt != 0]],
        sel.long()[d_inv.long()[d_wgt != 0]]])).numel()
    idx_bytes = (q_inv.numel() + d_inv.numel()) * 8 + sel.numel() * 4

    # Joint lookup forward.
    lq_k, ld_k = joint_lookup(compact, sel, q_inv, q_wgt, d_inv, d_wgt,
                              impl="kernel")
    lq_p, ld_p = joint_lookup_plain(compact, sel, q_inv, q_wgt, d_inv, d_wgt)
    torch.cuda.synchronize()
    err = max(float((lq_k - lq_p).abs().max()),
              float((ld_k - ld_p).abs().max()))
    scale = max(float(lq_p.abs().max()), float(ld_p.abs().max()))
    check(err <= 1e-5 * scale, f"joint_lookup: max err {err} over 1e-5 x "
          f"max |out| {scale}")
    cnt_q = count_matrix(q_inv, q_wgt, sel.numel())
    cnt_d = count_matrix(d_inv, d_wgt, sel.numel())

    def joint_library():
        c2_ = compact.index_select(0, sel.long())
        return cnt_q @ c2_, cnt_d @ c2_

    b_ms, b_by = bound_ms(idx_bytes + both_rows * h * 4 + 2 * rows_n * h * 4,
                          2.0 * (nnz_q + nnz_d) * h, "f32")
    results["joint_lookup"] = dict(
        source="dssm_tpu_torch/csrc/joint.cu",
        replaces="dssm_tpu/kernels/pallas_count.py:665",
        max_abs_err=err, tolerance=f"1e-5 x max |out| ({scale:.3g})",
        ms=graph_ms(lambda: joint_lookup(compact, sel, q_inv, q_wgt, d_inv,
                                         d_wgt, impl="kernel")),
        plain_ms=graph_ms(lambda: joint_lookup_plain(compact, sel, q_inv,
                                                     q_wgt, d_inv, d_wgt)),
        library_ms=graph_ms(joint_library),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"compact ({gr}, {h}) f32, sel ({sel.numel()}), q ({rows_n}, "
              f"{kq}) d ({rows_n}, {kd}), {nnz_q + nnz_d} live lookups on "
              f"{both_rows} rows",
    )

    # Fused gather + joint lookup: the same batch straight from the table.
    def fused_case(tbl, uniq_, fields_, grp, what):
        """The fused kernel against its plain version (1e-5 x max |out|) and
        bit-equal, output by output, to the gather kernel followed by the
        joint lookup kernel; its times beside the split pair's (one graph
        of both launches), the plain version's and the library chain's
        (index_select of the group rows, then row 5's count products), and
        its bound: inv, wgt, sel and uniq read once, the real groups' table
        rows read once, compact and both outputs written once; one f32
        multiply-add per live lookup and column. The library chain is timed
        with its count matrices built in the timed call (the same function)
        and, as earlier runs timed it, built outside it. Returns the
        numbers."""
        got = fused_gather_joint_lookup(tbl, uniq_, *fields_, grp,
                                        impl="kernel")
        want = fused_gather_joint_lookup_plain(tbl, uniq_, *fields_, grp)
        c_s = gather_row_groups(tbl, uniq_, grp, impl="kernel")
        split = (*joint_lookup(c_s, *fields_, impl="kernel"), c_s)
        torch.cuda.synchronize()
        for part, a_, b_ in zip(("q_out", "d_out", "compact"), got, split):
            check(torch.equal(a_, b_), f"fused_gather_joint_lookup ({what}):"
                  f" {part} differs from gather_row_groups + joint_lookup "
                  "(bit-equal expected)")
        check(torch.equal(got[2], want[2]), f"fused_gather_joint_lookup "
              f"({what}): compact differs from its plain version")
        err_ = max(float((a_ - b_).abs().max())
                   for a_, b_ in zip(got[:2], want[:2]))
        scale_ = max(float(b_.abs().max()) for b_ in want[:2])
        check(err_ <= 1e-5 * scale_, f"fused_gather_joint_lookup ({what}): "
              f"max err {err_} over 1e-5 x max |out| {scale_}")
        ng = tbl.shape[0] // grp
        rows_ = (torch.where((uniq_ >= 0) & (uniq_ < ng), uniq_, 0).long()
                 [:, None] * grp + torch.arange(grp, device=dev)).reshape(-1)
        sel_ = fields_[0].long()
        cq_, cd_ = (count_matrix(fields_[i], fields_[i + 1], sel_.numel())
                    .to(tbl.dtype) for i in (1, 3))

        def library_counts_outside():
            c2_ = tbl.index_select(0, rows_).index_select(0, sel_)
            return cq_ @ c2_, cd_ @ c2_

        def library():
            cq2, cd2 = (count_matrix(fields_[i], fields_[i + 1],
                                     sel_.numel()).to(tbl.dtype)
                        for i in (1, 3))
            c2_ = tbl.index_select(0, rows_).index_select(0, sel_)
            return cq2 @ c2_, cd2 @ c2_

        real_ = int(((uniq_ >= 0) & (uniq_ < ng)).sum())
        h_ = tbl.shape[1]
        nbytes_ = ((fields_[1].numel() + fields_[3].numel()) * 8
                   + fields_[0].numel() * 4 + uniq_.numel() * 4
                   + (real_ + uniq_.numel()) * grp * h_ * tbl.element_size()
                   + sum(o.numel() * 4 for o in got[:2]))
        nnz_ = int((fields_[2] != 0).sum() + (fields_[4] != 0).sum())
        b_ms_, b_by_ = bound_ms(nbytes_, 2.0 * nnz_ * h_, "f32")
        lib_ms, lib_out_ms = graph_ms(library), graph_ms(library_counts_outside)
        print(f"fused_gather_joint_lookup ({what}): library chain "
              f"(index_select + count matrix products) {lib_ms:.4f} ms with "
              f"its count matrices built in the timed call, "
              f"{lib_out_ms:.4f} ms with them built outside it (not the "
              f"same function) on {card}")
        return dict(
            bound_ms=b_ms_, bound_by=b_by_, max_abs_err=err_, tolerance=f"1e-5 x max |out| ({scale_:.3g}); "
            "bit-equal to gather_row_groups + joint_lookup",
            ms=graph_ms(lambda: fused_gather_joint_lookup(
                tbl, uniq_, *fields_, grp, impl="kernel")),
            split_ms=graph_ms(lambda: joint_lookup(gather_row_groups(
                tbl, uniq_, grp, impl="kernel"), *fields_, impl="kernel")),
            plain_ms=graph_ms(lambda: fused_gather_joint_lookup_plain(
                tbl, uniq_, *fields_, grp)),
            library_ms=lib_ms, library_ms_counts_outside=lib_out_ms)

    fused_full = fused_case(table, uniq, [sel, q_inv, q_wgt, d_inv, d_wgt],
                            group, "full, f32")
    results["fused_gather_joint_lookup"] = dict(
        source="dssm_tpu_torch/csrc/joint.cu",
        replaces="dssm_tpu/kernels/pallas_count.py:494",
        ms_split=fused_full.pop("split_ms"),
        ms_library_counts_outside=fused_full.pop("library_ms_counts_outside"),
        shape=f"table {tuple(table.shape)} f32, {uniq.numel()} slots "
              f"({real_slots_first} real), sel ({sel.numel()}), q ({rows_n}, "
              f"{kq}) d ({rows_n}, {kd}), {nnz_q + nnz_d} live lookups",
        **fused_full)

    # Joint lookup backward (a sorted, segmented sum): bf16 gradients, as the
    # step's. Two calls must give the same bits.
    g_q = torch.from_numpy(rng.normal(size=(rows_n, h)).astype(
        np.float32)).to(dev).to(bf)
    g_d = torch.from_numpy(rng.normal(size=(rows_n, h)).astype(
        np.float32)).to(dev).to(bf)
    dc_k = joint_lookup_bwd(sel, q_inv, q_wgt, d_inv, d_wgt, g_q, g_d, gr,
                            impl="kernel")
    dc_k2 = joint_lookup_bwd(sel, q_inv, q_wgt, d_inv, d_wgt, g_q, g_d, gr,
                             impl="kernel")
    dc_p = joint_lookup_bwd_plain(sel, q_inv, q_wgt, d_inv, d_wgt, g_q, g_d,
                                  gr)
    torch.cuda.synchronize()
    err, scale = float((dc_k - dc_p).abs().max()), float(dc_p.abs().max())
    check(err <= 1e-5 * scale, f"joint_lookup_bwd: max err {err} over 1e-5 "
          f"x max |dc| {scale}")
    check(torch.equal(dc_k, dc_k2), "joint_lookup_bwd: two calls on the same "
          f"inputs differ (max |a - b| {float((dc_k - dc_k2).abs().max()):.3g};"
          " bit-equal expected: no float atomics)")
    seg_full = bwd_segments(sel, q_inv, q_wgt, d_inv, d_wgt, gr)
    print("joint_lookup_bwd run twice on the same inputs: bit-equal; "
          f"segments at the full shapes: {json.dumps(seg_full)}")
    flat_q = sel.long()[q_inv.long().reshape(-1)]
    flat_d = sel.long()[d_inv.long().reshape(-1)]

    def joint_bwd_library():
        dc_ = torch.zeros((gr, h), device=dev)
        dc_.index_add_(0, flat_q, (q_wgt[..., None] * g_q.float()[:, None, :]
                                   ).reshape(-1, h))
        return dc_.index_add_(0, flat_d, (d_wgt[..., None]
                                          * g_d.float()[:, None, :]
                                          ).reshape(-1, h))

    b_ms, b_by = bound_ms(idx_bytes + 2 * rows_n * h * 2 + gr * h * 4,
                          2.0 * (nnz_q + nnz_d) * h, "f32")
    results["joint_lookup_bwd"] = dict(
        source="dssm_tpu_torch/csrc/joint.cu",
        replaces="dssm_tpu/kernels/pallas_count.py:399",
        max_abs_err=err, tolerance=f"1e-5 x max |dc| ({scale:.3g})",
        ms=graph_ms(lambda: joint_lookup_bwd(sel, q_inv, q_wgt, d_inv, d_wgt,
                                             g_q, g_d, gr, impl="kernel")),
        plain_ms=graph_ms(lambda: joint_lookup_bwd_plain(
            sel, q_inv, q_wgt, d_inv, d_wgt, g_q, g_d, gr)),
        library_ms=graph_ms(joint_bwd_library),
        bound_ms=b_ms, bound_by=b_by, segments=seg_full,
        shape=f"g ({rows_n}, {h}) bf16 x 2 -> dc ({gr}, {h}) f32 (every row "
              "written by the kernel, no zero fill; the library's zero fill "
              "is in its time)",
    )

    # Count lookup backward: the doc side of the per-side branch, slots as
    # compact2 rows (u2 = 1024), bf16 compact2.
    dc2_k = count_lookup_bwd(d_inv, d_wgt, g_d, u2, impl="kernel")
    dc2_p = count_lookup_bwd_plain(d_inv, d_wgt, g_d, u2)
    torch.cuda.synchronize()
    err, scale = float((dc2_k - dc2_p).abs().max()), float(dc2_p.abs().max())
    check(err <= 1e-5 * scale, f"count_lookup_bwd: max err {err} over 1e-5 "
          f"x max |dc2| {scale}")
    flat_u = d_inv.long().reshape(-1)

    def count_bwd_library():
        return torch.zeros((u2, h), device=dev).index_add_(
            0, flat_u, (d_wgt[..., None] * g_d.float()[:, None, :]
                        ).reshape(-1, h))

    b_ms, b_by = bound_ms(d_inv.numel() * 8 + rows_n * h * 2 + u2 * h * 4,
                          2.0 * nnz_d * h, "f32")
    results["count_lookup_bwd"] = dict(
        source="dssm_tpu_torch/csrc/count.cu",
        replaces="dssm_tpu/kernels/pallas_count.py:168",
        max_abs_err=err, tolerance=f"1e-5 x max |dc2| ({scale:.3g})",
        ms=graph_ms(lambda: count_lookup_bwd(d_inv, d_wgt, g_d, u2,
                                             impl="kernel")),
        plain_ms=graph_ms(lambda: count_lookup_bwd_plain(d_inv, d_wgt, g_d,
                                                         u2)),
        library_ms=graph_ms(count_bwd_library),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"inv/wgt ({rows_n}, {kd}), g ({rows_n}, {h}) bf16 -> "
              f"({u2}, {h}) f32, {nnz_d} live lookups",
    )

    # Dense tower with residuals and its backward: x [2048, 300] bf16 (both
    # sides stacked, as the step calls it).
    x2 = torch.cat([x, x.flip(0)]).contiguous()
    gy = torch.from_numpy(rng.normal(size=(2 * rows_n, dims[-1])).astype(
        np.float32)).to(dev)
    tower_grads, tower_y = {}, {}
    for impl in ("kernel", "plain"):
        leaves = [x2.clone().requires_grad_(True)] + [
            p_.clone().requires_grad_(True) for l_ in layers for p_ in l_]
        y_ = dense_tower(leaves[0], list(zip(leaves[1::2], leaves[2::2])),
                         "tanh", normalize=False, impl=impl)
        (y_ * gy).sum().backward()
        tower_y[impl] = y_.detach()
        tower_grads[impl] = [p_.grad.float() for p_ in leaves]
    torch.cuda.synchronize()
    err = float((tower_y["kernel"] - tower_y["plain"]).abs().max())
    check(err <= 2e-2, f"dense_tower with residuals: y max err {err} > 2e-2")
    for a_, b_ in zip(tower_grads["kernel"], tower_grads["plain"]):
        gerr, gscale = float((a_ - b_).abs().max()), float(b_.abs().max())
        check(gerr <= 2e-2 * max(1.0, gscale), "dense_tower backward from "
              f"the kernel's residuals: max err {gerr} over 2e-2 x "
              f"max(1, {gscale})")
    flops2 = 2.0 * flops
    res_bytes = 2 * rows_n * sum(dims[1:]) * 4
    nbytes2 = (x2.numel() * 2 + sum(w.numel() * 2 + b.numel() * 2
                                    for w, b in layers)
               + 2 * rows_n * dims[-1] * 4 + res_bytes)
    b_ms, b_by = bound_ms(nbytes2, flops2, "bf16")

    def tower_res_kernel():
        return dense_tower_residuals(x2, layers, "tanh", False,
                                     impl="kernel")

    def tower_res_plain():
        return dense_tower_residuals(x2, layers, "tanh", False, impl="plain")

    def tower_res_library():
        hh, keep = x2, []
        for w, b in layers:
            hh = torch.tanh(torch.addmm(b, hh, w))
            keep.append(hh.float())
        return keep

    results["dense_tower_residuals"] = dict(
        source="dssm_tpu_torch/csrc/tower.cu",
        replaces="dssm_tpu/kernels/pallas_tower.py:71",
        max_abs_err=err, tolerance="2e-2 (y and every gradient)",
        ms=graph_ms(tower_res_kernel), plain_ms=graph_ms(tower_res_plain),
        library_ms=graph_ms(tower_res_library),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"x ({2 * rows_n}, {dims[0]}) bf16, widths {dims}, residuals "
              f"f32 ({res_bytes / 1e6:.1f} MB)",
    )

    # Loss forward, dq, dd: unit q, d [1024, 128] f32, diagonal labels.
    import torch.nn.functional as F

    gamma = cfg.loss.gamma
    qn = F.normalize(torch.from_numpy(rng.normal(size=(rows_n, dims[-1]))
                                      .astype(np.float32)).to(dev), dim=1)
    # Docs at cosine ~0.45 to their queries: the positive's softmax share is
    # near 0.6, so the gradients are well away from f32 cancellation.
    dn = F.normalize(qn + 2.0 * F.normalize(torch.from_numpy(
        rng.normal(size=(rows_n, dims[-1])).astype(np.float32)).to(dev),
        dim=1), dim=1)
    labels = torch.arange(rows_n, dtype=torch.int32, device=dev)
    nll_k, lse_k, pos_k, hit_k = in_batch_nll_kernel(qn, dn, labels, gamma)
    nll_p, lse_p, pos_p, hit_p = in_batch_nll_plain(qn, dn, labels, gamma)
    again = in_batch_nll_kernel(qn, dn, labels, gamma)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(
        (nll_k, lse_k, pos_k, hit_k), again)), "in_batch_loss forward: two "
          "calls differ (bit-equal expected: no atomics)")
    err = max(float((nll_k - nll_p).abs().max()),
              float((lse_k - lse_p).abs().max()),
              float((pos_k - pos_p).abs().max()))
    check(err <= 1e-4, f"in_batch_loss forward: max err {err} > 1e-4 "
          "(nll, lse, pos; logits up to 20)")
    flips = int((hit_k != hit_p).sum())
    check(flips <= 2, f"in_batch_loss hit differs on {flips} rows")
    bb = rows_n * rows_n * dims[-1]
    io_bytes = (qn.numel() + dn.numel()) * 4 + rows_n * 4
    b_ms, b_by = bound_ms(io_bytes + 4 * rows_n * 4, 2.0 * bb, "f32")
    labels64 = labels.long()
    results["in_batch_loss"] = dict(
        source="dssm_tpu_torch/csrc/loss.cu",
        replaces="dssm_tpu/kernels/pallas_loss.py:123",
        max_abs_err=err, tolerance="1e-4 (nll, lse, pos); hit within 2 rows",
        ms=graph_ms(lambda: in_batch_nll_kernel(qn, dn, labels, gamma)),
        plain_ms=graph_ms(lambda: in_batch_nll_plain(qn, dn, labels, gamma)),
        library_ms=graph_ms(lambda: F.cross_entropy(
            gamma * (qn @ dn.T), labels64, reduction="none")),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q, d ({rows_n}, {dims[-1]}) f32, gamma {gamma}",
    )
    g_row = torch.full((rows_n,), 1.0 / rows_n, device=dev)
    dq_p, dd_p = in_batch_loss_grads_plain(qn, dn, labels, gamma, lse_p,
                                           g_row)
    q_lib = qn.clone().requires_grad_(True)
    d_lib = dn.clone().requires_grad_(True)

    def with_forward(fn):
        """The kernels' forward and then `fn`: what the library call does."""
        def run():
            lse_f = in_batch_nll_kernel(qn, dn, labels, gamma)[1]
            return fn(qn, dn, labels, gamma, lse_f, g_row, impl="kernel")
        return run

    for name, fn, want, leaf, line in (
            ("in_batch_loss_dq", in_batch_loss_dq, dq_p, q_lib, 216),
            ("in_batch_loss_dd", in_batch_loss_dd, dd_p, d_lib, 233)):
        got = fn(qn, dn, labels, gamma, lse_p, g_row, impl="kernel")
        again = fn(qn, dn, labels, gamma, lse_p, g_row, impl="kernel")
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: two calls differ "
              "(bit-equal expected: no atomics)")
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-4 * scale, f"{name}: max err {err} over 1e-4 x max "
              f"|grad| {scale}")
        b_ms, b_by = bound_ms(io_bytes + 2 * rows_n * 4 + got.numel() * 4,
                              4.0 * bb, "f32")
        results[name] = dict(
            source="dssm_tpu_torch/csrc/loss.cu",
            replaces=f"dssm_tpu/kernels/pallas_loss.py:{line}",
            max_abs_err=err, tolerance=f"1e-4 x max |grad| ({scale:.3g})",
            ms=graph_ms(lambda: fn(qn, dn, labels, gamma, lse_p, g_row,
                                   impl="kernel")),
            plain_ms=graph_ms(lambda: fn(qn, dn, labels, gamma, lse_p, g_row,
                                         impl="plain")),
            # F.cross_entropy(gamma q d^T) and its autograd in this one
            # input, forward included: beside it, the kernels' forward and
            # this kernel (ms_with_forward).
            library_ms=graph_ms(lambda: torch.autograd.grad(
                F.cross_entropy(gamma * (q_lib @ d_lib.T), labels64,
                                reduction="mean"), [leaf])),
            ms_with_forward=graph_ms(with_forward(fn)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"q, d ({rows_n}, {dims[-1]}) f32 -> {tuple(got.shape)}",
        )

    # Row-group scatter-add, in place: the batch's own slots, vals f32.
    vals = torch.from_numpy(rng.normal(size=(gr, h)).astype(
        np.float32)).to(dev) * 1e-3
    tbl_k, tbl_p = table.clone(), table.clone()
    scatter_add_row_groups(tbl_k, uniq, vals, group, impl="kernel")
    scatter_add_row_groups_plain(tbl_p, uniq, vals, group)
    torch.cuda.synchronize()
    check(torch.equal(tbl_k, tbl_p), "scatter_add_row_groups differs from "
          "its plain version (bit-exact expected)")
    real_t = int((uniq < num_groups).sum())
    real_rows = (uniq[uniq < num_groups].long()[:, None] * group
                 + torch.arange(group, device=dev)).reshape(-1)
    real_vals = vals[: real_t * group].contiguous()
    check(not torch.equal(tbl_k, table), "scatter_add_row_groups changed "
          "nothing")
    b_ms, b_by = bound_ms(3 * real_t * group * h * 4 + uniq.numel() * 4,
                          real_t * group * h, "f32")
    del tbl_p
    results["scatter_add_row_groups"] = dict(
        source="dssm_tpu_torch/csrc/scatter.cu",
        replaces="dssm_tpu/kernels/pallas_gather.py:471",
        max_abs_err=0.0, tolerance="bit-exact",
        ms=graph_ms(lambda: scatter_add_row_groups(tbl_k, uniq, vals, group,
                                                   impl="kernel")),
        plain_ms=graph_ms(lambda: scatter_add_row_groups_plain(
            tbl_k, uniq, vals, group)),
        library_ms=graph_ms(lambda: tbl_k.index_add_(0, real_rows,
                                                     real_vals)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"table {tuple(table.shape)} f32, {uniq.numel()} slots, "
              f"{real_t} real",
    )
    del tbl_k

    # ---- phase 3b: the low-precision table kernels and the rank count ----
    # Tables of the full shape in bf16 (16-row groups) and int8 (32-row
    # groups); slots are the first batch's own `uniq` of a stream deduped at
    # that group size, with its sentinel tail.
    lowprec = {}
    for name, dtype, grp in (("bfloat16", torch.bfloat16, 16),
                             ("int8", torch.int8, 32)):
        it = stream(True, grp)
        batches = [next(it) for _ in range(TRAIN_STEPS)]
        lowprec[name] = dict(dtype=dtype, group=grp, batches=batches)
    sr_cases = (
        ("scatter_sr_row_groups", "bfloat16", scatter_sr_row_groups,
         scatter_sr_row_groups_plain, 286),
        ("scatter_sr_int8_row_groups", "int8", scatter_sr_int8_row_groups,
         scatter_sr_int8_row_groups_plain, 410))
    for name, tname, fn, fn_plain, line in sr_cases:
        lp = lowprec[tname]
        grp, dtype = lp["group"], lp["dtype"]
        uniq_lp = batch_to_torch(lp["batches"][0], dev)["uniq"]
        groups_lp = table.shape[0] // grp
        if dtype == torch.bfloat16:
            tbl = table.to(dtype)
            upd = torch.from_numpy(rng.normal(size=(slots * grp, h)).astype(
                np.float32)).to(dev) * 1e-4
            small = upd * 0.1          # well under a bf16 ulp of the rows
        else:
            tbl = torch.from_numpy(rng.integers(-100, 101, size=(
                table.shape[0], h)).astype(np.int8)).to(dev)
            upd = torch.from_numpy(rng.uniform(-3, 3, size=(
                slots * grp, h)).astype(np.float32)).to(dev)
            small = upd * 0.3          # under one int8 level
        real_s = int(((uniq_lp >= 0) & (uniq_lp < groups_lp)).sum())
        check(0 < real_s < slots, f"{name}: {real_s} real slots of {slots}")
        check(bool((uniq_lp[real_s:] == SKIP_SENTINEL_GID).all()),
              f"{name}: the slots' tail is not the sentinel")
        rows_lp = (uniq_lp[:real_s].long()[:, None] * grp
                   + torch.arange(grp, device=dev)).reshape(-1)
        # The gather on this table dtype (csrc/gather.cu copies bytes).
        c_k = gather_row_groups(tbl, uniq_lp, grp, impl="kernel")
        c_p = gather_row_groups(tbl, uniq_lp, grp, impl="plain")
        check(torch.equal(c_k, c_p), f"gather_row_groups differs on the "
              f"{tname} table")
        results["gather_row_groups"][f"ms_{tname}"] = graph_ms(
            lambda: gather_row_groups(tbl, uniq_lp, grp, impl="kernel"))
        # Bit-equal to the plain version (same Philox stream), in place.
        t_k, t_p = tbl.clone(), tbl.clone()
        out = fn(t_k, uniq_lp, upd, grp, 12345, impl="kernel")
        fn_plain(t_p, uniq_lp, upd, grp, 12345)
        torch.cuda.synchronize()
        check(out is t_k and torch.equal(t_k, t_p), f"{name} differs from "
              "its plain version (bit-equal expected)")
        moved = (t_k != tbl).any(dim=1)
        inside = torch.zeros_like(moved)
        inside[rows_lp] = True
        check(bool((moved & ~inside).sum() == 0), f"{name} changed a row of "
              "no real slot")
        check(int(moved.sum()) > 0.9 * rows_lp.numel(), f"{name} moved only "
              f"{int(moved.sum())} of {rows_lp.numel()} rows")
        fn(t_p, uniq_lp, upd, grp, 12346, impl="kernel")
        check(not torch.equal(t_p[rows_lp], t_k[rows_lp]), f"{name}: another "
              "seed gave the same rows twice over")
        del t_p
        t_k.copy_(tbl)
        fn(t_k, uniq_lp, torch.zeros_like(upd), grp, 7, impl="kernel")
        check(torch.equal(t_k, tbl), f"{name}: a zero update changed the "
              "table")
        # Unbiased: the mean over seeds of an update under one grid step is
        # within 3 sigma of the f32 sum (where a normal reading holds).
        old_rows = tbl[rows_lp].float()
        acc = old_rows + small[: rows_lp.numel()]
        total = torch.zeros_like(acc, dtype=torch.float64)
        lo = torch.full_like(acc, float("inf"))
        hi = torch.full_like(acc, float("-inf"))
        for seed in range(SR_SEEDS):
            fn(t_k, uniq_lp, small, grp, 1000 + seed, impl="kernel")
            new = t_k[rows_lp].float()
            total += new
            lo, hi = torch.minimum(lo, new), torch.maximum(hi, new)
            t_k.index_copy_(0, rows_lp, tbl[rows_lp])
        if dtype == torch.bfloat16:
            down = acc.view(torch.int32) & -65536
            g_lo = down.view(torch.float32)
            g_hi = (down + 65536).view(torch.float32)
            g_lo, g_hi = torch.minimum(g_lo, g_hi), torch.maximum(g_lo, g_hi)
        else:
            g_lo = torch.floor(acc)
            g_hi = g_lo + 1
        check(bool(((lo >= g_lo) & (hi <= g_hi)).all()), f"{name}: a result "
              "is not a grid neighbour of the f32 sum")
        step_ = (g_hi - g_lo).double()
        frac = ((acc - g_lo).double() / step_).clamp(0, 1)
        sigma = step_ * torch.sqrt(frac * (1 - frac) / SR_SEEDS)
        mid = (frac >= 0.2) & (frac <= 0.8)
        z = ((total / SR_SEEDS - acc.double()).abs() / sigma)[mid]
        bias = float(((total / SR_SEEDS - acc.double()) / step_).mean())
        beyond = float((z > 3).double().mean())
        check(int(mid.sum()) > 1000 and beyond < 0.01 and float(z.max()) < 6
              and abs(bias) < 1e-3, f"{name}: mean of {SR_SEEDS} seeds off "
              f"the f32 sum: {beyond:.4f} of elements beyond 3 sigma, max z "
              f"{float(z.max()):.2f}, mean bias {bias:.2e} grid steps")
        # Times: kernel and library as graph replays, the plain version
        # eagerly (its boolean row mask cannot be captured in a graph).
        composed = t_k[rows_lp].clone()
        itemsize = tbl.element_size()
        b_ms, b_by = bound_ms(real_s * grp * h * (2 * itemsize + 4)
                              + slots * 4, real_s * grp * h, "f32")
        results[name] = dict(
            source="dssm_tpu_torch/csrc/scatter_sr.cu",
            replaces=f"dssm_tpu/kernels/pallas_gather.py:{line}",
            max_abs_err=0.0, tolerance="bit-equal (same Philox stream)",
            ms=graph_ms(lambda: fn(t_k, uniq_lp, upd, grp, 5, impl="kernel")),
            plain_ms=eager_ms(lambda: fn_plain(t_k, uniq_lp, upd, grp, 5),
                              reps=5, trials=3),
            library_ms=graph_ms(lambda: t_k.index_copy_(0, rows_lp,
                                                        composed)),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"table {tuple(tbl.shape)} {tname}, {slots} slots of "
                  f"{grp} rows, {real_s} real; {SR_SEEDS}-seed mean: "
                  f"{beyond:.4f} beyond 3 sigma, bias {bias:.1e} grid steps; "
                  "plain timed eagerly",
        )
        del tbl, t_k, upd, small, acc, total, old_rows, composed

    # The scatter-add's bf16 branch (a bf16 table trained with
    # train.table_stochastic_round=False): rounded to nearest, bit-equal.
    tbl16 = table[: 1 << 16].to(torch.bfloat16)
    g16 = torch.tensor([5, 1 << 25, 4095, 0], dtype=torch.int32, device=dev)
    v16 = (torch.from_numpy(rng.normal(size=(4 * 16, h)).astype(
        np.float32)).to(dev) * 1e-3).to(torch.bfloat16)
    check(torch.equal(
        scatter_add_row_groups(tbl16.clone(), g16, v16, 16, impl="kernel"),
        scatter_add_row_groups_plain(tbl16.clone(), g16, v16, 16)),
        "scatter_add_row_groups differs on a bf16 table")

    # The joint lookup's bf16-compact branch, forward and backward, and the
    # fused lookup on the bf16 table, on the bf16 stream's first batch.
    tb16 = batch_to_torch(lowprec["bfloat16"]["batches"][0], dev)
    f16 = [tb16[k].contiguous() for k in ("sel", "q_inv", "q_wgt", "d_inv",
                                          "d_wgt")]
    table16 = table.to(torch.bfloat16)
    compact16 = gather_row_groups(table16, tb16["uniq"], 16, impl="kernel")
    fused16 = fused_case(table16, tb16["uniq"], f16, 16, "full, bf16 table")
    rf = results["fused_gather_joint_lookup"]
    rf["max_abs_err"] = max(rf["max_abs_err"], fused16["max_abs_err"])
    rf.update(ms_bfloat16=fused16["ms"], ms_split_bfloat16=fused16["split_ms"],
              ms_plain_bfloat16=fused16["plain_ms"],
              ms_library_bfloat16=fused16["library_ms"],
              ms_library_counts_outside_bfloat16=fused16[
                  "library_ms_counts_outside"],
              ms_bound_bfloat16=fused16["bound_ms"])
    gr16 = compact16.shape[0]
    lk = joint_lookup(compact16, *f16, impl="kernel")
    lp_ = joint_lookup_plain(compact16, *f16)
    err = max(float((a_ - b_).abs().max()) for a_, b_ in zip(lk, lp_))
    scale = max(float(b_.abs().max()) for b_ in lp_)
    check(err <= 1e-5 * scale, f"joint_lookup on a bf16 compact: max err "
          f"{err} over 1e-5 x {scale}")
    dck = joint_lookup_bwd(*f16, g_q, g_d, gr16, impl="kernel")
    dcp = joint_lookup_bwd_plain(*f16, g_q, g_d, gr16)
    err_b, scale_b = float((dck - dcp).abs().max()), float(dcp.abs().max())
    check(err_b <= 1e-5 * scale_b, f"joint_lookup_bwd at the bf16 table's "
          f"slots: max err {err_b} over 1e-5 x {scale_b}")
    results["joint_lookup"]["ms_bfloat16"] = graph_ms(
        lambda: joint_lookup(compact16, *f16, impl="kernel"))
    results["joint_lookup_bwd"]["ms_bfloat16"] = graph_ms(
        lambda: joint_lookup_bwd(*f16, g_q, g_d, gr16, impl="kernel"))
    del compact16, tb16, lk, lp_, dck, dcp, table16

    # Rank count: unit vectors with ranks spread from 1 into the hundreds,
    # redrawn until no score lies within 1e-5 of its row's true score, so
    # the kernel's and the plain version's sums cannot disagree on a count.
    def rank_case(n, nd):
        q_ = F.normalize(torch.from_numpy(rng.normal(size=(n, dims[-1]))
                                          .astype(np.float32)).to(dev), dim=1)
        d_ = F.normalize(torch.from_numpy(rng.normal(size=(nd, dims[-1]))
                                          .astype(np.float32)).to(dev), dim=1)
        d_[:n] = F.normalize(d_[:n] + 0.35 * q_, dim=1)
        diag = torch.arange(n, device=dev)

        def gaps():
            gap_ = (q_ @ d_.T - true_scores(q_, d_)[:, None]).abs()
            gap_[diag, diag] = 1.0
            return gap_

        redrawn = []
        for _ in range(20):
            close = gaps() < 2e-5
            bad = (close.any(dim=1) | close.any(dim=0)[:n]).nonzero()[:, 0]
            redrawn.append(bad.numel())
            if bad.numel() == 0:
                break
            new_q = F.normalize(torch.from_numpy(rng.normal(size=(
                bad.numel(), dims[-1])).astype(np.float32)).to(dev), dim=1)
            new_d = F.normalize(F.normalize(torch.from_numpy(rng.normal(size=(
                bad.numel(), dims[-1])).astype(np.float32)).to(dev), dim=1)
                + 0.35 * new_q, dim=1)
            q_.index_copy_(0, bad, new_q)
            d_.index_copy_(0, bad, new_d)
        margin = float(gaps().min())
        check(margin >= 1e-5, f"rank_counts inputs ({n} x {nd}): a score "
              f"within {margin} of its true score after redrawing "
              f"{redrawn} rows")
        return q_.contiguous(), d_.contiguous(), margin

    for n_, nd_ in ((1000, 1777), (RANK_N, RANK_N)):
        rq, rd, margin = rank_case(n_, nd_)
        r_k = rank_counts(rq, rd, impl="kernel")
        r_p = rank_counts_plain(rq, rd)
        torch.cuda.synchronize()
        check(torch.equal(r_k, r_p), f"rank_counts differs from its plain "
              f"version at {n_} x {nd_} ({int((r_k != r_p).sum())} ranks)")
        check(int(r_k.min()) == 1 and int(r_k.max()) > 10,
              f"rank_counts: ranks {int(r_k.min())}..{int(r_k.max())}")
    true_r = true_scores(rq, rd)
    b_ms, b_by = bound_ms((rq.numel() + rd.numel() + 2 * RANK_N) * 4,
                          2.0 * RANK_N * RANK_N * dims[-1], "f32")
    results["rank_counts"] = dict(
        source="dssm_tpu_torch/csrc/rank.cu",
        replaces="dssm_tpu/kernels/pallas_rank.py:84",
        max_abs_err=0.0,
        tolerance=f"equal (no score within {margin:.2g} of a true score)",
        ms=graph_ms(lambda: rank_counts(rq, rd, impl="kernel"), reps=5),
        plain_ms=graph_ms(lambda: rank_counts_plain(rq, rd), reps=5),
        library_ms=graph_ms(lambda: (rq @ rd.T > true_r[:, None]).sum(1),
                            reps=5),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"q, d ({RANK_N}, {dims[-1]}) f32, ranks "
              f"{int(r_k.min())}..{int(r_k.max())}; also equal at a ragged "
              "1000 x 1777",
    )
    del rq, rd
    new_names = ("joint_lookup", "joint_lookup_bwd", "count_lookup_bwd",
                 "dense_tower_residuals", "in_batch_loss", "in_batch_loss_dq",
                 "in_batch_loss_dd", "scatter_add_row_groups",
                 "scatter_sr_row_groups", "scatter_sr_int8_row_groups",
                 "rank_counts", "fused_gather_joint_lookup")
    for extra in ("gather_row_groups", "joint_lookup", "joint_lookup_bwd",
                  "fused_gather_joint_lookup"):
        r = results[extra]
        print(f"{extra} at the low-precision tables' shapes: "
              + ", ".join(f"{k[3:]} {r[k]:.4f} ms" for k in r
                          if k.startswith("ms_")) + f" on {card}")
    for name in new_names:
        r = results[name]
        r["eager_ms"] = None
        fwd = ("" if "ms_with_forward" not in r else
               f" ({r['ms_with_forward']:.4f} ms after the kernels' forward)")
        print(f"{name}: kernel {r['ms']:.4f} ms{fwd}, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), max err "
              f"{r['max_abs_err']:.3g} (tolerance {r['tolerance']}) "
              f"[{r['shape']}] on {card}")

    # ---- phase 3c: the raw-index embedding bag ---------------------------
    # At the shapes of the raw-index lookups of the cnn preset (word rows
    # [1024, 16, 8] into Wc [30000, 1024]), the lstm preset (into Win
    # [30000, 384]) and the full preset ([1024, 64] into W0 [500000, 384]),
    # on the f32 tables of seeded fresh inits and their bf16 casts: the
    # forward and the weight gradient against their plain versions, and the
    # autograd Function's table and weight gradients against autograd of
    # the plain version. Indices and weights are the first raw batch of each
    # preset's stream; gradients are seeded normals. The cnn and lstm
    # presets share vocab and data layout, so one hashed corpus serves both.
    seq_cfg = {a: validate(get_preset(a)) for a in ("cnn", "lstm")}
    sc = seq_cfg["cnn"]
    t0 = time.perf_counter()
    seq_pairs = make_toy_pairs(sc.data.toy_num_pairs, sc.data.toy_vocab_words,
                               sc.data.seed)
    seq_train_p, seq_eval_p = train_eval_split(
        seq_pairs, eval_frac=sc.data.eval_frac, seed=sc.data.seed)
    seq_train = hash_pairs(seq_train_p, sc.tower, sc.data)
    seq_eval = hash_pairs(seq_eval_p, sc.tower, sc.data)
    print(f"cnn / lstm corpus: the presets' {len(seq_pairs)} toy pairs "
          f"({len(seq_train)} train / {len(seq_eval)} eval), bag and per-word "
          f"fields hashed in {time.perf_counter() - t0:.1f} s (not cut)")
    seq_params = {}
    for arch, c in seq_cfg.items():
        t0 = time.perf_counter()
        seq_params[arch] = model_base.init_params(c.tower, seed=c.train.seed,
                                                  device=dev)
        torch.cuda.synchronize()
        print(f"fresh init of the {arch} preset on the card: "
              f"{time.perf_counter() - t0:.1f} s, "
              + ", ".join(f"{k} {tuple(v.shape)}" for k, v in
                          seq_params[arch]["shared"].items()))

    def seq_stream(arch, dedup, seed_offset=0):
        c = seq_cfg[arch]
        return batch_iterator(
            seq_train, c.train.batch_size, True,
            seed=c.train.seed + seed_offset,
            dedup_unique=c.data.max_unique if dedup else None, dedup_group=8,
            dedup_unique_rows=c.data.max_unique_rows, dedup_joint=True)

    raw_seq = batch_to_torch(next(seq_stream("cnn", False)), dev)
    raw_full = batch_to_torch(next(batch_iterator(
        hashed_train, cfg.train.batch_size, seed=cfg.train.seed)), dev)
    bag_inputs = {
        "cnn": (seq_params["cnn"]["shared"]["Wc"], raw_seq["d_idx"],
                raw_seq["d_wgt"]),
        "lstm": (seq_params["lstm"]["shared"]["Win"], raw_seq["d_idx"],
                 raw_seq["d_wgt"]),
        "full": (table, raw_full["d_idx"], raw_full["d_wgt"]),
    }
    bag_cases = {}
    for case, (tbl32, b_idx, b_wgt) in bag_inputs.items():
        hh, kk = tbl32.shape[1], b_idx.shape[-1]
        rows_b = b_idx.numel() // kk
        g_b = torch.from_numpy(rng.normal(size=(*b_idx.shape[:-1], hh)).astype(
            np.float32)).to(dev)
        live = b_wgt != 0
        nnz_b = int(live.sum())
        uniq_live = int(torch.unique(b_idx[live]).numel())
        uniq_all = int(torch.unique(b_idx).numel())
        idx_l = b_idx.long()
        idx2 = idx_l.reshape(rows_b, kk)
        for dname, tbl in (("float32", tbl32),
                           ("bfloat16", tbl32.to(torch.bfloat16))):
            isz = tbl.element_size()
            out_k = embedding_bag(tbl, b_idx, b_wgt, impl="kernel")
            out_p = embedding_bag_plain(tbl, b_idx, b_wgt)
            dw_k = embedding_bag_dwgt(tbl, b_idx, g_b, impl="kernel")
            dw_p = embedding_bag_dwgt_plain(tbl, b_idx, g_b)
            torch.cuda.synchronize()
            err_f, sc_f = (float((out_k - out_p).abs().max()),
                           float(out_p.abs().max()))
            check(err_f <= 1e-5 * sc_f, f"embedding_bag ({case}, {dname}): "
                  f"max err {err_f} over 1e-5 x max |out| {sc_f}")
            err_w, sc_w = (float((dw_k - dw_p).abs().max()),
                           float(dw_p.abs().max()))
            check(err_w <= 1e-5 * sc_w, f"embedding_bag_bwd ({case}, {dname}):"
                  f" max err {err_w} over 1e-5 x max |d_wgt| {sc_w}")
            del out_k, out_p, dw_k, dw_p
            grad_errs = {}
            if dname == "float32":
                # The autograd Function: d_table by the plain segment sum,
                # d_wgt by the kernel, against autograd of the plain bag.
                grads = {}
                for impl in ("kernel", "plain"):
                    tl = tbl.detach().clone().requires_grad_(True)
                    wl = b_wgt.clone().requires_grad_(True)
                    (embedding_bag(tl, b_idx, wl, impl=impl) * g_b).sum(
                        ).backward()
                    grads[impl] = (tl.grad, wl.grad)
                    del tl, wl
                for gname, a_, b_ in zip(("d_table", "d_wgt"),
                                         grads["kernel"], grads["plain"]):
                    e_, s_ = float((a_ - b_).abs().max()), float(
                        b_.abs().max())
                    check(e_ <= 1e-5 * s_, f"embedding_bag autograd ({case}): "
                          f"{gname} max err {e_} over 1e-5 x {s_}")
                    grad_errs[gname] = e_
                del grads
            fb, fby = bound_ms(b_idx.numel() * 8 + uniq_live * hh * isz
                               + rows_b * hh * 4, 2.0 * nnz_b * hh, "f32")
            wb, wby = bound_ms(b_idx.numel() * 8 + rows_b * hh * 4
                               + uniq_all * hh * isz, 2.0 * b_idx.numel() * hh,
                               "f32")
            w2 = b_wgt.reshape(rows_b, kk).to(tbl.dtype)
            # The wrapper's range check reads a flag back from the card,
            # which a graph cannot capture: the graph replays the kernel's
            # launch (counted as the wrapper counts it), and the check is
            # timed alone on the host clock, its read-back included.
            check_ms = []
            for _ in range(21):
                t0 = time.perf_counter()
                check_rows(b_idx, b_wgt, tbl.shape[0])
                check_ms.append((time.perf_counter() - t0) * 1e3)
            bag_cases[(case, dname)] = dict(
                fwd_ms=graph_ms(lambda: embed_mod._forward_kernel(
                    tbl, b_idx, b_wgt)),
                check_rows_host_ms=statistics.median(check_ms),
                fwd_plain_ms=graph_ms(lambda: embedding_bag_plain(
                    tbl, b_idx, b_wgt)),
                fwd_library_ms=graph_ms(lambda: F.embedding_bag(
                    idx2, tbl, per_sample_weights=w2, mode="sum")),
                fwd_bound_ms=fb, fwd_bound_by=fby, fwd_err=err_f,
                dwgt_ms=graph_ms(lambda: embedding_bag_dwgt(
                    tbl, b_idx, g_b, impl="kernel")),
                dwgt_plain_ms=graph_ms(lambda: embedding_bag_dwgt_plain(
                    tbl, b_idx, g_b)),
                dwgt_library_ms=graph_ms(lambda: (
                    tbl[idx_l] * g_b[..., None, :]).sum(-1)),
                dwgt_bound_ms=wb, dwgt_bound_by=wby, dwgt_err=err_w,
                autograd_errs=grad_errs,
                shape=f"table {tuple(tbl.shape)} {dname}, idx "
                      f"{tuple(b_idx.shape)}, {nnz_b} live lookups on "
                      f"{uniq_live} rows")
            del w2
            if dname == "bfloat16":
                del tbl
        del g_b
    # The gather, the joint lookup and the fused lookup at the cnn shapes:
    # 1024 group slots of 8 rows x 1024 columns (a 32 MB compact block),
    # 16384 word rows a side, the first union-dedupe batch of the cnn
    # stream; bf16 gradients.
    tb_c = batch_to_torch(next(seq_stream("cnn", True)), dev)
    wc = seq_params["cnn"]["shared"]["Wc"]
    uniq_c = tb_c["uniq"]
    comp_c = gather_row_groups(wc, uniq_c, 8, impl="kernel")
    check(torch.equal(comp_c, gather_row_groups(wc, uniq_c, 8, impl="plain")),
          "gather_row_groups differs from its plain version at the cnn shapes")
    jf = [tb_c[k].contiguous() for k in ("sel", "q_inv", "q_wgt", "d_inv",
                                          "d_wgt")]
    lk_c = joint_lookup(comp_c, *jf, impl="kernel")
    lp_c = joint_lookup_plain(comp_c, *jf)
    g_qc, g_dc = (torch.from_numpy(rng.normal(size=tuple(lk_c[0].shape))
                                   .astype(np.float32)).to(dev).to(bf)
                  for _ in range(2))
    gr_c = comp_c.shape[0]
    dck_c = joint_lookup_bwd(*jf, g_qc, g_dc, gr_c, impl="kernel")
    dck_c2 = joint_lookup_bwd(*jf, g_qc, g_dc, gr_c, impl="kernel")
    dcp_c = joint_lookup_bwd_plain(*jf, g_qc, g_dc, gr_c)
    torch.cuda.synchronize()
    check(torch.equal(dck_c, dck_c2), "joint_lookup_bwd at the cnn shapes: "
          "two calls on the same inputs differ (bit-equal expected)")
    seg_cnn = bwd_segments(*jf, gr_c)
    print("joint_lookup_bwd at the cnn shapes run twice: bit-equal; segments: "
          + json.dumps(seg_cnn))
    err_c = max(float((a_ - b_).abs().max()) for a_, b_ in zip(lk_c, lp_c))
    sc_c = max(float(b_.abs().max()) for b_ in lp_c)
    check(err_c <= 1e-5 * sc_c, f"joint_lookup at the cnn shapes: max err "
          f"{err_c} over 1e-5 x {sc_c}")
    errb_c, scb_c = (float((dck_c - dcp_c).abs().max()),
                     float(dcp_c.abs().max()))
    check(errb_c <= 1e-5 * scb_c, f"joint_lookup_bwd at the cnn shapes: max "
          f"err {errb_c} over 1e-5 x {scb_c}")
    real_c = int((uniq_c < wc.shape[0] // 8).sum())
    hc = wc.shape[1]
    nnz_c = int((jf[2] != 0).sum() + (jf[4] != 0).sum())
    rows_c = jf[1].numel() // jf[1].shape[-1]
    both_c = torch.unique(torch.cat([
        jf[0].long()[jf[1].long()[jf[2] != 0]],
        jf[0].long()[jf[3].long()[jf[4] != 0]]])).numel()
    idx_bytes_c = (jf[1].numel() + jf[3].numel()) * 8 + jf[0].numel() * 4
    fused_c = fused_case(wc, uniq_c, jf, 8, "cnn shapes")
    flat_qc = jf[0].long()[jf[1].long().reshape(-1)]
    flat_dc = jf[0].long()[jf[3].long().reshape(-1)]

    def cnn_bwd_library():
        # The two index_add_ of the full shapes' library, on the word rows.
        dc_ = torch.zeros((gr_c, hc), device=dev)
        dc_.index_add_(0, flat_qc, (jf[2][..., None] * g_qc.float()[
            ..., None, :]).reshape(-1, hc))
        return dc_.index_add_(0, flat_dc, (jf[4][..., None] * g_dc.float()[
            ..., None, :]).reshape(-1, hc))

    rf = results["fused_gather_joint_lookup"]
    rf["max_abs_err"] = max(rf["max_abs_err"], fused_c["max_abs_err"])
    rf.update(ms_split_cnn=fused_c["split_ms"],
              ms_plain_cnn=fused_c["plain_ms"],
              ms_library_cnn=fused_c["library_ms"],
              ms_library_counts_outside_cnn=fused_c[
                  "library_ms_counts_outside"],
              ms_bound_cnn=fused_c["bound_ms"])
    cnn_shapes = {
        "fused_gather_joint_lookup": fused_c,
        "gather_row_groups": dict(
            ms=graph_ms(lambda: gather_row_groups(wc, uniq_c, 8,
                                                  impl="kernel")),
            plain_ms=graph_ms(lambda: gather_row_groups(wc, uniq_c, 8,
                                                        impl="plain")),
            bound_ms=bound_ms((real_c + uniq_c.numel()) * 8 * hc * 4
                              + uniq_c.numel() * 4, 0, "f32")[0],
            max_abs_err=0.0),
        "joint_lookup": dict(
            ms=graph_ms(lambda: joint_lookup(comp_c, *jf, impl="kernel")),
            plain_ms=graph_ms(lambda: joint_lookup_plain(comp_c, *jf)),
            bound_ms=bound_ms(idx_bytes_c + both_c * hc * 4
                              + 2 * rows_c * hc * 4, 2.0 * nnz_c * hc,
                              "f32")[0],
            max_abs_err=err_c),
        "joint_lookup_bwd": dict(
            ms=graph_ms(lambda: joint_lookup_bwd(*jf, g_qc, g_dc, gr_c,
                                                 impl="kernel")),
            plain_ms=graph_ms(lambda: joint_lookup_bwd_plain(
                *jf, g_qc, g_dc, gr_c)),
            library_ms=graph_ms(cnn_bwd_library), segments=seg_cnn,
            bound_ms=bound_ms(idx_bytes_c + 2 * rows_c * hc * 2
                              + gr_c * hc * 4, 2.0 * nnz_c * hc, "f32")[0],
            max_abs_err=errb_c),
    }
    for name, r_ in cnn_shapes.items():
        results[name]["ms_cnn"] = r_["ms"]
    results["joint_lookup_bwd"].update(
        ms_library_cnn=cnn_shapes["joint_lookup_bwd"]["library_ms"],
        ms_plain_cnn=cnn_shapes["joint_lookup_bwd"]["plain_ms"],
        ms_bound_cnn=cnn_shapes["joint_lookup_bwd"]["bound_ms"],
        segments_cnn=seg_cnn)
    print("gather, joint and fused lookups at the cnn shapes (compact "
          f"{tuple(comp_c.shape)} f32, {real_c} real slots, word rows "
          f"{rows_c} a side, {nnz_c} live lookups on {both_c} rows): "
          + json.dumps(cnn_shapes) + f" on {card}")
    del tb_c, comp_c, lk_c, lp_c, g_qc, g_dc, dck_c, dck_c2, dcp_c, jf
    del flat_qc, flat_dc

    main_bag = bag_cases[("cnn", "float32")]
    for name, pre, line in (("embedding_bag", "fwd", 147),
                            ("embedding_bag_bwd", "dwgt", 163)):
        results[name] = dict(
            source="dssm_tpu_torch/csrc/embed.cu",
            replaces=f"dssm_tpu/kernels/pallas_embed.py:{line}",
            max_abs_err=max(r_[f"{pre}_err"] for r_ in bag_cases.values()),
            tolerance="1e-5 x max |out| (every shape and table dtype)",
            ms=main_bag[f"{pre}_ms"], plain_ms=main_bag[f"{pre}_plain_ms"],
            library_ms=main_bag[f"{pre}_library_ms"],
            bound_ms=main_bag[f"{pre}_bound_ms"],
            bound_by=main_bag[f"{pre}_bound_by"], eager_ms=None,
            shape=main_bag["shape"],
            **{f"ms_{c_}_{d_}": r_[f"{pre}_ms"]
               for (c_, d_), r_ in bag_cases.items()})
    for (case, dname), r_ in bag_cases.items():
        print(f"embedding bag, {case} shapes, {dname} table: " + json.dumps(
            {k: v for k, v in r_.items()}) + f" on {card}")

    # ---- phase 4: the training path at full width ------------------------
    def clone_params(p):
        return {tw: {k: v.clone() for k, v in tp_.items()}
                for tw, tp_ in p.items()}

    def run_steps(run_cfg, state, batches_np, impl):
        """Drive the steps as cli/train does (numpy batch -> device ->
        step, no wait in between); (state, losses, wall s)."""
        step_fn = make_train_step(run_cfg, impl)
        losses = []
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for b_np in batches_np:
            state, aux = step_fn(state, batch_to_torch(b_np, dev))
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        return state, [float(v) for v in losses], wall

    def grid_steps_apart(a, b, before):
        """Largest distance between two updated tables in grid steps, and
        the share of elements that differ. A grid step is an int8 level, or
        the bf16 ulp of the largest of the two values and the value before
        the update (an update that nearly cancels a weight leaves a result
        on a much finer grid than the sum was formed on)."""
        if a.dtype == torch.int8:
            gap = (a.to(torch.int32) - b.to(torch.int32)).abs().float()
        else:
            af, bf_ = a.float(), b.float()
            big = torch.maximum(torch.maximum(af.abs(), bf_.abs()),
                                before.float().abs())
            expo = (big.view(torch.int32) >> 23) & 0xFF
            ulp = ((expo - 7).clamp(min=1) << 23).view(torch.float32)
            gap = (af - bf_).abs() / ulp
        return float(gap.max()), float((gap > 0).float().mean())

    def touched_rows(tw, init, batches_np, dedup_group, key="W0"):
        """Mask of the table rows of tower tw that some batch gathered (or,
        on raw-index batches, looked up with a nonzero weight)."""
        sides = {"shared": "qd", "query": "q", "doc": "d"}[tw]
        rows_total = init[tw][key].shape[0]
        touched = torch.zeros((rows_total,), dtype=torch.bool, device=dev)
        if "uniq" not in batches_np[0] and "q_uniq" not in batches_np[0]:
            rows_ = np.unique(np.concatenate(
                [b_np[f"{s_}_idx"][b_np[f"{s_}_wgt"] != 0]
                 for b_np in batches_np for s_ in sides]))
            touched[torch.from_numpy(rows_.astype(np.int64)).to(dev)] = True
            return touched
        keys = (["uniq"] if "uniq" in batches_np[0]
                else [f"{s_}_uniq" for s_ in sides])
        gids_ = np.unique(np.concatenate(
            [b_np[k] for b_np in batches_np for k in keys]))
        gids_ = torch.from_numpy(gids_[gids_ < rows_total // dedup_group]
                                 .astype(np.int64)).to(dev)
        touched[(gids_[:, None] * dedup_group
                 + torch.arange(dedup_group, device=dev)).reshape(-1)] = True
        return touched

    def update_gap(got, want, before, scale=None):
        """||got - want|| / ||want - before||: how far two runs' updates of
        one tensor lie apart, in units of the plain run's update (an int8
        table in the weights' units, levels x its row scale). A wrong
        update (missing, doubled, on other rows) reads 1 or more."""
        apart, moved = got.float() - want.float(), want.float() - before.float()
        if scale is not None:
            apart, moved = apart * scale, moved * scale
        a_, m_ = (float(torch.linalg.vector_norm(apart)),
                  float(torch.linalg.vector_norm(moved)))
        return a_ / m_ if m_ > 0 else (0.0 if a_ == 0 else float("inf"))

    def compare_training(run_cfg, init, batches_np, what, expect,
                         dedup_group=group, loss_tol=2e-2):
        """The same steps from the same state through the kernels and
        through the plain versions; checks and returns the kernel run.
        ONE step from the same state: every f32 parameter's largest
        difference is held to 1e-2 of that tensor's largest update (a
        gradient formed in bf16 compute parts by one bf16 rounding, 2^-8 of
        itself, where an f32 sum's last bits tip it; 2.3e-3 to 4.6e-3 read
        on an H100 over every branch), and a
        bf16 or int8 table is compared in grid steps (both runs draw the
        same random stream, so they part only where the accumulators' last
        bits tip a rounding). The whole run: under bf16 compute the two
        runs drift apart step by step (a tower activation rounds to the
        neighbouring bf16 value, the backward's atomics add in another
        order), so the loss curves are held to loss_tol and each
        parameter's update (the table's on its touched rows) to 0.1 of
        itself, by update_gap: a wrong update reads 1 or more, the sound
        runs of every branch on an H100 at most 0.039 (the cnn's)."""
        steps = len(batches_np)
        key = model_base.TABLE_KEY[run_cfg.tower.arch]
        # Warm-up outside the counted run (cuBLAS handles, allocator): one
        # step of each on copies, kept for the one-step comparison.
        first = {}
        for impl in ("auto", "plain"):
            first[impl] = run_steps(
                run_cfg, create_run_state(run_cfg, clone_params(init)),
                batches_np[:1], impl)[0].params
        first_gap, first_share, first_param_gap, first_rel = 0.0, 0.0, 0.0, 0.0
        for tw in init:
            for k, want in first["plain"][tw].items():
                if want.dtype != torch.float32 or k == f"{key}_scale":
                    continue  # a low-precision table: in grid steps, below
                apart = float((first["auto"][tw][k] - want).abs().max())
                moved = float((want - init[tw][k]).abs().max())
                first_param_gap = max(first_param_gap, apart)
                first_rel = max(first_rel, apart / moved if moved > 0 else (
                    0.0 if apart == 0 else float("inf")))
            if init[tw][key].dtype != torch.float32:
                hit = touched_rows(tw, init, batches_np[:1], dedup_group, key)
                first_gap, first_share = grid_steps_apart(
                    first["auto"][tw][key][hit], first["plain"][tw][key][hit],
                    init[tw][key][hit])
        del first
        check(first_rel <= 1e-2, f"{what}: after one step from the same "
              f"state kernel and plain parameters differ by {first_param_gap}"
              f", {first_rel} of the tensor's largest update > 1e-2")
        s_p, loss_p, wall_p = run_steps(
            run_cfg, create_run_state(run_cfg, clone_params(init)),
            batches_np, "plain")
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        s_k, loss_k, wall_k = run_steps(
            run_cfg, create_run_state(run_cfg, clone_params(init)),
            batches_np, "auto")
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for name, n in expect.items():
            check(counts[name] == n * steps, f"{what}: kernel {name} "
                  f"launched {counts[name]} times in {steps} steps, "
                  f"expected {n} a step")
        for name, n in counts.items():
            check(name in expect or n == 0, f"{what}: kernel {name} "
                  f"launched {n} times, expected none")
        check(all(np.isfinite(loss_k)), f"{what}: non-finite loss")
        gap = max(abs(a - b) for a, b in zip(loss_k, loss_p))
        check(gap <= loss_tol, f"{what}: kernel and plain loss curves differ "
              f"by {gap} > {loss_tol}")
        dense_gap = table_gap = dense_rel = table_rel = 0.0
        for tw, tp_ in s_p.params.items():
            touched = touched_rows(tw, init, batches_np, dedup_group, key)
            scale_ = tp_.get(f"{key}_scale")
            for k, want in tp_.items():
                got = s_k.params[tw][k]
                if k == key:
                    check(torch.equal(got[~touched], init[tw][k][~touched]),
                          f"{what}: table rows of no gathered group changed")
                    check(not torch.equal(got[touched], init[tw][k][touched]),
                          f"{what}: the table did not move")
                    sc_t = None if scale_ is None else scale_[touched]
                    diff = (got[touched].float() - want[touched].float()).abs()
                    if sc_t is not None:  # int8: in the weights' units
                        diff = diff * sc_t
                    table_gap = max(table_gap, float(diff.max()))
                    table_rel = max(table_rel, update_gap(
                        got[touched], want[touched], init[tw][k][touched],
                        sc_t))
                elif k == f"{key}_scale":
                    check(torch.equal(got, init[tw][k]),
                          f"{what}: the int8 scale changed")
                else:
                    dense_gap = max(dense_gap,
                                    float((got - want).abs().max()))
                    dense_rel = max(dense_rel,
                                    update_gap(got, want, init[tw][k]))
        check(dense_rel <= 0.1 and table_rel <= 0.1, f"{what}: kernel and "
              f"plain updates lie {dense_rel} (dense) / {table_rel} (table "
              "rows touched) of themselves apart > 0.1")
        return dict(state=s_k, loss=loss_k, loss_plain=loss_p, wall_s=wall_k,
                    plain_wall_s=wall_p, counts=counts,
                    peak=peak, resident=resident, loss_gap=gap,
                    dense_gap=dense_gap, table_gap=table_gap,
                    dense_update_gap=dense_rel, table_update_gap=table_rel,
                    first_step_grid_gap=first_gap,
                    first_step_differ_share=first_share,
                    first_step_param_gap=first_param_gap,
                    first_step_update_gap=first_rel)

    def gaps(run):
        """A run's kernel-vs-plain distances, for its summary line."""
        return {k: run[k] for k in (
            "loss_gap", "first_step_param_gap", "first_step_update_gap",
            "dense_gap", "dense_update_gap", "table_gap", "table_update_gap")}

    # An f32 or bf16 table's joint step: one fused lookup (no gather, no
    # joint lookup forward); an int8 table's keeps the split path.
    joint_kernels = ("fused_gather_joint_lookup", "dense_tower_residuals",
                     "in_batch_loss", "in_batch_loss_dq", "in_batch_loss_dd",
                     "joint_lookup_bwd", "scatter_add_row_groups")
    tr = compare_training(cfg, params, host_batches_t[:TRAIN_STEPS],
                          "training (joint branch)",
                          {k: 1 for k in joint_kernels})
    first, last = (statistics.mean(tr["loss"][:4]),
                   statistics.mean(tr["loss"][-4:]))
    check(last < 0.9 * first, f"training: the loss did not fall (first 4 "
          f"steps {first:.4f}, last 4 {last:.4f})")
    for name in joint_kernels:
        results[name]["launches"] = tr["counts"][name]
    print(f"trained {TRAIN_STEPS} steps of the full preset: loss "
          f"{tr['loss'][0]:.4f} -> {tr['loss'][-1]:.4f} (first 4 mean "
          f"{first:.4f}, last 4 {last:.4f}); untouched rows bit-unchanged; "
          f"launches per step 1 of each of {len(joint_kernels)} kernels; "
          f"kernel vs plain: {json.dumps(gaps(tr))}")

    # Where the step's time goes: 8 more steps under the profiler.
    from torch.profiler import ProfilerActivity, profile

    step_fn = make_train_step(cfg, "auto")
    state_prof = tr["state"]
    prof_batches = host_batches_t[TRAIN_STEPS:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_t:
        t0 = time.perf_counter()
        for b_np in prof_batches:
            state_prof, _ = step_fn(state_prof, batch_to_torch(b_np, dev))
        torch.cuda.synchronize()
        prof_wall_t = time.perf_counter() - t0
    dev_us_t, top_t = device_time_us(prof_t, 12)
    n_prof = len(prof_batches)
    h2d_ms = []
    for b_np in host_batches_t[:TRAIN_STEPS]:  # H2D alone, waited for
        t0 = time.perf_counter()
        batch_to_torch(b_np, dev)
        torch.cuda.synchronize()
        h2d_ms.append((time.perf_counter() - t0) * 1e3)
    wire_bytes = sum(v.nbytes for v in host_batches_t[0].values())
    train_path = dict(
        card=card, steps=TRAIN_STEPS, batch=cfg.train.batch_size,
        train_pairs=len(hashed_train),
        loss_first_last=[tr["loss"][0], tr["loss"][-1]],
        steps_per_s=TRAIN_STEPS / tr["wall_s"],
        pairs_per_s=TRAIN_STEPS * cfg.train.batch_size / tr["wall_s"],
        plain_steps_per_s=TRAIN_STEPS / tr["plain_wall_s"],
        step_ms=tr["wall_s"] * 1e3 / TRAIN_STEPS,
        host_prep_ms_per_batch=statistics.median(host_prep_ms),
        h2d_ms_per_step=statistics.median(h2d_ms),
        wire_bytes_per_batch=wire_bytes,
        traced_wall_ms_per_step=prof_wall_t * 1e3 / n_prof,
        traced_device_busy_ms_per_step=(
            None if dev_us_t is None else dev_us_t / 1e3 / n_prof),
        device_busy_share_traced=(
            None if dev_us_t is None else dev_us_t / 1e6 / prof_wall_t),
        peak_mem_gb=tr["peak"] / 1e9,
        resident_before_run_gb=tr["resident"] / 1e9,
        real_group_slots_first_batch=real_t,
    )
    print("training path: " + json.dumps(train_path))
    print(f"device time by kernel in the traced steps (us, {n_prof} steps): "
          + json.dumps(top_t))

    # The per-side branch (separate towers, per-side dedupe): the path of
    # the count lookup's backward kernel.
    cfg_ps = validate(cfg.replace(tower=t.replace(shared_weights=False)))
    params_ps = model_base.init_params(cfg_ps.tower, seed=cfg.train.seed,
                                       device=dev)
    it = stream(False)
    ps_batches = [next(it) for _ in range(PER_SIDE_STEPS)]
    ps = compare_training(
        cfg_ps, params_ps, ps_batches, "training (per-side branch)",
        {"gather_row_groups": 2, "count_lookup": 2, "count_lookup_bwd": 2,
         "dense_tower_residuals": 2, "in_batch_loss": 1,
         "in_batch_loss_dq": 1, "in_batch_loss_dd": 1,
         "scatter_add_row_groups": 2})
    results["count_lookup_bwd"]["launches"] = ps["counts"]["count_lookup_bwd"]
    print(f"per-side branch, {PER_SIDE_STEPS} steps: loss {ps['loss']}; "
          f"count_lookup_bwd launched {ps['counts']['count_lookup_bwd']} "
          f"times; kernel vs plain: {json.dumps(gaps(ps))}")
    del params_ps, ps

    # ---- phase 4b: the same path on a bf16 and on an int8 table ----------
    # Fresh seeded weights through the entry point (init_params casts or
    # quantizes the table), the stream deduped at the dtype's group size,
    # the stochastic-rounding scatter in the step.
    lowprec_runs = {}
    for tname, sr_name in (("bfloat16", "scatter_sr_row_groups"),
                           ("int8", "scatter_sr_int8_row_groups")):
        lp = lowprec[tname]
        cfg_lp = validate(cfg.replace(tower=t.replace(table_dtype=tname)))
        t0 = time.perf_counter()
        params_lp = model_base.init_params(cfg_lp.tower, seed=cfg.train.seed,
                                           device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        kernels_lp = joint_kernels[:-1] + (sr_name,)
        if tname == "int8":
            kernels_lp = (("gather_row_groups", "joint_lookup")
                          + kernels_lp[1:])
        # An int8 level is 1/16 of a row's largest weight (headroom 8), so a
        # rounding that tips the other way moves a weight 15x further than
        # on the bf16 table and the two runs drift faster: 5e-2 on the loss
        # (under 2% of it) against the other tables' 2e-2.
        run = compare_training(cfg_lp, params_lp, lp["batches"],
                               f"training ({tname} table)",
                               {k: 1 for k in kernels_lp}, lp["group"],
                               5e-2 if tname == "int8" else 2e-2)
        first, last = (statistics.mean(run["loss"][:4]),
                       statistics.mean(run["loss"][-4:]))
        check(last < 0.9 * first, f"training ({tname} table): the loss did "
              f"not fall (first 4 steps {first:.4f}, last 4 {last:.4f})")
        # One step from the same state, the same random stream. int8: the
        # f32 accumulators differ in their last bits, each run rounds to a
        # neighbour of its own: under 2 levels. bf16: the compact gradient
        # is rounded to bf16 first, and where the atomics tip that rounding
        # the update differs by one bf16 ulp of itself, at most 2 ulps of
        # the larger of the old and new weight; with a neighbour on each
        # side that is under 4 grid steps (2.0 was the most seen).
        gap_limit = 4 if tname == "bfloat16" else 2
        check(run["first_step_grid_gap"] <= gap_limit
              and run["first_step_differ_share"] <= 0.1,
              f"training ({tname} table): after one step from the same state "
              f"kernel and plain tables are {run['first_step_grid_gap']} "
              f"grid steps apart and {run['first_step_differ_share']:.4%} of "
              "the touched elements differ (same random stream: expected at "
              f"most {gap_limit} steps and 10%)")
        results[sr_name]["launches"] = run["counts"][sr_name]
        if tname == "int8":
            results["joint_lookup"]["launches"] = run["counts"]["joint_lookup"]
        table_lp = run["state"].params["shared"]["W0"]
        table_mb = (table_lp.numel() * table_lp.element_size()
                    + (table_lp.shape[0] * 4 if tname == "int8" else 0)) / 1e6
        summary = dict(
            card=card, table_dtype=tname, table_mb=table_mb, steps=TRAIN_STEPS,
            init_s=init_s, loss_first_last=[run["loss"][0], run["loss"][-1]],
            steps_per_s=TRAIN_STEPS / run["wall_s"],
            plain_steps_per_s=TRAIN_STEPS / run["plain_wall_s"],
            **gaps(run),
            first_step_table_gap_grid_steps=run["first_step_grid_gap"],
            first_step_table_elements_differing=run[
                "first_step_differ_share"],
            peak_mem_gb=run["peak"] / 1e9,
            # of which alive before the run: the f32 model and its trained
            # copy, this table's init and the plain run's copy
            resident_before_run_gb=run["resident"] / 1e9)
        print(f"training path, {tname} table: " + json.dumps(summary))
        lowprec_runs[tname] = dict(cfg=cfg_lp, state=run["state"],
                                   summary=summary)
        del params_lp, run

    # ---- phase 4c: evaluation of the three trained models -----------------
    # The held-out split of the smoke corpus through evaluate(): both
    # towers over every batch, then the rank count. Kernels against plain
    # versions; the second pass reads the cache of prepared batches.
    def near_ties(q_, d_, width):
        """Per query, the docs scoring within `width` of the true doc."""
        gap_ = (q_ @ d_.T - true_scores(q_, d_)[:, None]).abs()
        diag = torch.arange(q_.shape[0], device=dev)
        gap_[diag, diag] = 1.0
        return (gap_ < width).sum(dim=1)

    eval_runs = {}
    eval_models = [("float32", cfg, tr["state"].params)] + [
        (tname, r_["cfg"], r_["state"].params)
        for tname, r_ in lowprec_runs.items()]
    eval_mod._EVAL_CACHES.clear()
    for tname, cfg_e, params_e in eval_models:
        bs = cfg_e.train.batch_size
        eval_mod.evaluate(params_e, cfg_e, hashed_eval, bs, "auto",
                          cache=False)  # warm-up, outside the counts
        m_plain = eval_mod.evaluate(params_e, cfg_e, hashed_eval, bs, "plain",
                                    cache=False)
        cold, hot = {}, {}
        _build.reset_launch_counts()
        m_cold = eval_mod.evaluate(params_e, cfg_e, hashed_eval, bs, "auto",
                                   cache=True, stats=cold)
        counts_e = _build.launch_counts()
        m_hot = eval_mod.evaluate(params_e, cfg_e, hashed_eval, bs, "auto",
                                  cache=True, stats=hot)
        n_batches = -(-len(hashed_eval) // bs)
        for name, n in (("gather_row_groups", 2 * n_batches),
                        ("count_lookup", 2 * n_batches),
                        ("dense_tower", 2 * n_batches), ("rank_counts", 1)):
            check(counts_e[name] == n, f"evaluate ({tname}): kernel {name} "
                  f"launched {counts_e[name]} times, expected {n}")
        check(cold["cache_hit"] == 0.0 and hot["cache_hit"] == 1.0,
              f"evaluate ({tname}): the second pass did not hit the cache")
        check(m_cold == m_hot, f"evaluate ({tname}): cached and uncached "
              f"metrics differ: {m_cold} / {m_hot}")
        check(m_cold["num_queries"] == len(hashed_eval)
              and all(np.isfinite(v) for v in m_cold.values())
              and 0 < m_cold["recall@1"] <= m_cold["recall@10"] <= 1,
              f"evaluate ({tname}): metrics {m_cold}")
        # Kernels against plain versions: the embeddings differ in their
        # last bits (bf16 tower), so a rank can move where scores nearly
        # tie; every metric is a mean over the queries of a value in [0, 1].
        metric_gap = max(abs(m_cold[k] - m_plain[k]) for k in m_plain)
        check(metric_gap <= 5e-3, f"evaluate ({tname}): kernel and plain "
              f"metrics differ by {metric_gap} > 5e-3: {m_cold} / {m_plain}")
        # The rank kernel against its plain version on the model's own
        # embeddings: a rank may differ only by docs that score within 1e-6
        # of the true doc (duplicate titles embed to the same vector).
        q_e, d_e = eval_mod.embed_corpus(params_e, cfg_e, hashed_eval, bs,
                                         "auto", cache=True)
        r_k = rank_counts(q_e, d_e, impl="kernel")
        r_p = rank_counts_plain(q_e, d_e)
        ties = near_ties(q_e, d_e, 1e-6)
        differing = int((r_k != r_p).sum())
        check(bool(((r_k - r_p).abs() <= ties).all()), f"evaluate ({tname}): "
              f"{differing} ranks differ between the kernel and its plain "
              "version beyond the docs within 1e-6 of the true score")
        eval_runs[tname] = dict(
            card=card, table_dtype=tname, eval_pairs=len(hashed_eval),
            batches=n_batches, metrics=m_cold,
            metric_gap_kernel_vs_plain=metric_gap,
            ranks_differing_kernel_vs_plain=differing,
            queries_with_a_near_tie=int((ties > 0).sum()),
            first_pass_s=dict(cold), cached_pass_s=dict(hot))
        print(f"evaluate, {tname} table: " + json.dumps(eval_runs[tname]))
        del q_e, d_e
    results["rank_counts"]["launches"] = counts_e["rank_counts"]
    eval_mod._EVAL_CACHES.clear()
    del lowprec_runs, eval_models

    # ---- phase 5: train -> save -> restore ---------------------------------
    t0 = time.perf_counter()
    ckpt = Checkpointer(workdir)
    ckpt.save(tr["state"].step, tr["state"])
    t1 = time.perf_counter()
    restored = ckpt.restore(device=dev)
    check(restored.step == TRAIN_STEPS, f"restored step {restored.step}")
    for k, v in tr["state"].params["shared"].items():
        check(torch.equal(restored.params["shared"][k], v),
              f"restored {k} differs from the trained one")
    print(f"checkpoint: saved step {restored.step} in {t1 - t0:.1f} s, "
          f"restored bit-identically in {time.perf_counter() - t1:.1f} s")
    params = restored.params  # the serving phase embeds from these
    remap = load_remap(workdir)
    check(remap is not None and np.array_equal(remap, train_remap),
          "the saved vocab remap did not come back")
    tmp_dir.cleanup()
    del tr, restored, state_prof

    # ---- phase 6: the serving path, from the restored weights -----------
    t0 = time.perf_counter()
    titles = list(dict.fromkeys(pairs.titles))[
        : INDEX_BATCHES * cfg.train.batch_size]
    queries = pairs.queries[:64]
    print(f"serving {len(titles)} titles and {len(queries)} queries from "
          "the trained weights, through the vocab remap training saved")

    # Host-side batches as the doc index sees them: group slots and drops,
    # and the host time split into hashing (both sides, as the serving path
    # hashes them), remap and dedupe; then the doc side hashed alone.
    t0 = time.perf_counter()
    doc_hashed = hash_pairs(ToyPairs(queries=titles, titles=titles), t,
                            cfg.data)
    t1 = time.perf_counter()
    doc_hashed = apply_remap(doc_hashed, remap)
    t2 = time.perf_counter()
    host_batches = list(eval_batches(
        doc_hashed, cfg.train.batch_size, dedup_unique=cfg.data.max_unique,
        dedup_group=8, dedup_unique_rows=cfg.data.max_unique_rows,
        dedup_joint=True))
    t3 = time.perf_counter()
    host_s = t3 - t0
    hash_batch(titles, t.vocab_size, cfg.data.max_trigrams,
               cfg.data.normalize_counts)
    host_split = dict(hash_both_sides_s=t1 - t0, remap_s=t2 - t1,
                      dedupe_s=t3 - t2,
                      hash_doc_side_alone_s=time.perf_counter() - t3)
    unused_share = ((host_split["hash_both_sides_s"]
                     - host_split["hash_doc_side_alone_s"]) / host_s)
    print(f"host prep split (s): {json.dumps(host_split)}; hashing the "
          f"unused query side is {unused_share:.1%} of host prep")
    real_slots = [int((b["uniq"] < SKIP_SENTINEL_GID).sum())
                  for b in host_batches]
    live = int((doc_hashed.d_wgt != 0).sum())
    kept = sum(int((b["d_wgt"] != 0).sum()) for b in host_batches)
    print(f"doc batches: real group slots per batch {real_slots} of cap "
          f"{cfg.data.max_unique // 8}; doc lookups dropped by overflow "
          f"{(live - kept) / live:.4%}; host hash+remap+dedupe "
          f"{host_s:.3f} s for {len(titles)} titles")

    def serve(impl):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d_emb = build_doc_index(params, cfg, titles, cfg.train.batch_size,
                                impl, remap, dev)
        t1 = time.perf_counter()
        q_emb = embed_queries(params, cfg, queries, cfg.train.batch_size,
                              impl, remap, dev)
        s, i = top_k(q_emb, d_emb, k=10, device=dev)
        t2 = time.perf_counter()
        return dict(d=d_emb, q=q_emb, s=s, i=i, index_s=t1 - t0,
                    query_s=t2 - t1,
                    peak=torch.cuda.max_memory_allocated())

    serve("auto")  # warm-up: cuBLAS handles, allocator
    serve("plain")
    # In turns, plain / kernels / kernels / plain; the counts are those of
    # the first kernels run alone.
    plain = serve("plain")
    _build.reset_launch_counts()
    run = serve("auto")
    launches = _build.launch_counts()
    run2, plain2 = serve("auto"), serve("plain")
    for name in ("gather_row_groups", "count_lookup", "dense_tower"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the served path")
        results[name]["launches"] = launches[name]
    n_docs, dim = run["d"].shape
    check((n_docs, dim) == (len(titles), t.semantic_dim),
          f"doc index shape {run['d'].shape}")
    check(bool(np.isfinite(run["d"]).all() and np.isfinite(run["q"]).all()),
          "non-finite embeddings")
    norms = np.linalg.norm(run["d"], axis=1)
    check(bool(np.abs(norms - 1).max() < 1e-4), "doc embeddings not unit norm")
    check(bool((np.diff(run["s"], axis=1) <= 1e-6).all()),
          "top-k scores not descending")
    emb_err = float(np.abs(run["d"] - plain["d"]).max())
    q_err = float(np.abs(run["q"] - plain["q"]).max())
    check(emb_err <= 2e-2 and q_err <= 2e-2,
          f"kernel vs plain embeddings differ by {emb_err} / {q_err} > 2e-2")
    scores_auto = run["q"] @ run["d"].T
    mism = np.argwhere(run["i"] != plain["i"])
    for qi, r in mism:
        gap = abs(scores_auto[qi, plain["i"][qi, r]] - run["s"][qi, r])
        check(gap <= 1e-3, f"top-10 of query {qi} differs at rank {r + 1} "
              f"beyond a tie (score gap {gap})")
    print(f"served: doc emb max |kernel - plain| {emb_err:.3g}, query emb "
          f"{q_err:.3g}, top-10 ids differing at ties {len(mism)} of "
          f"{run['i'].size}")

    # Where the time goes: the device forward of the prepared doc batches,
    # traced, against the host pipeline that prepares them.
    tower = model_base.tower_module(params, t, "d")
    dev_batches = [batch_to_torch(pad_batch(b, cfg.train.batch_size), dev)
                   for b in host_batches]
    with torch.no_grad():
        for tb in dev_batches:  # warm-up
            tower(tb, "d", impl="auto")
        torch.cuda.synchronize()
        a, b = Event(enable_timing=True), Event(enable_timing=True)
        a.record()
        for tb in dev_batches:
            tower(tb, "d", impl="auto")
        b.record()
        b.synchronize()
        fwd_ms = a.elapsed_time(b) / len(dev_batches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for tb in dev_batches:
                tower(tb, "d", impl="auto")
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    dev_us, top = device_time_us(prof, 8)
    main_path = dict(
        card=card,
        titles=len(titles), queries=len(queries),
        index_build_s=[run["index_s"], run2["index_s"]],
        index_titles_per_s=len(titles) * 2 / (run["index_s"] + run2["index_s"]),
        query_latency_ms=[run["query_s"] * 1e3, run2["query_s"] * 1e3],
        plain_index_build_s=[plain["index_s"], plain2["index_s"]],
        plain_query_latency_ms=[plain["query_s"] * 1e3,
                                plain2["query_s"] * 1e3],
        peak_mem_gb=run["peak"] / 1e9,
        host_prep_s_for_index=host_s,
        host_prep_split_s=host_split,
        unused_side_hash_share_of_host_prep=unused_share,
        device_forward_ms_per_batch_eager=fwd_ms,
        traced_forward_wall_ms_per_batch=prof_wall * 1e3 / len(dev_batches),
        traced_device_busy_ms_per_batch=(
            None if dev_us is None else dev_us / 1e3 / len(dev_batches)),
        real_group_slots_per_batch=real_slots,
    )
    print("main path: " + json.dumps(main_path))
    print("device time by kernel in the traced forward (us, "
          f"{len(dev_batches)} batches): " + json.dumps(top))

    # ---- phase 6b: the cnn and lstm presets at full width ----------------
    # Each preset trains SEQ_STEPS steps from its seeded fresh init on the
    # union-dedupe branch (the kernels of the mlp joint branch but the
    # tower: the cnn and lstm towers are eager PyTorch, as XLA ran them) and
    # SEQ_STEPS on the raw-index branch (the embedding bag, the loss
    # kernels, an index_add_ table update), kernels against plain versions;
    # then both trained models are evaluated, saved, restored and served.
    # The max-pool makes the cnn's two runs part faster than the mlp's: where
    # a channel's maxima nearly tie over the words, a bf16 rounding makes
    # each run pool another word, and the step's gradient lands on that
    # word's table rows, and the later steps start from states that differ
    # there. On the card the cnn's loss curves read 0.023 apart on the
    # dedupe branch and 0.034-0.041 on the raw branch (whose index_add_
    # atomics move the reading from call to call), 0.6% of the loss; they
    # are held to 0.1, the parameters' updates as every branch's.
    seq_joint_kernels = ("fused_gather_joint_lookup", "joint_lookup_bwd",
                         "in_batch_loss", "in_batch_loss_dq",
                         "in_batch_loss_dd", "scatter_add_row_groups")
    seq_raw_kernels = {"embedding_bag": 2, "in_batch_loss": 1,
                       "in_batch_loss_dq": 1, "in_batch_loss_dd": 1}
    seq_runs = {}
    for arch, c in seq_cfg.items():
        for branch in ("joint", "raw"):
            run_cfg = (c if branch == "joint" else validate(
                c.replace(data=c.data.replace(dedup_lookup=False))))
            it_ = seq_stream(arch, branch == "joint")
            prep_ms, b_np = [], []
            for _ in range(SEQ_STEPS + SEQ_PROFILED_STEPS):
                t0 = time.perf_counter()
                b_np.append(next(it_))
                prep_ms.append((time.perf_counter() - t0) * 1e3)
            what = f"{arch} training ({branch} branch)"
            expect = ({k: 1 for k in seq_joint_kernels} if branch == "joint"
                      else seq_raw_kernels)
            run = compare_training(run_cfg, seq_params[arch],
                                   b_np[:SEQ_STEPS], what, expect,
                                   loss_tol=0.1)
            # The loss falls: the first batch's loss at the start against
            # its loss after the run (a step on a copy reports the loss
            # before its update).
            step_fn = make_train_step(run_cfg, "auto")
            _, aux_after = step_fn(create_run_state(
                run_cfg, clone_params(run["state"].params)),
                batch_to_torch(b_np[0], dev))
            probe = [run["loss"][0], float(aux_after["loss"])]
            check(probe[1] < probe[0], f"{what}: the first batch's loss did "
                  f"not fall ({probe[0]:.4f} before, {probe[1]:.4f} after "
                  f"{SEQ_STEPS} steps)")
            # Where the step's time goes: more steps, traced, on a copy.
            state_prof = create_run_state(run_cfg,
                                          clone_params(run["state"].params))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof_s:
                t0 = time.perf_counter()
                for bb in b_np[SEQ_STEPS:]:
                    state_prof, _ = step_fn(state_prof, batch_to_torch(bb, dev))
                torch.cuda.synchronize()
                prof_wall_s = time.perf_counter() - t0
            dev_us_s, top_s = device_time_us(prof_s, 8)
            summary = dict(
                card=card, arch=arch, branch=branch, steps=SEQ_STEPS,
                batch=run_cfg.train.batch_size,
                loss=[round(v, 5) for v in run["loss"]],
                first_batch_loss_before_after=probe,
                steps_per_s=SEQ_STEPS / run["wall_s"],
                plain_steps_per_s=SEQ_STEPS / run["plain_wall_s"],
                host_prep_ms_per_batch=statistics.median(prep_ms),
                **gaps(run),
                traced_wall_ms_per_step=(prof_wall_s * 1e3
                                         / SEQ_PROFILED_STEPS),
                traced_device_busy_ms_per_step=(
                    None if dev_us_s is None
                    else dev_us_s / 1e3 / SEQ_PROFILED_STEPS),
                device_busy_share_traced=(
                    None if dev_us_s is None else dev_us_s / 1e6 / prof_wall_s),
                peak_mem_gb=run["peak"] / 1e9,
                resident_before_run_gb=run["resident"] / 1e9,
                launches_per_step={k: v // SEQ_STEPS
                                   for k, v in run["counts"].items() if v})
            print(f"training path, {arch} preset, {branch} branch: "
                  + json.dumps(summary))
            print(f"device time by kernel in the traced {arch} {branch} steps "
                  f"(us, {SEQ_PROFILED_STEPS} steps): " + json.dumps(top_s))
            seq_runs[(arch, branch)] = dict(cfg=run_cfg, state=run["state"],
                                            counts=run["counts"])
            del run, state_prof, b_np
    results["embedding_bag"]["launches"] = seq_runs[("cnn", "raw")][
        "counts"]["embedding_bag"]

    # Evaluation of the trained models: the union-dedupe model on dedupe
    # batches, the raw-index model on raw batches; kernels against plain
    # versions, then the cached pass.
    eval_mod._EVAL_CACHES.clear()
    for (arch, branch), sr in seq_runs.items():
        cfg_e, params_e = sr["cfg"], sr["state"].params
        bs = cfg_e.train.batch_size
        eval_mod.evaluate(params_e, cfg_e, seq_eval, bs, "auto", cache=False)
        m_plain = eval_mod.evaluate(params_e, cfg_e, seq_eval, bs, "plain",
                                    cache=False)
        cold, hot = {}, {}
        _build.reset_launch_counts()
        m_cold = eval_mod.evaluate(params_e, cfg_e, seq_eval, bs, "auto",
                                   cache=True, stats=cold)
        counts_e = _build.launch_counts()
        m_hot = eval_mod.evaluate(params_e, cfg_e, seq_eval, bs, "auto",
                                  cache=True, stats=hot)
        n_batches = -(-len(seq_eval) // bs)
        want_e = ({"gather_row_groups": 2 * n_batches,
                   "count_lookup": 2 * n_batches, "rank_counts": 1}
                  if branch == "joint" else
                  {"embedding_bag": 2 * n_batches, "rank_counts": 1})
        for name, n in counts_e.items():
            check(n == want_e.get(name, 0), f"evaluate ({arch}, {branch}): "
                  f"kernel {name} launched {n} times, expected "
                  f"{want_e.get(name, 0)}")
        check(m_cold == m_hot and hot["cache_hit"] == 1.0,
              f"evaluate ({arch}, {branch}): the cached pass differs")
        check(m_cold["num_queries"] == len(seq_eval)
              and all(np.isfinite(v) for v in m_cold.values())
              and 0 < m_cold["recall@1"] <= m_cold["recall@10"] <= 1,
              f"evaluate ({arch}, {branch}): metrics {m_cold}")
        # bf16 towers: kernel and plain embeddings differ in their last
        # bits, so a rank may move where scores nearly tie: each metric by
        # at most three queries' share of the mean.
        metric_gap = max(abs(m_cold[k] - m_plain[k]) for k in m_plain)
        gap_tol = 3.0 / len(seq_eval)
        check(metric_gap <= gap_tol, f"evaluate ({arch}, {branch}): kernel "
              f"and plain metrics differ by {metric_gap} > {gap_tol}: "
              f"{m_cold} / {m_plain}")
        q_e, d_e = eval_mod.embed_corpus(params_e, cfg_e, seq_eval, bs,
                                         "auto", cache=True)
        r_k = rank_counts(q_e, d_e, impl="kernel")
        r_p = rank_counts_plain(q_e, d_e)
        ties = near_ties(q_e, d_e, 1e-6)
        check(bool(((r_k - r_p).abs() <= ties).all()), f"evaluate ({arch}, "
              f"{branch}): the rank kernel differs from its plain version "
              "beyond the docs within 1e-6 of the true score")
        print(f"evaluate, {arch} preset ({branch} branch): " + json.dumps(dict(
            card=card, eval_pairs=len(seq_eval), metrics=m_cold,
            metric_gap_kernel_vs_plain=metric_gap, first_pass_s=cold,
            cached_pass_s=hot)))
        del q_e, d_e
    eval_mod._EVAL_CACHES.clear()

    # Save, restore and serve each preset's union-dedupe model: a doc index
    # over the corpus's distinct titles and the top-10 of 64 queries,
    # kernels against plain versions.
    seq_titles = list(dict.fromkeys(seq_pairs.titles))
    seq_queries = seq_pairs.queries[:64]
    for arch in seq_cfg:
        sr = seq_runs[(arch, "joint")]
        cfg_s = sr["cfg"]
        ckdir = tempfile.TemporaryDirectory(prefix=f"dssm_smoke_{arch}_")
        t0 = time.perf_counter()
        Checkpointer(ckdir.name).save(sr["state"].step, sr["state"])
        restored = Checkpointer(ckdir.name).restore(device=dev)
        check(restored.step == SEQ_STEPS and all(
            torch.equal(restored.params["shared"][k], v)
            for k, v in sr["state"].params["shared"].items()),
            f"{arch}: the restored state differs from the trained one")
        ck_s = time.perf_counter() - t0
        ckdir.cleanup()
        served = {}
        for impl in ("auto", "plain", "plain", "auto"):
            torch.cuda.synchronize()
            if impl == "auto" and "auto" not in served:
                _build.reset_launch_counts()
            t0 = time.perf_counter()
            d_emb = build_doc_index(restored.params, cfg_s, seq_titles,
                                    cfg_s.train.batch_size, impl, None, dev)
            t1 = time.perf_counter()
            q_emb = embed_queries(restored.params, cfg_s, seq_queries,
                                  cfg_s.train.batch_size, impl, None, dev)
            s_, i_ = top_k(q_emb, d_emb, k=10, device=dev)
            t2 = time.perf_counter()
            if impl == "auto" and "auto" not in served:
                serve_counts = _build.launch_counts()
            served.setdefault(impl, []).append(dict(
                d=d_emb, q=q_emb, s=s_, i=i_, index_s=t1 - t0,
                query_ms=(t2 - t1) * 1e3))
        for name in ("gather_row_groups", "count_lookup"):
            check(serve_counts[name] > 0, f"{arch} serving: kernel {name} "
                  "was not launched")
        run_, plain_ = served["auto"][0], served["plain"][0]
        check(run_["d"].shape == (len(seq_titles), cfg_s.tower.semantic_dim)
              and bool(np.isfinite(run_["d"]).all()
                       and np.isfinite(run_["q"]).all())
              and float(np.abs(np.linalg.norm(run_["d"], axis=1) - 1).max())
              < 1e-4, f"{arch} serving: doc index {run_['d'].shape}")
        emb_err = max(float(np.abs(run_["d"] - plain_["d"]).max()),
                      float(np.abs(run_["q"] - plain_["q"]).max()))
        check(emb_err <= 2e-2, f"{arch} serving: kernel and plain embeddings "
              f"differ by {emb_err} > 2e-2")
        sc_auto = run_["q"] @ run_["d"].T
        for qi, r in np.argwhere(run_["i"] != plain_["i"]):
            gap = abs(sc_auto[qi, plain_["i"][qi, r]] - run_["s"][qi, r])
            check(gap <= 1e-3, f"{arch} serving: top-10 of query {qi} differs "
                  f"at rank {r + 1} beyond a tie (score gap {gap})")
        print(f"served, {arch} preset: " + json.dumps(dict(
            card=card, titles=len(seq_titles), queries=len(seq_queries),
            checkpoint_save_restore_s=ck_s,
            index_build_s=[x["index_s"] for x in served["auto"]],
            plain_index_build_s=[x["index_s"] for x in served["plain"]],
            query_latency_ms=[x["query_ms"] for x in served["auto"]],
            plain_query_latency_ms=[x["query_ms"] for x in served["plain"]],
            emb_max_abs_kernel_vs_plain=emb_err,
            top10_ids_differing_at_ties=int((run_["i"] != plain_["i"]).sum()),
            launches={k: v for k, v in serve_counts.items() if v})))
        del restored, served
    del seq_params

    # The weight gradient's path: autograd through the model's first-layer
    # lookup (models/base.embed_table_lookup) of a raw cnn batch whose
    # trigram weights need a gradient, e.g. to ask which trigrams move an
    # embedding. No training step asks for it: the weights are data.
    cfg_g = seq_runs[("cnn", "raw")]["cfg"]
    p_g = {"shared": {k: v.detach().clone().requires_grad_(True)
                      for k, v in seq_runs[("cnn", "raw")]["state"].params[
                          "shared"].items()}}
    b_g = dict(raw_seq)
    b_g["d_wgt"] = raw_seq["d_wgt"].clone().requires_grad_(True)
    grads_g = {}
    for impl in ("plain", "auto"):
        if impl == "auto":
            _build.reset_launch_counts()
        look = model_base.embed_table_lookup(p_g, cfg_g.tower, "d", b_g,
                                             impl=impl)
        y = model_base.embed_from_lookup(p_g, cfg_g.tower, "d", b_g, look,
                                         impl=impl)
        grads_g[impl] = torch.autograd.grad(y[:, 0].sum(),
                                            [b_g["d_wgt"], p_g["shared"]["Wc"]])
    grad_counts = _build.launch_counts()
    check(grad_counts["embedding_bag"] == 1
          and grad_counts["embedding_bag_bwd"] == 1, "the weight gradient's "
          f"path launched {grad_counts} (expected the bag and its backward "
          "once each)")
    for gname, a_, b_ in zip(("d_wgt", "d_Wc"), grads_g["auto"],
                             grads_g["plain"]):
        e_, s_ = float((a_ - b_).abs().max()), float(b_.abs().max())
        # bf16 tower: the lookup's last bits round the activations apart
        check(e_ <= 2e-2 * s_, f"weight gradient path: {gname} max err {e_} "
              f"over 2e-2 x {s_}")
    results["embedding_bag_bwd"]["launches"] = grad_counts["embedding_bag_bwd"]
    print(f"weight gradient of a cnn doc embedding through the bag: kernel vs "
          f"plain d_wgt / d_Wc max err "
          f"{[float((a_ - b_).abs().max()) for a_, b_ in zip(grads_g['auto'], grads_g['plain'])]}"
          f", launches {dict((k, v) for k, v in grad_counts.items() if v)}")
    del p_g, b_g, grads_g

    # ---- phase 7: the same path through the command-line entry points ----
    # cli.train in this process: the full preset on a toy corpus cut to
    # CLI_PAIRS pairs, first on the f32 table (CLI_STEPS steps and the final
    # eval; cli.export then builds an index from the checkpoint it wrote and
    # answers one query), then on a bf16 table with an eval every 3 steps,
    # followed by cli.eval and cli.export on that workdir.
    from dssm_tpu_torch.cli import eval as cli_eval
    from dssm_tpu_torch.cli import export as cli_export
    from dssm_tpu_torch.cli import train as cli_train

    cli_eval_pairs = len(train_eval_split(
        make_toy_pairs(CLI_PAIRS, cfg.data.toy_vocab_words, cfg.data.seed),
        eval_frac=cfg.data.eval_frac, seed=cfg.data.seed)[1].queries)
    cli_eval_batches = -(-cli_eval_pairs // cfg.train.batch_size)

    def cli_expected(steps, evals, scatter):
        want = {k: steps for k in joint_kernels[:-1] + (scatter,)}
        want["joint_lookup"] = 0
        want["gather_row_groups"] = 2 * cli_eval_batches * evals
        want["count_lookup"] = want["dense_tower"] = (
            2 * cli_eval_batches * evals)
        want["rank_counts"] = evals
        return want

    def cli_records(workdir_):
        with open(os.path.join(workdir_, cfg.io.metrics_file)) as f:
            return [json.loads(line) for line in f]

    cli_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_cli_")
    cli_flags = ["--preset=full", f"--io.workdir={cli_dir.name}",
                 f"--data.toy_num_pairs={CLI_PAIRS}"]
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    cli_train.main(cli_flags + [f"--train.max_steps={CLI_STEPS}",
                                "--train.log_every=2"])
    torch.cuda.synchronize()
    cli_counts = _build.launch_counts()
    t1 = time.perf_counter()
    for name, n in cli_expected(CLI_STEPS, 1,
                                "scatter_add_row_groups").items():
        check(cli_counts[name] == n, f"cli.train: kernel {name} launched "
              f"{cli_counts[name]} times, expected {n}")
    records = cli_records(cli_dir.name)
    cli_losses = [r["loss"] for r in records if r["tag"] == "train"]
    check(len(cli_losses) == CLI_STEPS // 2 and all(np.isfinite(cli_losses)),
          f"cli.train: metrics records {records}")
    check(records[-1]["tag"] == "eval_final"
          and records[-1]["num_queries"] == cli_eval_pairs
          and 0 < records[-1]["recall@1"] <= 1,
          f"cli.train: final eval record {records[-1]}")
    check(Checkpointer(cli_dir.name).latest_step() == CLI_STEPS,
          "cli.train wrote no checkpoint of its last step")
    cli_index = os.path.join(cli_dir.name, "index.npz")
    cli_query = make_toy_pairs(CLI_PAIRS, cfg.data.toy_vocab_words,
                               cfg.data.seed).queries[0]

    def export_and_query(flags):
        out_ = io.StringIO()
        with contextlib.redirect_stdout(out_):
            cli_export.main(flags + [f"--out={cli_index}"])
            cli_export.main(flags + [f"--index={cli_index}",
                                     f"--query={cli_query}", "--k=5"])
        built_, answer_ = (json.loads(line)
                           for line in out_.getvalue().splitlines())
        check(built_["indexed_docs"] > 0 and built_["dim"] == t.semantic_dim,
              f"cli.export index: {built_}")
        scores_ = [r["score"] for r in answer_["results"]]
        check(len(scores_) == 5 and all(np.isfinite(scores_))
              and scores_ == sorted(scores_, reverse=True),
              f"cli.export answer: {answer_}")
        return built_, scores_

    built, cli_scores = export_and_query(cli_flags)
    print(f"cli.train: {CLI_STEPS} steps of the full preset on {CLI_PAIRS} toy "
          f"pairs in {t1 - t0:.1f} s (hashing included), loss "
          f"{cli_losses[0]:.4f} -> {cli_losses[-1]:.4f}, final eval recall@1 "
          f"{records[-1]['recall@1']:.4f} on {cli_eval_pairs} pairs, 1 launch "
          f"of each of {len(joint_kernels)} kernels a step; cli.export "
          f"restored step {CLI_STEPS}, indexed {built['indexed_docs']} titles "
          f"and answered one query (top score {cli_scores[0]:.4f}) in "
          f"{time.perf_counter() - t1:.1f} s")
    cli_dir.cleanup()

    cli_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_cli16_")
    cli_flags = ["--preset=full", f"--io.workdir={cli_dir.name}",
                 f"--data.toy_num_pairs={CLI_PAIRS}",
                 "--tower.table_dtype=bfloat16"]
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    cli_train.main(cli_flags + [f"--train.max_steps={CLI_LOWPREC_STEPS}",
                                "--train.log_every=2",
                                "--train.eval_every=3"])
    torch.cuda.synchronize()
    cli_counts = _build.launch_counts()
    t1 = time.perf_counter()
    for name, n in cli_expected(CLI_LOWPREC_STEPS, 2,
                                "scatter_sr_row_groups").items():
        check(cli_counts[name] == n, f"cli.train (bf16 table): kernel {name} "
              f"launched {cli_counts[name]} times, expected {n}")
    check(cli_counts["scatter_add_row_groups"] == 0,
          "cli.train (bf16 table) launched the f32 scatter")
    records = cli_records(cli_dir.name)
    check([(r["tag"], r["step"]) for r in records if r["tag"] != "train"]
          == [("eval", 3), ("eval_final", CLI_LOWPREC_STEPS)],
          f"cli.train (bf16 table): eval records {records}")
    final = records[-1]
    state16 = Checkpointer(cli_dir.name).restore(device=dev)
    check(state16.step == CLI_LOWPREC_STEPS
          and state16.params["shared"]["W0"].dtype == torch.bfloat16,
          "cli.train (bf16 table): the checkpoint's table is not bf16")
    del state16
    out_eval = io.StringIO()
    with contextlib.redirect_stdout(out_eval):
        cli_eval.main(cli_flags)
    lines = out_eval.getvalue().strip().splitlines()
    check(len(lines) == 1, f"cli.eval printed {len(lines)} lines")
    reported = json.loads(lines[0])
    check(reported["step"] == CLI_LOWPREC_STEPS and all(
        reported[k] == final[k] for k in ("recall@1", "recall@10", "ndcg@10",
                                          "mrr", "num_queries")),
        f"cli.eval reports {reported}, the run's final eval was {final}")
    built, cli_scores = export_and_query(cli_flags)
    print(f"cli.train on a bf16 table: {CLI_LOWPREC_STEPS} steps with an eval "
          f"at step 3 and at the end in {t1 - t0:.1f} s, final eval "
          f"{json.dumps({k: final[k] for k in ('recall@1', 'ndcg@10', 'mrr')})}"
          f"; cli.eval restored step {reported['step']} and reported the same "
          f"metrics; cli.export indexed {built['indexed_docs']} titles and "
          f"answered one query (top score {cli_scores[0]:.4f}) in "
          f"{time.perf_counter() - t1:.1f} s")
    cli_dir.cleanup()

    # The cnn and lstm presets through the same command lines: cli.train
    # (SEQ_CLI_STEPS steps, an eval every 3 and at the end), cli.eval and
    # cli.export on its workdir; then cli.train on raw-index batches.
    for preset, dedup in (("cnn", True), ("lstm", True), ("cnn", False)):
        c = seq_cfg[preset]
        n_eval_b = -(-len(seq_eval) // c.train.batch_size)
        cli_dir = tempfile.TemporaryDirectory(prefix=f"dssm_smoke_{preset}_")
        cli_flags = [f"--preset={preset}", f"--io.workdir={cli_dir.name}",
                     f"--data.dedup_lookup={dedup}"]
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        cli_train.main(cli_flags + [f"--train.max_steps={SEQ_CLI_STEPS}",
                                    "--train.log_every=2",
                                    "--train.eval_every=3"])
        torch.cuda.synchronize()
        cli_counts = _build.launch_counts()
        t1 = time.perf_counter()
        if dedup:
            want = {k: SEQ_CLI_STEPS for k in seq_joint_kernels}
            want["gather_row_groups"] = 2 * n_eval_b * 2
            want["count_lookup"] = 2 * n_eval_b * 2
        else:
            want = {k: v * SEQ_CLI_STEPS for k, v in seq_raw_kernels.items()}
            want["embedding_bag"] += 2 * n_eval_b * 2
        want["rank_counts"] = 2
        for name, n in cli_counts.items():
            check(n == want.get(name, 0), f"cli.train --preset={preset} "
                  f"(dedup {dedup}): kernel {name} launched {n} times, "
                  f"expected {want.get(name, 0)}")
        records = cli_records(cli_dir.name)
        losses = [r["loss"] for r in records if r["tag"] == "train"]
        check([(r["tag"], r["step"]) for r in records if r["tag"] != "train"]
              == [("eval", 3), ("eval_final", SEQ_CLI_STEPS)]
              and len(losses) == SEQ_CLI_STEPS // 2
              and all(np.isfinite(losses)),
              f"cli.train --preset={preset}: records {records}")
        final = records[-1]
        line = (f"cli.train --preset={preset} --data.dedup_lookup={dedup}: "
                f"{SEQ_CLI_STEPS} steps in {t1 - t0:.1f} s (hashing "
                f"included), loss {losses[0]:.4f} -> {losses[-1]:.4f}, final "
                f"eval recall@1 {final['recall@1']:.4f} on "
                f"{int(final['num_queries'])} pairs")
        if dedup:
            cli_index = os.path.join(cli_dir.name, "index.npz")
            out_eval = io.StringIO()
            with contextlib.redirect_stdout(out_eval):
                cli_eval.main(cli_flags)
            reported = json.loads(out_eval.getvalue().strip().splitlines()[-1])
            check(reported["step"] == SEQ_CLI_STEPS and all(
                reported[k] == final[k] for k in ("recall@1", "ndcg@10",
                                                  "mrr", "num_queries")),
                f"cli.eval --preset={preset} reports {reported}, the run's "
                f"final eval was {final}")
            built, cli_scores = export_and_query(cli_flags)
            line += (f"; cli.eval reported the same metrics; cli.export "
                     f"indexed {built['indexed_docs']} titles and answered "
                     f"one query (top score {cli_scores[0]:.4f}) in "
                     f"{time.perf_counter() - t1:.1f} s")
        print(line)
        cli_dir.cleanup()

    # ---- phase 8: the kernels line, then the result line ----------------
    # Every kernel of the build holds its comparison and a launch count from
    # a main path's run.
    for name in _build.KERNELS:
        check(name in results and results[name].get("launches", 0) > 0,
              f"kernel {name} has no launch count from a main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, r in results.items():
        r.update(name=name, route="cuda")
        row = {k: r[k] for k in keys}
        row["kernel_ms"] = r["ms"]
        row["eager_ms"] = r["eager_ms"]
        row.update({k: v for k, v in r.items() if k.startswith("ms_")})
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
