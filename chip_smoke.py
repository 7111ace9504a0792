#!/usr/bin/env python3
"""Smoke run of dssm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from dssm_tpu_torch/csrc, holds each kernel
to its plain PyTorch version at the `full` preset's shapes and times both,
then drives the `full` preset end to end (500k x 384 f32 table, towers
300->300->128 in bf16, batch 1024, union dedupe):

  - trains it from seeded fresh weights on the toy corpus's batch stream,
    24 steps through the kernels and the same steps from the same state
    through the plain versions, which must agree, with the loss falling;
    then 3 steps of the per-side branch (separate towers) the same way;
  - saves the trained state with the port's Checkpointer, restores it,
  - serves from the restored weights: a doc index over 4096 toy titles and
    top-10 for 64 queries, through the kernels and through the plain
    versions, which must agree, and
  - runs cli.train for a few steps and cli.export on its workdir.

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
TRAIN_STEPS = 24       # joint branch, kernels against plain
PER_SIDE_STEPS = 3     # per-side branch (separate towers)
TRAIN_PAIRS = 32768    # of the preset's 65536 toy pairs: bounds hashing time
INDEX_BATCHES = 4      # served index: 4 batches of 1024 titles
CLI_PAIRS = 8192       # toy corpus of the command-line drive
CLI_STEPS = 6          # its training steps


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
    from dssm_tpu_torch.kernels.count import (
        count_lookup, count_lookup_bwd, count_lookup_bwd_plain, count_matrix)
    from dssm_tpu_torch.kernels.gather import (
        gather_row_groups, scatter_add_row_groups,
        scatter_add_row_groups_plain)
    from dssm_tpu_torch.kernels.joint import (
        joint_lookup, joint_lookup_bwd, joint_lookup_bwd_plain,
        joint_lookup_plain)
    from dssm_tpu_torch.kernels.loss import (
        in_batch_loss_dd, in_batch_loss_dq, in_batch_loss_grads_plain,
        in_batch_nll_kernel, in_batch_nll_plain)
    from dssm_tpu_torch.kernels.tower import (
        dense_tower, dense_tower_residuals)
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.serve import build_doc_index, embed_queries, top_k
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

    def torch_chain():
        hh = x
        for w, b in layers:
            hh = torch.tanh(torch.addmm(b, hh, w))
        return hh

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
        errors={"bf16 tanh": tower_err, "f32 relu normalized": f32_err},
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
    train_pairs, _ = train_eval_split(
        ToyPairs(queries=pairs.queries[:TRAIN_PAIRS],
                 titles=pairs.titles[:TRAIN_PAIRS]),
        eval_frac=cfg.data.eval_frac, seed=cfg.data.seed)
    hashed_train = hash_pairs(train_pairs, t, cfg.data)
    tmp_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_")
    workdir = tmp_dir.name  # removed below, or at exit if a check fails
    train_remap = build_freq_remap(hashed_train, t.vocab_size)
    hashed_train = apply_remap(hashed_train, train_remap)
    save_remap(workdir, train_remap)
    print(f"training corpus: {len(hashed_train)} pairs hashed + remapped in "
          f"{time.perf_counter() - t0:.1f} s (cut from "
          f"{cfg.data.toy_num_pairs} pairs; widths, vocab, batch and caps "
          "are the preset's)")

    def stream(joint):
        return batch_iterator(
            hashed_train, cfg.train.batch_size, seed=cfg.train.seed,
            dedup_unique=cfg.data.max_unique, dedup_group=group,
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

    # Joint lookup backward (f32 atomics): bf16 gradients, as the step's.
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
    joint_bwd_bit_equal = bool(torch.equal(dc_k, dc_k2))
    print(f"joint_lookup_bwd run twice on the same inputs: bit-equal = "
          f"{joint_bwd_bit_equal} (f32 atomics; max |a - b| "
          f"{float((dc_k - dc_k2).abs().max()):.3g})")
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
        bound_ms=b_ms, bound_by=b_by, bit_equal_twice=joint_bwd_bit_equal,
        shape=f"g ({rows_n}, {h}) bf16 x 2 -> dc ({gr}, {h}) f32 (the "
              "zero fill of dc is in every time)",
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
    torch.cuda.synchronize()
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
        replaces="dssm_tpu/kernels/pallas_loss.py:116",
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
    lib_loss = F.cross_entropy(gamma * (q_lib @ d_lib.T), labels64,
                               reduction="mean")
    for name, fn, want, leaf, line in (
            ("in_batch_loss_dq", in_batch_loss_dq, dq_p, q_lib, 209),
            ("in_batch_loss_dd", in_batch_loss_dd, dd_p, d_lib, 233)):
        got = fn(qn, dn, labels, gamma, lse_p, g_row, impl="kernel")
        torch.cuda.synchronize()
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
            # autograd of F.cross_entropy(gamma q d^T) in this one input,
            # launched eagerly (its graph is kept across the calls).
            library_ms=eager_ms(lambda: torch.autograd.grad(
                lib_loss, [leaf], retain_graph=True)),
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
    new_names = ("joint_lookup", "joint_lookup_bwd", "count_lookup_bwd",
                 "dense_tower_residuals", "in_batch_loss", "in_batch_loss_dq",
                 "in_batch_loss_dd", "scatter_add_row_groups")
    for name in new_names:
        r = results[name]
        r["eager_ms"] = None
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), max err "
              f"{r['max_abs_err']:.3g} (tolerance {r['tolerance']}) "
              f"[{r['shape']}] on {card}")

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

    def compare_training(run_cfg, init, batches_np, what, expect):
        """The same steps from the same state through the kernels and
        through the plain versions; checks and returns the kernel run."""
        steps = len(batches_np)
        # Warm-up outside the counted run (cuBLAS handles, allocator): one
        # step of each on throw-away copies.
        for impl in ("auto", "plain"):
            run_steps(run_cfg, create_run_state(run_cfg, clone_params(init)),
                      batches_np[:1], impl)
        s_p, loss_p, wall_p = run_steps(
            run_cfg, create_run_state(run_cfg, clone_params(init)),
            batches_np, "plain")
        torch.cuda.reset_peak_memory_stats()
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
        check(gap <= 2e-2, f"{what}: kernel and plain loss curves differ by "
              f"{gap} > 2e-2")
        dense_gap = table_gap = 0.0
        for tw, tp_ in s_p.params.items():
            sides = {"shared": "qd", "query": "q", "doc": "d"}[tw]
            keys = (["uniq"] if "uniq" in batches_np[0]
                    else [f"{s_}_uniq" for s_ in sides])
            gids_ = np.unique(np.concatenate(
                [b_np[k] for b_np in batches_np for k in keys]))
            gids_ = torch.from_numpy(
                gids_[gids_ < num_groups].astype(np.int64)).to(dev)
            touched = torch.zeros((init[tw]["W0"].shape[0],), dtype=torch.bool,
                                  device=dev)
            touched[(gids_[:, None] * group
                     + torch.arange(group, device=dev)).reshape(-1)] = True
            for k, want in tp_.items():
                got = s_k.params[tw][k]
                if k == "W0":
                    check(torch.equal(got[~touched], init[tw][k][~touched]),
                          f"{what}: table rows of no gathered group changed")
                    check(not torch.equal(got[touched], init[tw][k][touched]),
                          f"{what}: the table did not move")
                    table_gap = max(table_gap, float(
                        (got[touched] - want[touched]).abs().max()))
                else:
                    dense_gap = max(dense_gap,
                                    float((got - want).abs().max()))
        check(dense_gap <= 1e-2 and table_gap <= 1e-2, f"{what}: kernel and "
              f"plain parameters differ by {dense_gap} (dense) / "
              f"{table_gap} (table rows touched) > 1e-2")
        return dict(state=s_k, loss=loss_k, loss_plain=loss_p, wall_s=wall_k,
                    plain_wall_s=wall_p, counts=counts,
                    peak=peak, loss_gap=gap, dense_gap=dense_gap,
                    table_gap=table_gap)

    joint_kernels = ("gather_row_groups", "joint_lookup",
                     "dense_tower_residuals", "in_batch_loss",
                     "in_batch_loss_dq", "in_batch_loss_dd",
                     "joint_lookup_bwd", "scatter_add_row_groups")
    tr = compare_training(cfg, params, host_batches_t[:TRAIN_STEPS],
                          "training (joint branch)",
                          {k: 1 for k in joint_kernels})
    first, last = (statistics.mean(tr["loss"][:4]),
                   statistics.mean(tr["loss"][-4:]))
    check(last < 0.9 * first, f"training: the loss did not fall (first 4 "
          f"steps {first:.4f}, last 4 {last:.4f})")
    for name in joint_kernels[1:]:
        results[name]["launches"] = tr["counts"][name]
    print(f"trained {TRAIN_STEPS} steps of the full preset: loss "
          f"{tr['loss'][0]:.4f} -> {tr['loss'][-1]:.4f} (first 4 mean "
          f"{first:.4f}, last 4 {last:.4f}); kernel vs plain: loss curve "
          f"max gap {tr['loss_gap']:.3g} (tolerance 2e-2), dense params "
          f"{tr['dense_gap']:.3g}, table rows touched {tr['table_gap']:.3g} "
          "(tolerance 1e-2), untouched rows bit-unchanged; launches per "
          f"step 1 of each of {len(joint_kernels)} kernels")

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
          f"kernel vs plain: loss gap {ps['loss_gap']:.3g}, dense "
          f"{ps['dense_gap']:.3g}, table {ps['table_gap']:.3g}; "
          f"count_lookup_bwd launched {ps['counts']['count_lookup_bwd']} "
          "times")
    del params_ps, ps

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
    for name, n in launches.items():
        check(name in results and "launches" in results[name],
              f"kernel {name} has no launch count from a main path")
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

    # ---- phase 7: the same path through the command-line entry points ----
    # cli.train in this process: the full preset on a toy corpus cut to
    # CLI_PAIRS pairs, CLI_STEPS steps, then cli.export builds an index from
    # the checkpoint it wrote and answers one query.
    from dssm_tpu_torch.cli import export as cli_export
    from dssm_tpu_torch.cli import train as cli_train

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
    for name in joint_kernels:
        check(cli_counts[name] == CLI_STEPS, f"cli.train: kernel {name} "
              f"launched {cli_counts[name]} times in {CLI_STEPS} steps")
    with open(os.path.join(cli_dir.name, cfg.io.metrics_file)) as f:
        cli_records = [json.loads(line) for line in f]
    cli_losses = [r["loss"] for r in cli_records if r["tag"] == "train"]
    check(len(cli_losses) == CLI_STEPS // 2 and all(np.isfinite(cli_losses)),
          f"cli.train: metrics records {cli_records}")
    check(Checkpointer(cli_dir.name).latest_step() == CLI_STEPS,
          "cli.train wrote no checkpoint of its last step")
    cli_index = os.path.join(cli_dir.name, "index.npz")
    cli_query = make_toy_pairs(CLI_PAIRS, cfg.data.toy_vocab_words,
                               cfg.data.seed).queries[0]
    cli_out = io.StringIO()
    with contextlib.redirect_stdout(cli_out):
        cli_export.main(cli_flags + [f"--out={cli_index}"])
        cli_export.main(cli_flags + [f"--index={cli_index}",
                                     f"--query={cli_query}", "--k=5"])
    built, answer = (json.loads(line)
                     for line in cli_out.getvalue().splitlines())
    check(built["indexed_docs"] > 0 and built["dim"] == t.semantic_dim,
          f"cli.export index: {built}")
    cli_scores = [r["score"] for r in answer["results"]]
    check(len(cli_scores) == 5 and all(np.isfinite(cli_scores))
          and cli_scores == sorted(cli_scores, reverse=True),
          f"cli.export answer: {answer}")
    print(f"cli.train: {CLI_STEPS} steps of the full preset on {CLI_PAIRS} toy "
          f"pairs in {t1 - t0:.1f} s (hashing included), loss "
          f"{cli_losses[0]:.4f} -> {cli_losses[-1]:.4f}, 1 launch of each of "
          f"{len(joint_kernels)} kernels a step; cli.export restored step "
          f"{CLI_STEPS}, indexed {built['indexed_docs']} titles and answered "
          f"one query (top score {cli_scores[0]:.4f}) in "
          f"{time.perf_counter() - t1:.1f} s")
    cli_dir.cleanup()

    # ---- phase 8: the kernels line, then the result line ----------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, r in results.items():
        r.update(name=name, route="cuda")
        row = {k: r[k] for k in keys}
        row["kernel_ms"] = r["ms"]
        row["eager_ms"] = r["eager_ms"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
