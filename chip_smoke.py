#!/usr/bin/env python3
"""Smoke run of dssm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from dssm_tpu_torch/csrc, holds each kernel
to its plain PyTorch version at the `full` preset's shapes and times both,
then serves the `full` preset end to end (500k x 384 f32 table, towers
300->300->128 in bf16, batch 1024): a doc index over 8192 toy titles and
top-10 for 64 queries, once through the kernels and once through the plain
versions, which must agree. It checks that every kernel was launched by the
served path. The next-to-last line is a JSON object with each kernel's
numbers; the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero before that line; with no GPU it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 CUDA cores
SEED = 0


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
    from dssm_tpu_torch.data import ToyPairs, eval_batches, hash_pairs
    from dssm_tpu_torch.data import make_toy_pairs
    from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
    from dssm_tpu_torch.data.remap import apply_remap, build_freq_remap
    from dssm_tpu_torch.data.trigram import hash_batch
    from dssm_tpu_torch.device import resolve_device
    from dssm_tpu_torch.kernels import _build
    from dssm_tpu_torch.kernels.count import count_lookup, count_matrix
    from dssm_tpu_torch.kernels.gather import gather_row_groups
    from dssm_tpu_torch.kernels.tower import dense_tower
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.serve import build_doc_index, embed_queries, top_k

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

    # ---- phase 2: each kernel against its plain version ------------------
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

    # ---- phase 3: the main path, the full preset served ------------------
    t0 = time.perf_counter()
    pairs = make_toy_pairs(cfg.data.toy_num_pairs, cfg.data.toy_vocab_words,
                           cfg.data.seed)
    titles = list(dict.fromkeys(pairs.titles))[: 8 * cfg.train.batch_size]
    queries = pairs.queries[:64]
    served = hash_pairs(ToyPairs(queries=queries, titles=titles), t, cfg.data)
    remap = build_freq_remap(served, t.vocab_size)
    print(f"toy corpus + hashing + freq remap: "
          f"{time.perf_counter() - t0:.1f} s ({len(titles)} titles, "
          f"{len(queries)} queries)")

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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the served path")
        results[name]["launches"] = n
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
    from dssm_tpu_torch.bridge import batch_to_torch
    from dssm_tpu_torch.data.loader import pad_batch

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
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for tb in dev_batches:
                tower(tb, "d", impl="auto")
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    dev_us, by_kernel = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = float(getattr(e, "self_device_time_total", 0.0))
            dev_us += us
            by_kernel[e.key[:60]] = us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
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
        traced_device_busy_ms_per_batch=dev_us / 1e3 / len(dev_batches),
        real_group_slots_per_batch=real_slots,
    )
    print("main path: " + json.dumps(main_path))
    print("device time by kernel in the traced forward (us, 8 batches): "
          + json.dumps(top))

    # ---- phases 4 and 5: the kernels line, then the result line ----------
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
