"""Stage times of the joint sparse train step, on one NVIDIA GPU.

    python -m dssm_tpu_torch.tools.profile_components [f32|bf16] \
        [--preset=full] [--cpu] [--iters=50] [--warmup=5] [--traced=10] \
        [--section.field=value ...]

The step is the port's union-dedupe step on a shared table
(train/sparse_update.py): one fused gather + joint lookup, the towers and
the loss, the backward, one scatter. Its stages, each on the first batch
of the preset's toy corpus (frequency-remapped when the preset remaps),
on an f32 and on a bf16 table (one of them with the argument):

  - null: one tiny launch, the floor every eager iteration carries;
  - gather: gather_row_groups of the batch's row groups (csrc/gather.cu);
  - fused gather + joint lookup (csrc/joint.cu), what the step runs;
  - joint lookup alone, from the gathered compact block;
  - count lookup q + d (csrc/count.cu) on compact2 = compact[sel] in the
    compute dtype;
  - gather + lookup forward: the gather and the joint lookup as two
    launches (the route the fused kernel replaces; an int8 table's step);
  - + towers + loss forward, from the fused lookup;
  - + backward: the dense gradients and the joint lookup backward;
  - scatter: the compact gradient into the table (scatter-add on f32,
    stochastic rounding on bf16), on a copy of the table;
  - whole step: make_train_step's step (on the card one replay of its
    CUDA graph, train/compiled.py), the state updated in place.

Two library routes follow, labelled as not the port's path: the joint and
the count lookups as count matrices built in the call and multiplied
(torch.matmul), the formulation dssm_tpu's XLA stages time and PERF.md's
kernel table uses as their library calls.

Every stage runs --warmup times; then each runs --traced times under a
torch.profiler window of its own (µs of device kernels an iteration: its
busy time), the windows back to back, a process's first; then each runs
--iters times between two CUDA events (µs an iteration, the device's
timeline between the events: the stage's wall time on the card). Run one
table a process (f32 or bf16) where the traced numbers matter: the
profiler loses a window's device events in a number that grows with the
time since the process's first window (PERF.md). With --cpu the stages
run on the CPU through the kernels' plain versions, timed by the host
clock; no device time is printed then. The card's name and power limit
head the output.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np


def card_line(device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if device.type != "cuda":
        return "cpu (plain versions; host clock)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return smi


def _busy_us(prof) -> float:
    import torch

    return sum(float(getattr(e, "self_device_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def traced_busy_us(fn: Callable, traced: int) -> Optional[float]:
    """Device-busy µs an iteration of fn over one torch.profiler window of
    `traced` iterations, or None when the window recorded no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    busy = _busy_us(prof)
    return busy / traced if busy > 0 else None


def clock_us(fn: Callable, device, iters: int) -> float:
    """µs an iteration of fn: the interval between two CUDA events on the
    card, the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def profile_table(cfg, tag: str, device, iters: int, warmup: int,
                  traced: int) -> List[tuple]:
    """Every stage of the joint step on cfg's table: [(stage, µs,
    busy µs or None)], each printed once both are measured."""
    import torch

    from dssm_tpu_torch.bridge import batch_to_torch
    from dssm_tpu_torch.data import hash_pairs, make_toy_pairs, select_batch
    from dssm_tpu_torch.data.remap import apply_remap, build_freq_remap
    from dssm_tpu_torch.kernels.count import count_lookup, count_matrix
    from dssm_tpu_torch.kernels.gather import (
        gather_row_groups, scatter_add_row_groups, sublane_group)
    from dssm_tpu_torch.kernels.joint import (
        fused_gather_joint_lookup, joint_lookup, joint_lookup_bwd)
    from dssm_tpu_torch.kernels.scatter_sr import scatter_sr_row_groups
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.train.loop import make_train_step
    from dssm_tpu_torch.train.sparse_update import (
        _dense_subtree, default_loss, grads_of, joint_fields, joint_row_sel,
        towers_from_lookups)
    from dssm_tpu_torch.train.state import create_run_state

    params = model_base.init_params(cfg.tower, seed=0, device=device)
    table_key = model_base.TABLE_KEY[cfg.tower.arch]
    table = params["shared"][table_key]
    group = sublane_group(table.dtype)
    compute_dtype = model_base.torch_dtype(cfg.tower.compute_dtype)
    bs = cfg.train.batch_size
    hashed = hash_pairs(make_toy_pairs(bs, vocab_words=512, seed=0),
                        cfg.tower, cfg.data)
    if cfg.data.freq_remap:
        hashed = apply_remap(hashed, build_freq_remap(
            hashed, cfg.tower.vocab_size))
    np_batch = select_batch(hashed, np.arange(bs), cfg.data.max_unique,
                            group, cfg.data.max_unique_rows, True)
    batch = batch_to_torch(np_batch, device,
                           vocab_size=cfg.tower.vocab_size)
    uniq = batch["uniq"]
    fields = joint_fields(batch, joint_row_sel(batch))
    sel = fields[0]
    u2 = sel.numel()
    n_real = int((np_batch["uniq"] < cfg.tower.vocab_size // group).sum())
    print(f"[{tag}] union real groups: {n_real} of {uniq.numel()} slots "
          f"(group={group}, u2={u2})", flush=True)

    dense = _dense_subtree(params, table_key)
    loss_of = default_loss(cfg)
    with torch.no_grad():
        c0 = gather_row_groups(table, uniq, group)
        compact2 = c0.index_select(0, sel.long()).to(compute_dtype)
    # The count lookup's weights in the compute dtype, as
    # dedup_embed.lookup_from_compact rounds them.
    wq = fields[2].to(compute_dtype).float()
    wd = fields[4].to(compute_dtype).float()
    work = table.clone()  # the scatter's table
    h = table.shape[1]
    vals = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(c0.shape[0], h)) * 1e-4)
        .astype(np.float32)).to(device)
    vals[n_real * group:] = 0.0
    seed = torch.ones(1, dtype=torch.int32, device=device)
    step_fn = make_train_step(cfg)
    state = [create_run_state(cfg, params)]

    def loss_from_joint_lookups(dns, lq, ld, b):
        return loss_of(*towers_from_lookups(
            cfg, dns, lq.to(compute_dtype), ld.to(compute_dtype), b), b)

    @torch.no_grad()
    def s_null():
        return batch["q_wgt"][0].sum()

    @torch.no_grad()
    def s_gather():
        return gather_row_groups(table, uniq, group)

    def s_fused():
        return fused_gather_joint_lookup(table, uniq, *fields, group)

    @torch.no_grad()
    def s_joint():
        return joint_lookup(c0, *fields)

    @torch.no_grad()
    def s_count():
        return (count_lookup(compact2, fields[1], wq),
                count_lookup(compact2, fields[3], wd))

    @torch.no_grad()
    def s_split():
        return joint_lookup(gather_row_groups(table, uniq, group), *fields)

    def s_fwd():
        lq, ld, _ = fused_gather_joint_lookup(table, uniq, *fields, group)
        with torch.no_grad():
            return loss_from_joint_lookups(dense, lq, ld, batch)[0]

    def s_fwd_bwd():
        lq, ld, c = fused_gather_joint_lookup(table, uniq, *fields, group)
        _, _, (g_lq, g_ld) = grads_of(loss_from_joint_lookups, dense,
                                      [lq, ld], batch)
        return joint_lookup_bwd(*fields, g_lq.contiguous(),
                                g_ld.contiguous(), c.shape[0])

    @torch.no_grad()
    def s_scatter():
        if work.dtype == torch.bfloat16:
            return scatter_sr_row_groups(work, uniq, vals, group, seed)
        return scatter_add_row_groups(work, uniq, vals, group)

    def s_step():
        state[0], aux = step_fn(state[0], batch)
        return aux["loss"]

    @torch.no_grad()
    def lib_joint():
        c2 = c0.index_select(0, sel.long()).float()
        return (count_matrix(fields[1], fields[2], u2) @ c2,
                count_matrix(fields[3], fields[4], u2) @ c2)

    @torch.no_grad()
    def lib_count():
        c2 = compact2.float()
        return (count_matrix(fields[1], wq, u2) @ c2,
                count_matrix(fields[3], wd, u2) @ c2)

    stages = [
        ("null (an eager iteration's floor)", s_null),
        ("gather (union)", s_gather),
        ("fused gather + joint lookup", s_fused),
        ("joint lookup alone", s_joint),
        ("count lookup q + d", s_count),
        ("gather + lookup fwd (2 launches)", s_split),
        ("+ towers + loss fwd", s_fwd),
        ("+ backward", s_fwd_bwd),
        ("scatter (union, " + ("SR" if table.dtype == torch.bfloat16
                               else "add") + ")", s_scatter),
        ("WHOLE STEP", s_step),
        ("library, not the port's path: joint lookup as count matrices",
         lib_joint),
        ("library, not the port's path: count lookup q + d as count "
         "matrices", lib_count),
    ]
    for _, fn in stages:
        for _ in range(warmup):
            fn()
    # Every traced window first, back to back: PyTorch 2.11's profiler
    # loses a window's device events in a number that grows with the time
    # since the process's first window.
    busy = [traced_busy_us(fn, traced) if device.type == "cuda" else None
            for _, fn in stages]
    rows = []
    for (name, fn), b in zip(stages, busy):
        us = clock_us(fn, device, iters)
        busy_s = "" if device.type != "cuda" else (
            f"  {b:9.1f} us busy (traced)" if b is not None
            else "  busy: the profiler recorded no device time")
        print(f"[{tag}] {name:62s} {us:9.1f} us/iter{busy_s}", flush=True)
        rows.append((name, us, b))
    return rows


def main(argv: Optional[List[str]] = None) -> List[tuple]:
    argv = list(sys.argv[1:] if argv is None else argv)
    only = [a for a in argv if a in ("f32", "bf16")]
    opts = {"iters": 50, "warmup": 5, "traced": 10}
    rest = []
    for a in argv:
        key = a[2:].split("=", 1)[0] if a.startswith("--") else None
        if key in opts:
            opts[key] = int(a.split("=", 1)[1])
        elif a not in only:
            rest.append(a)

    from dssm_tpu_torch.cli.args import coerce_overrides, parse_argv
    from dssm_tpu_torch.config import get_preset, validate
    from dssm_tpu_torch.device import resolve_device

    preset, cpu, _, overrides = parse_argv(["--preset=full"] + rest)
    device = resolve_device(cpu)
    cfg = validate(coerce_overrides(get_preset(preset), overrides))
    print(f"profile_components --preset={cfg.name} on "
          f"{card_line(device)}; {opts['iters']} iterations a stage after "
          f"{opts['warmup']}, {opts['traced']} traced", flush=True)
    rows = []
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        if only and tag not in only:
            continue
        c = validate(cfg.replace(tower=cfg.tower.replace(table_dtype=dtype)))
        rows += [(tag, *r) for r in profile_table(
            c, tag, device, opts["iters"], opts["warmup"], opts["traced"])]
    return rows


if __name__ == "__main__":
    main()
