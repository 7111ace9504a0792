#!/usr/bin/env python3
"""Smoke run of dssm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from dssm_tpu_torch/csrc, holds each kernel
to its plain PyTorch version at the `full` preset's shapes and times both
(the count lookup also bit-equal to the joint lookup through sel =
arange(u2), and timed at the cnn and lstm eval shapes; its backward on both
sides of a per-side batch with f32 and bf16 gradients, two calls bit-equal;
the joint lookup also at the int8 step's shapes; the rank count also at
the multihost preset's 13107 eval pairs), then drives the `full` preset
end to end (500k x 384 table, towers 300->300->128 in bf16, batch 1024,
union dedupe):

  - trains it from seeded fresh weights on the toy corpus's batch stream,
    12 steps through the kernels and the same steps from the same state
    through the plain versions, which must agree, with the loss falling
    (the joint step's lookup on an f32 or bf16 table is the fused gather +
    joint lookup kernel, bit-equal to the gather and joint lookup kernels
    it replaces there, which an int8 table's step still runs; 8 more steps
    traced, with the scatter-add's share of the busy time); then 3
    steps of the per-side branch (separate towers) the same way, and 3
    more traced (device busy ms a step);
  - trains it the same way on a bf16 table and on an int8 table (12 steps
    each, the stochastic-rounding scatters, kernels against plain versions;
    3 steps of each traced, with the scatter's share of the busy time);
  - evaluates the f32, bf16 and int8 models on the held-out split (recall@1,
    NDCG@10, MRR), kernels against plain versions, the second pass from the
    cache of prepared batches, and traces one more cached pass of the f32
    model (device busy ms, of which the rank count and the count lookups);
  - saves the trained state with the port's Checkpointer, restores it,
  - serves from the restored weights: a doc index over 4096 toy titles and
    top-10 for 64 queries, through the kernels and through the plain
    versions, which must agree, and
  - runs cli.train (f32 table; then a bf16 table with periodic eval),
    cli.eval and cli.export on their workdirs.

Then the cnn (CLSM) and lstm presets at their published width (Wc [30000,
1024], Win [30000, 384], batch 1024, 16 words x 8 trigrams): the raw-index
embedding bag and its weight gradient against their plain versions at the
cnn, lstm and full raw shapes on f32 and bf16 tables (the bag also
bit-equal to the count lookup on the same inputs, two weight-gradient
calls bit-equal); the gather at the cnn shape beside index_select, the
scatter-add at the cnn width beside index_add_; SEQ_STEPS steps of each
preset on the union-dedupe and on the raw-index branch, kernels against
plain versions (3 more traced: the bag's share of a raw step, the
scatter-add's of a dedupe step); eval, save, restore and
serving of the trained models (a cached cnn eval pass traced on each
branch: the gathers' and the bags' shares); the weight gradient's path
through the bag; and cli.train + cli.eval + cli.export for --preset=cnn and
--preset=lstm, and cli.train on raw-index batches. A line gathers the
traced device busy ms of the `full` cached eval pass, the cnn eval passes
and the cnn raw step with the gathers' and the bags' shares, and of the
`full` f32 joint step and the cnn dedupe step with the scatter-add's.

The host plane (the C++ hashing and dedupe, data/native.py): the hashing
of both toy corpora and the first 8 `full` joint and 4 cnn / lstm union
batches bit-equal to the plain Python / numpy versions and timed beside
them; pooled batches (4 and 8 threads, and the epoch batch cache) bit-equal
to serial ones, with the time a consumer spends inside next() at each
width; `full` and cnn training fed live
by the loader as cli.train feeds it (plain host at no pool, C++ at 0, 4
and 8 threads: steps/s, next() ms, the traced device busy share); and,
after the CLI drives above, cli.train on a TSV corpus file (written by
write_tsv) for --preset=full at pool widths 0 and 8 and with the epoch
batch cache, and --preset=cnn at 0 and 8 (steps/s from metrics.jsonl),
with cli.eval on the 8-thread runs' workdirs.

The dense-table step (off the sparse path: the whole tree differentiated
on raw-index batches, the dense optimizer over the table too) at the
`full` width: DENSE_STEPS sgd steps through the kernels and the plain
versions from one state; the same steps against the sparse joint step
under f32 compute, on the raw lookups of its dedupe batches (rtol 1e-4);
adam with the first batch's loss falling and the peak device memory; the
table gradient's time alone; traced busy ms and steps/s at K = 1 and
K_CALL steps a call, beside the sparse f32 joint step's. Then K_CALL steps
a call (make_multi_train_step) against one from one state: bit-equal on
the joint step's f32, bf16 and int8 tables, within 1e-4 of the update on
the dense step; the raw bag on live lookups outside the table (refused on
the host; the kernel reads nothing for them, as its plain version). At the
end, cli.train --train.steps_per_call=K_CALL and 1 over CLI_K_STEPS steps,
its records, evals and checkpoints on the steps dssm_tpu's rule gives, and
cli.train --train.optimizer=adam with cli.eval on its workdir.

The multi-device path on one card (phase 6e): the multihost preset at
model_parallel = 1 (500k x 384 table, batch 65,536, one per-shard slot
space of 2048 a batch, sel_local [1, 2048]) on its own corpus: the first
batch's host prep uncached and split, its kernels at the step's shapes
against their plain versions, MH_STEPS steps through the kernels (steps/s,
peak memory) and MH_TRACED traced; the shard-local bodies of an mp = 2
table summed by hand against the unsharded gather and scatters
(bit-equal); the parallel step over an NCCL group of one runs in phase
6j. At the end, cli.train
--preset=multihost --mesh.model_parallel=1 for MH_CLI_STEPS steps and
cli.eval on its workdir.

A dssm_tpu workdir on the card (phase 6f): tests/fixtures/dssm_tpu_workdir,
the full preset's widths at a 2048-row bf16 table with adam and the
AdaGrad table, written by dssm_tpu on the CPU with what dssm_tpu computed
from it. The orbax reader's zstd decoder, its leaves bit-equal to the
stored state and its read time; cli.export (index against dssm_tpu's),
cli.eval (against dssm_tpu's eval line) and cli.train --resume (its first
loss against dssm_tpu's next-step loss) on a copy; approximate against
exact top-k at TOPK_N docs x TOPK_N queries (ms each, id agreement).

Configurations no earlier phase runs (phase 6g), at the presets' widths
from seeded fresh inits, G_STEPS steps each through the kernels and the
plain versions from one state with every kernel's launches a step
checked: per-side cnn and lstm steps; cnn and lstm on bf16 and int8
tables (int8 at G_INT8_VOCAB rows); the row-wise AdaGrad table with adam
(lr G_ADAGRAD_LR) on `full`'s f32 and bf16 tables and cnn's f32 table,
its accumulator column moved on gathered rows only and the dead padding
columns 0; momentum on `full` (the dense-table step, its trace over the
table); the rotate loss on `full` (f32, bf16) and cnn, batches unsorted
with rot_offsets. Each with steps/s on batches made ahead and peak memory;
G_TRACED steps of each traced in a process of their own (`python3
chip_smoke.py --trace-steps FILE`); the count lookup backward and the two
stochastic-rounding scatters timed at the cnn and lstm widths; cli.train
--loss.mode=rotate at K_CALL steps a call against 1 (the same losses and
final eval).

The compiled step (phase 6h): make_train_step's step on the card is a
CUDA graph replayed on the state's own tensors (train/compiled.py). At the
presets' widths, from seeded fresh inits, `full` f32 / bf16 / int8 joint,
`full` per-side, the AdaGrad table with adam, cnn and lstm dedupe and raw,
and the dense-table step with sgd and adam each take the calls of H_ORDER
compiled and eager from one state in lockstep (calls 2 and 3 on one
batch): the states bit-equal after every call (the raw branch and the
dense step, whose index_add_ adds with atomics, within H_ATOMICS_TOL of
their updates), every kernel's launches equal, the aux of every call
intact; steps/s on batches made ahead, compiled and eager in turns
(median, min, max of H_REPEATS); the first calls' peak memory; wall,
traced busy and CUDA-event ms a step of both in a process of their own;
and K_CALL steps a call (one replay) against one, bit-equal.

Eval's and serving's dispatch (phase 6i): on the card an eval pass is one
replay a K-batch block of a CUDA graph over the stacked wire blocks cached
on the card, and one replay of the rank graph; serving embeds a batch a
replay and runs every top-k chunk in one graph (train/compiled.py::
CompiledForward). At the presets' widths from seeded fresh inits, compiled
against eager from one state: `full` at the held-out split (K = 4) and at
I_PAIRS pairs (K = 64), cnn and lstm on their dedupe and raw branches at
the held-out split (K = 1) and on the dedupe branch at I_SEQ_PAIRS pairs
(K = 64, a tail block padded to 64 batches) (embeddings and ranks
bit-equal, metrics and launches equal; first and cached pass seconds,
peak, pool and static-buffer GB); I_STEPS evals between in-place
compiled steps replay one graph, new parameter tensors capture one more;
traced busy ms of a cached pass of each mode in a process of its own
(`python3 chip_smoke.py --trace-evals FILE`); an index of I_PAIRS titles
(titles/s), the I_QUERIES-query latency (median of I_QUERY_REPS), top_k
at I_PAIRS x I_PAIRS exact and approximate (ms, pool GB), all bit-equal
to eager. Phase 7 checks that cli.train's periodic eval, cli.eval and
cli.export capture and replay those graphs.

The parallel steps compiled (phase 6j): over an NCCL group of one (the
only group one card forms; its data and model groups are real process
groups, so the sparse step's graph holds its all-reduces), from seeded
fresh inits, the multihost preset at model_parallel = 1 on its bf16 wire,
`full` f32 joint and the dense-table step with sgd and adam take the calls
of H_ORDER through make_parallel_train_step (a CUDA graph holding the
collectives) and the eager parallel body from one state in lockstep, and
on an f32 wire (multihost's too) the single-device compiled step: the
states bit-equal after every call (the dense step within H_ATOMICS_TOL),
the launches equal, the state's tensors where they were; K_CALL steps a
call (the second block a replay) against K = 1; steps/s compiled and
eager in turns (median, min, max of H_REPEATS); the first call's peak and
pool GB; one replay of each traced in a process of its own (`python3
chip_smoke.py --trace-parallel FILE`), with the NCCL kernels it holds and
the NCCL version; and cli.train --preset=full under DSSM_COORDINATOR /
DSSM_NUM_PROCS=1 / DSSM_PROC_ID=0 at K = 1 and K_CALL, its records those
of the one-process run. A line before the kernels line gives each phase's
start in seconds.

The tooling (phase 7b): cli.train --preset=full with the profiler hook
and TensorBoard (--io.profile_dir, --io.tensorboard=true, an eval every
TOOL_EVAL steps) in a process of its own, its trace holding the card's
kernels (at least 5 fused gather + joint lookup and 5 loss kernel
launches) and its event files the train, eval and weights tags; the
weights record (weight_summaries) of the trained `full` model, timed; and
tools/profile_components.py's stage lines on f32 and bf16 tables.

Every step through the kernels is the compiled step (its first call, a
real step and the graph's capture, inside the timed runs of the earlier
phases); the plain versions, and the traced steps of phases 4-6g but
6c's (the loader's live feed, stepped as cli.train steps it), run the
step body eagerly. Likewise every eval pass and serving call through the
kernels replays the compiled forward's graphs; the plain versions run
eagerly.

It checks that every kernel was launched by the path it belongs to. The
next-to-last line is a JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero before
that line; with no GPU it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import itertools
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
RANK_MULTIHOST = 13107  # eval pairs of the multihost preset (10% of 131072)
TRAIN_PAIRS = 32768    # of the preset's 65536 toy pairs: bounds hashing time
INDEX_BATCHES = 4      # served index: 4 batches of 1024 titles
CLI_PAIRS = 8192       # toy corpus of the command-line drive
CLI_STEPS = 4          # its training steps (f32 table)
CLI_LOWPREC_STEPS = 6  # bf16 table, eval every 3 steps
SEQ_STEPS = 8          # cnn / lstm, each branch, kernels against plain
SEQ_PROFILED_STEPS = 3  # then traced, from the trained state
SEQ_CLI_STEPS = 6      # cli.train of the cnn / lstm presets
HOST_FULL_BATCHES = 8  # full joint batches, C++ against plain host
HOST_SEQ_BATCHES = 4   # cnn / lstm union batches, the same
HOST_POOL_BATCHES = 40  # full batches through each pool width
STREAM_STEPS = 48      # full steps fed live by the loader, per setting
STREAM_SEQ_STEPS = 24  # cnn steps, the same
STREAM_TRACED = 12     # then traced, the same
FILE_STEPS = 96        # cli.train --preset=full on a corpus file, per run
FILE_LOG_EVERY = 16
SEQ_FILE_STEPS = 40    # cli.train --preset=cnn on a corpus file, per run
SEQ_FILE_LOG_EVERY = 8
DENSE_STEPS = 3        # the dense-table step, kernels against plain, etc.
ADAM_LR = 1e-3         # the dense adam runs' learning rate
K_CALL = 4             # steps a call, against 1
K_CHECK_STEPS = 8      # from one state, K_CALL a call against 1
K_TIMED_STEPS = 48     # steps/s at K = 1 and K_CALL, per step kind
CLI_K_STEPS = 22       # cli.train at K_CALL: 5 blocks and a tail of 2
CLI_ADAM_STEPS = 4     # cli.train --train.optimizer=adam
MH_STEPS = 5           # multihost at mp = 1, 65,536 rows, through the kernels
MH_TRACED = 3          # then traced
MH_CLI_STEPS = 3       # cli.train --preset=multihost --mesh.model_parallel=1
FX_RESUME_STEPS = 3    # cli.train --resume on the dssm_tpu workdir
FX_EVAL_TOL = 5e-3     # its cli.eval against dssm_tpu's, each metric
FX_LOSS_TOL = 1e-2     # its first resumed loss against dssm_tpu's
TOPK_N = 65536         # docs and queries of approximate against exact top-k
TOOL_STEPS = 12        # cli.train with the profiler hook and TensorBoard
TOOL_EVAL = 6         # its eval (and weights record) every 6 steps
G_STEPS = 3            # phase 6g: each configuration, kernels against plain
G_TRACED = 3           # then traced in a process of its own, after a warm step
G_CLI_STEPS = 10       # cli.train --loss.mode=rotate at K = K_CALL and 1
G_ADAGRAD_LR = 0.01    # the dssm_tpu fixture's (adam + the AdaGrad table)
G_INT8_VOCAB = 32768   # cnn / lstm int8 tables: 1024 slots of 32-row groups
H_ORDER = (0, 1, 1, 2, 3, 4)  # phase 6h: the batches of the compiled and
#                             eager steps from one state (calls 2, 3 alike)
H_TIMED = 16           # steps a repeat of steps/s on batches made ahead
H_REPEATS = 3          # repeats, compiled and eager in turns
H_TRACED = 4           # then traced in a process of its own, after a warm step
H_ATOMICS_TOL = 0.1    # index_add_'s atomics: compiled / eager update gap
#                       (compare_training's limit for two sound runs: the
#                       atomics' last bits tip bf16 roundings, step by step)
I_PAIRS = 65536        # phase 6i: eval pairs (K = 64), index titles, top_k
I_SEQ_PAIRS = 68000    # its cnn / lstm eval pairs: 67 batches, K = 64,
#                       the second block 3 batches (the last one ragged)
#                       padded to 64
I_STEPS = 3            # compiled steps before the evals, and between them
I_REPEATS = 3          # cached passes of each mode, in turns
I_QUERIES = 64         # the query latency's queries
I_QUERY_REPS = 21      # its repeats, each mode
I_TOPK_REPS = 3        # top_k at I_PAIRS^2, each route and mode
J_TIMED = 16           # phase 6j: steps a repeat of steps/s (full, dense)
J_MH_TIMED = 4         # ... multihost steps a repeat (216.7 ms busy each)
J_CLI_STEPS = 24       # cli.train under DSSM_* at K = 1 and K_CALL (an
#                        eval every 12 steps)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound_ms(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def g_init_params(cache, c, dev):
    """Phase 6g: the seeded fresh parameters of config c, one init of each
    tower layout, table shape and dtype."""
    import torch

    from dssm_tpu_torch.models import base as model_base

    t = c.tower
    key = (t.arch, t.shared_weights, t.vocab_size, t.table_dtype_resolved)
    if key not in cache and key[-1] == "bfloat16":
        # init_params' bf16 table is its f32 table cast: one draw for both.
        f32 = g_init_params(cache, c.replace(tower=t.replace(
            table_dtype="float32")), dev)
        table = model_base.TABLE_KEY[t.arch]
        cache[key] = {tw: {k: v.to(torch.bfloat16) if k == table else v
                           for k, v in tp.items()} for tw, tp in f32.items()}
    if key not in cache:
        cache[key] = model_base.init_params(t, seed=c.train.seed, device=dev)
    return cache[key]


def trace_steps(cases_path: str) -> int:
    """`python3 chip_smoke.py --trace-steps FILE`, the traced steps of
    phases 6g and 6h in a process of their own: FILE holds [(name, config,
    numpy batches, modes)], modes a tuple of "eager" (the step body run
    eagerly on batches widened ahead) and "compiled" (the replayed CUDA
    graph on wire blocks moved ahead). Each configuration's state takes
    one step of each mode from its seeded fresh init (the compiled step's
    first call captures its graph); then, on a line "go" on stdin, the
    torch.profiler windows run back to back, one a configuration and mode
    over its other batches. Prints one JSON line: {name: {mode: traced
    device busy ms, wall ms and CUDA-event device ms a step, the device's
    busy share in the window}}; busy null where a window recorded no
    device event."""
    import pickle

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dssm_tpu_torch.bridge import batch_to_device, batch_to_torch
    from dssm_tpu_torch.train.loop import (
        make_eager_train_step, make_train_step)
    from dssm_tpu_torch.train.state import create_run_state

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    dev = torch.device("cuda")
    inits, ready = {}, []
    for name, c, batches, modes in cases:
        state = create_run_state(c, {
            tw: {k: v.clone() for k, v in tp.items()}
            for tw, tp in g_init_params(inits, c, dev).items()})
        for mode in modes:
            if mode == "compiled":
                step = make_train_step(c)
                tb = [batch_to_device(b, dev).to_device() for b in batches]
            else:
                step = make_eager_train_step(c)
                tb = [batch_to_torch(b, dev) for b in batches]
            state, _ = step(state, tb[0])  # warm (compiled: the capture)
            ready.append((name, mode, step, state, tb[1:]))
    del inits
    torch.cuda.synchronize()
    # The windows wait for the parent to leave the card idle.
    if sys.stdin.readline().strip() != "go":
        return 1
    out = {}
    for name, mode, step, state, tb in ready:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for b in tb:
                state, _ = step(state, b)
            stop.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(float(getattr(e, "self_device_time_total", 0.0))
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        out.setdefault(name, {})[mode] = dict(
            traced_device_busy_ms_per_step=busy / 1e3 / len(tb) if busy
            else None,
            traced_wall_ms_per_step=wall * 1e3 / len(tb),
            event_ms_per_step=start.elapsed_time(stop) / len(tb),
            device_busy_share_traced=busy / 1e6 / wall if busy else None)
    print(json.dumps(out))
    return 0


def trace_evals(cases_path: str) -> int:
    """`python3 chip_smoke.py --trace-evals FILE`, phase 6i's traced eval
    passes in a process of their own: FILE holds [(name, config, hashed
    corpus)]. The config's seeded fresh parameters are evaluated twice
    compiled (train/eval.py: the forward and rank graphs captured, the
    corpus's blocks cached) and twice eagerly; then, on a line "go" on
    stdin, one cached pass of each corpus and mode is traced, the windows
    back to back. Prints "ready" when the passes before the windows are
    done, then one JSON line: {name: {mode: traced device busy ms, wall ms
    and the busy share of the pass}}; busy null where a window recorded no
    device event."""
    import pickle

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.train import eval as eval_mod

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    dev = torch.device("cuda")
    ready = []
    for name, c, hashed in cases:
        params = model_base.init_params(c.tower, seed=c.train.seed,
                                        device=dev)
        for mode in ("compiled", "eager"):
            def run(params=params, c=c, hashed=hashed, mode=mode):
                return eval_mod.evaluate(params, c, hashed,
                                         c.train.batch_size, cache=True,
                                         eager=mode == "eager")
            run()
            run()
            ready.append((name, mode, run))
    torch.cuda.synchronize()
    print("ready", flush=True)  # the parent times nothing before this
    if sys.stdin.readline().strip() != "go":
        return 1
    out = {}
    for name, mode, run in ready:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(float(getattr(e, "self_device_time_total", 0.0))
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        out.setdefault(name, {})[mode] = dict(
            traced_device_busy_ms=busy / 1e3 if busy else None,
            traced_wall_ms=wall * 1e3,
            device_busy_share_traced=busy / 1e6 / wall if busy else None)
    print(json.dumps(out))
    return 0


def trace_parallel(cases_path: str) -> int:
    """`python3 chip_smoke.py --trace-parallel FILE`, phase 6j's traced
    replays in a process of their own: FILE holds [(name, config, numpy
    batches)]. The process joins an NCCL group of one of its own (a file://
    rendezvous beside FILE); each configuration's compiled parallel step
    (make_parallel_train_step) captures its graph on the first batch (its
    collectives inside) and replays once; then, on a line "go" on stdin,
    one more replay a configuration is traced, the windows back to back.
    Prints "ready" when the replays before the windows are done, then one
    JSON line: {name: {traced device busy ms, wall ms, the device's busy
    share, and the device events by name with their count and µs, the
    NCCL ones (a name holding "nccl") and the copies apart}}."""
    import pickle

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dssm_tpu_torch.bridge import batch_to_device
    from dssm_tpu_torch.parallel import dist as pdist
    from dssm_tpu_torch.parallel.mesh import make_mesh
    from dssm_tpu_torch.parallel.train_step import (
        create_sharded_state, make_parallel_train_step)

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    dev = pdist.initialize(f"file://{cases_path}.init", 1, 0)
    ready = []
    try:
        inits = {}
        for name, c, batches in cases:
            mesh = make_mesh(c.mesh, dev)
            state = create_sharded_state(c, mesh, {
                tw: {k: v.clone() for k, v in tp.items()}
                for tw, tp in g_init_params(inits, c, dev).items()})
            step = make_parallel_train_step(c, mesh)
            tb = [batch_to_device(b, dev).to_device() for b in batches]
            for b in tb[:2]:  # the capture, then a replay
                state, _ = step(state, b)
            ready.append((name, step, state, tb[2]))
        del inits
        torch.cuda.synchronize()
        print("ready", flush=True)  # the parent times nothing before this
        if sys.stdin.readline().strip() != "go":
            return 1
        out = {}
        for name, step, state, b in ready:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = step(state, b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = {e.key: (e.count, float(getattr(
                e, "self_device_time_total", 0.0)))
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
            busy = sum(us for _, us in events.values())
            out[name] = dict(
                graphs=step.num_graphs,
                traced_device_busy_ms=busy / 1e3 if busy else None,
                traced_wall_ms=wall * 1e3,
                device_busy_share_traced=busy / 1e6 / wall if busy else None,
                device_events=len(events),
                nccl={k: dict(count=n, us=us) for k, (n, us) in events.items()
                      if "nccl" in k.lower()},
                copies={k: dict(count=n, us=us)
                        for k, (n, us) in events.items()
                        if "memcpy" in k.lower() or "memset" in k.lower()})
        print(json.dumps(out))
        return 0
    finally:
        ready.clear()
        pdist.shutdown()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from dssm_tpu_torch.config import get_preset, validate
    from dssm_tpu_torch.bridge import (
        batch_to_device, batch_to_torch, check_raw_rows)
    from dssm_tpu_torch.data import (
        ToyPairs, batch_iterator, eval_batches, hash_pairs, make_toy_pairs,
        prefetch, train_eval_split, write_tsv)
    from dssm_tpu_torch.data import native as host_native
    from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
    from dssm_tpu_torch.data.loader import (
        add_dedup_fields, compress_wire, pad_batch, select_batch,
        sort_batch_rows, wire_dtype_plan)
    from dssm_tpu_torch.data.remap import (
        apply_remap, build_freq_remap, load_remap, save_remap)
    from dssm_tpu_torch.data.trigram import hash_batch, hash_batch_sequence
    from dssm_tpu_torch.device import resolve_device
    from dssm_tpu_torch.io.checkpoint import Checkpointer
    from dssm_tpu_torch.kernels import _build
    from dssm_tpu_torch.kernels.embed import (
        embedding_bag, embedding_bag_dwgt,
        embedding_bag_dwgt_plain, embedding_bag_plain)
    from dssm_tpu_torch.kernels.count import (
        count_lookup, count_lookup_bwd, count_lookup_bwd_plain,
        count_lookup_plain, count_matrix)
    from dssm_tpu_torch.kernels.dedup_embed import select_rows
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
    from dssm_tpu_torch.tools import eval_kernels, sass
    from dssm_tpu_torch.train import eval as eval_mod
    from dssm_tpu_torch.train.loop import (
        make_eager_train_step, make_train_step)
    from dssm_tpu_torch.train.state import create_run_state

    dev = resolve_device(cpu=False)
    Event = torch.cuda.Event
    t_run, laps = time.perf_counter(), {}

    def lap(phase):
        """Phase `phase` starts now: the run's seconds so far, printed
        before the kernels line (where to cut when the run nears its
        limit)."""
        laps[phase] = round(time.perf_counter() - t_run, 1)

    lap("1")
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
    t0 = time.perf_counter()
    host_native.build(force=True)
    print(f"host data plane build: {time.perf_counter() - t0:.1f} s (g++, "
          f"{os.path.relpath(host_native.SOURCE)})")

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

    # A stochastic-rounding scatter's seed on the card, for the timings in
    # CUDA graphs (an int seed is a synchronising copy, which a capture
    # refuses; the train step computes its seeds on the card).
    seed5 = torch.tensor([5], dtype=torch.int32, device=dev)

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

    def kernel_ms(prof, names):
        """{name: device ms} that one profiler window recorded in the
        kernels whose names hold each of `names`."""
        got = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for n_ in names:
                    if n_ in e.key:
                        got[n_] += float(getattr(
                            e, "self_device_time_total", 0.0)) / 1e3
        return got

    def traced_pass(fn, names):
        """One call of fn traced: device busy ms, and {label: (ms, share of
        the busy time)} for the kernels named by each (label, kernel name)
        of `names`; busy ms None when the window recorded no device event."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            fn()
            torch.cuda.synchronize()
        busy_, top_ = device_time_us(prof_, 8)
        ms_ = kernel_ms(prof_, [k_ for _, k_ in names])
        return dict(
            device_busy_ms=None if busy_ is None else busy_ / 1e3,
            **{f"{label}_ms": ms_[k_] for label, k_ in names},
            **{f"{label}_share": None if not busy_ else ms_[k_] * 1e3 / busy_
               for label, k_ in names},
            top_kernels_us=top_)

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

    lap("2")
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
    # Traced device busy ms of the passes and steps that run the gather, the
    # bag and the scatter-add, with those kernels' shares: printed together
    # at the end.
    traced_summary = {}

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

    def count_check(c2_, inv_, wgt_, what):
        """The kernel against its plain version (f32: rtol 1e-5 of each
        value and of the largest; bf16: 1e-2 of the row's norm); its max
        abs error."""
        got_ = count_lookup(c2_, inv_, wgt_, impl="kernel")
        want_ = count_lookup_plain(c2_, inv_, wgt_)
        torch.cuda.synchronize()
        err_ = (got_ - want_).abs()
        if c2_.dtype == torch.float32:
            tol_ = 1e-5 * want_.abs() + 1e-5 * float(want_.abs().max())
            check(bool((err_ <= tol_).all()), f"count_lookup {what}: max err "
                  f"{float(err_.max())} over rtol 1e-5")
        else:
            row_norm = want_.norm(dim=-1, keepdim=True)
            check(bool((err_ <= 1e-2 * row_norm).all()),
                  f"count_lookup {what}: max err {float(err_.max())} over "
                  "1e-2 x row norm")
        return float(err_.max())

    def count_joint_equal(c2_, q_inv_, q_wgt_, d_inv_, d_wgt_, what):
        """The count lookup is bit-equal, side by side, to the joint lookup
        kernel through sel = arange(u2): both sum each column over the live
        pairs in k order from 0."""
        sel_ = torch.arange(c2_.shape[0], dtype=torch.int32, device=dev)
        lq_, ld_ = joint_lookup(c2_, sel_, q_inv_, q_wgt_, d_inv_, d_wgt_,
                                impl="kernel")
        check(torch.equal(count_lookup(c2_, q_inv_, q_wgt_, impl="kernel"),
                          lq_)
              and torch.equal(count_lookup(c2_, d_inv_, d_wgt_,
                                           impl="kernel"), ld_),
              f"count_lookup {what}: not bit-equal to joint_lookup through "
              "sel = arange(u2)")

    def count_bound(c2_, inv_, wgt_):
        """inv and wgt read once, the rows live lookups name read once, the
        output written once; one f32 multiply-add per live lookup and
        column."""
        live_ = (wgt_ != 0) & (inv_ >= 0) & (inv_ < c2_.shape[0])
        hh_ = c2_.shape[1]
        return bound_ms(inv_.numel() * 8 + torch.unique(inv_[live_]).numel()
                        * hh_ * c2_.element_size()
                        + inv_.numel() // inv_.shape[-1] * hh_ * 4,
                        2.0 * int(live_.sum()) * hh_, "f32")

    count_err, count_cases = {}, {}
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
            dname = str(dtype).split(".")[-1]
            count_err[f"K={k} {dname}"] = count_check(c2, inv, wgt,
                                                      f"{dname} K={k}")
            count_cases[(k, dname)] = (c2, inv, wgt)
    kd_, kq_ = cfg.data.max_trigrams, cfg.data.max_trigrams_query
    for dname in ("float32", "bfloat16"):
        c2, inv_d, wgt_d = count_cases[(kd_, dname)]
        _, inv_q, wgt_q = count_cases[(kq_, dname)]
        count_joint_equal(c2, inv_q, wgt_q, inv_d, wgt_d,
                          f"at the full shapes ({dname})")
    c2, inv, wgt = count_cases[(kd_, "bfloat16")]
    c2_f32 = count_cases[(kd_, "float32")][0]
    inv_l = inv.long()
    cnt = count_matrix(inv, wgt, u2)
    c2f = c2.float()
    b_ms, b_by = count_bound(c2, inv, wgt)
    count_extra = {}
    for (k_, dname), (c2_, inv_, wgt_) in count_cases.items():
        if (k_, dname) != (kd_, "bfloat16"):
            tag = f"k{k_}_{dname}"
            count_extra[f"ms_{tag}"] = graph_ms(
                lambda: count_lookup(c2_, inv_, wgt_, impl="kernel"))
            count_extra[f"ms_plain_{tag}"] = graph_ms(
                lambda: count_lookup_plain(c2_, inv_, wgt_))
            count_extra[f"ms_bound_{tag}"] = count_bound(c2_, inv_, wgt_)[0]
    results["count_lookup"] = dict(
        source="dssm_tpu_torch/csrc/count.cu",
        replaces="dssm_tpu/kernels/pallas_count.py:218",
        max_abs_err=count_err[f"K={kd_} bfloat16"],
        ms=graph_ms(lambda: count_lookup(c2, inv, wgt, impl="kernel")),
        plain_ms=graph_ms(lambda: count_lookup_plain(c2, inv, wgt)),
        # The same function: the count matrix built in the timed call.
        library_ms=graph_ms(lambda: count_matrix(inv, wgt, u2) @ c2.float()),
        # Not the same function: the count matrix built outside the call,
        # as this line's library time was taken before.
        ms_library_counts_outside=graph_ms(lambda: cnt @ c2f),
        # On the f32 block (kernel: ms_k64_float32).
        ms_library_embedding_bag_float32=graph_ms(lambda: F.embedding_bag(
            inv_l, c2_f32, per_sample_weights=wgt, mode="sum")),
        eager_ms=eager_ms(lambda: count_lookup(c2, inv, wgt, impl="kernel")),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"compact2 ({u2}, {h}) bf16, inv/wgt ({rows_n}, {kd_}), "
              f"{int((wgt != 0).sum())} nonzero; bit-equal to joint_lookup "
              "through sel = arange(u2) on f32 and bf16",
        errors=count_err, **count_extra,
    )
    del cnt, c2f, inv_l
    print("count_lookup, the other full-shape cases and library calls (ms): "
          + json.dumps({k_: v_ for k_, v_ in results["count_lookup"].items()
                        if k_.startswith("ms_")}) + f" on {card}")

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

    lap("3")
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

    # Count lookup backward, as the per-side step calls it: both sides of
    # the per-side stream's first batch, slots as compact2 rows; g f32 (the
    # step's: the lookup's f32 output is cast to bf16 after it) and bf16.
    # Two calls must give the same bits. Bound: inv and wgt read once, g
    # read once, d_compact2 written once; one f32 FMA per live lookup and
    # column. Library: one index_add_ of the weighted g rows (the same
    # function; dead lookups folded to slot 0 with weight 0).
    tb_ps = batch_to_torch(next(stream(False)), dev)
    count_bwd_cases, count_bwd_err = {}, 0.0
    for side in ("d", "q"):
        inv_s = tb_ps[f"{side}_inv"].contiguous()
        wgt_s = tb_ps[f"{side}_wgt"].contiguous()
        u2_s = tb_ps[f"{side}_sel"].numel()
        valid_s = (inv_s >= 0) & (inv_s < u2_s)
        nnz_s = int(((wgt_s != 0) & valid_s).sum())
        idx_s = torch.where(valid_s, inv_s, 0).long().reshape(-1)
        w0_s = torch.where(valid_s, wgt_s, 0.0)
        for g_dt in (torch.float32, bf):
            g_s = torch.from_numpy(rng.normal(size=(rows_n, h)).astype(
                np.float32)).to(dev).to(g_dt)
            dc2_k = count_lookup_bwd(inv_s, wgt_s, g_s, u2_s, impl="kernel")
            dc2_k2 = count_lookup_bwd(inv_s, wgt_s, g_s, u2_s, impl="kernel")
            dc2_p = count_lookup_bwd_plain(inv_s, wgt_s, g_s, u2_s)
            torch.cuda.synchronize()
            what = f"{side} side, K={inv_s.shape[1]}, g {str(g_dt)[6:]}"
            err = float((dc2_k - dc2_p).abs().max())
            scale = float(dc2_p.abs().max())
            check(err <= 1e-5 * scale, f"count_lookup_bwd ({what}): max err "
                  f"{err} over 1e-5 x max |dc2| {scale}")
            check(torch.equal(dc2_k, dc2_k2), f"count_lookup_bwd ({what}): "
                  "two calls on the same inputs differ (bit-equal expected: "
                  "no float atomics)")
            count_bwd_err = max(count_bwd_err, err / scale)

            def count_bwd_library(idx_s=idx_s, w0_s=w0_s, g_s=g_s, u2_s=u2_s):
                return torch.zeros((u2_s, h), device=dev).index_add_(
                    0, idx_s, (w0_s[..., None] * g_s.float()[:, None, :]
                               ).reshape(-1, h))

            b_ms, b_by = bound_ms(inv_s.numel() * 8 + g_s.numel()
                                  * g_s.element_size() + u2_s * h * 4,
                                  2.0 * nnz_s * h, "f32")
            count_bwd_cases[what] = dict(
                ms=graph_ms(lambda: count_lookup_bwd(
                    inv_s, wgt_s, g_s, u2_s, impl="kernel")),
                plain_ms=graph_ms(lambda: count_lookup_bwd_plain(
                    inv_s, wgt_s, g_s, u2_s)),
                library_ms=graph_ms(count_bwd_library),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                live_lookups=nnz_s, u2=u2_s)
    print("count_lookup_bwd, each case run twice on the same inputs: "
          f"bit-equal; on {card}: " + json.dumps(count_bwd_cases))
    step_case = count_bwd_cases[f"d side, K={tb_ps['d_inv'].shape[1]}, "
                                "g float32"]
    results["count_lookup_bwd"] = dict(
        source="dssm_tpu_torch/csrc/count.cu (csrc/segsum.cuh)",
        replaces="dssm_tpu/kernels/pallas_count.py:168",
        tolerance=f"1e-5 x max |dc2| (largest ratio {count_bwd_err:.3g}); "
                  "two calls bit-equal",
        **{k: step_case[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err")},
        cases=count_bwd_cases,
        shape="the per-side step's d side, g f32 (every case in `cases`): "
              f"inv/wgt ({rows_n}, {tb_ps['d_inv'].shape[1]}) -> "
              f"({step_case['u2']}, {h}) f32, {step_case['live_lookups']} "
              "live lookups; every row written by the kernel, no zero fill",
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

    lap("3b")
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
    # The scatters' bound is the larger of their bytes and the instructions
    # they issue (Philox and the rounding), counted by class in this run's
    # build (cuobjdump -sass of a thread's work, over its elements) and
    # issued at the card's SM count and maximum SM clock.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clock = eval_kernels.sm_clock_hz()
    sr_instr = eval_kernels.sr_instructions(_build.library_path())
    print(f"scatter kernels, instructions an element by class (cuobjdump "
          f"-sass of this run's build): {json.dumps(sr_instr)}; {sms} SMs "
          f"at {sm_clock / 1e6:.0f} MHz")
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
        rows_all = (torch.where((uniq_lp >= 0) & (uniq_lp < groups_lp),
                                uniq_lp, 0).long()[:, None] * grp
                    + torch.arange(grp, device=dev)).reshape(-1)
        results["gather_row_groups"][f"library_ms_{tname}"] = graph_ms(
            lambda: tbl.index_select(0, rows_all))
        print(f"gather_row_groups on the {tname} table: kernel "
              f"{results['gather_row_groups'][f'ms_{tname}']:.4f} ms, library "
              "(index_select of the slots' rows) "
              f"{results['gather_row_groups'][f'library_ms_{tname}']:.4f} ms "
              f"on {card}")
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
        issue_ms = sass.issue_bound_us(sr_instr[name], real_s * grp * h,
                                       sms, sm_clock) / 1e3
        if issue_ms > b_ms:
            b_ms, b_by = issue_ms, "operations"
        results[name] = dict(
            source="dssm_tpu_torch/csrc/scatter_sr.cu",
            replaces=f"dssm_tpu/kernels/pallas_gather.py:{line}",
            max_abs_err=0.0, tolerance="bit-equal (same Philox stream)",
            ms=graph_ms(lambda: fn(t_k, uniq_lp, upd, grp, seed5,
                                   impl="kernel")),
            plain_ms=eager_ms(lambda: fn_plain(t_k, uniq_lp, upd, grp, seed5),
                              reps=5, trials=3),
            library_ms=graph_ms(lambda: t_k.index_copy_(0, rows_lp,
                                                        composed)),
            bound_ms=b_ms, bound_by=b_by, issue_bound_ms=issue_ms,
            instructions_per_element=sr_instr[name],
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
    cnt_q16 = count_matrix(f16[1], f16[2], f16[0].numel())
    cnt_d16 = count_matrix(f16[3], f16[4], f16[0].numel())

    def joint_library_bf16():  # as row 5's library: the count matrices
        c2_ = compact16.index_select(0, f16[0].long()).float()  # built outside
        return cnt_q16 @ c2_, cnt_d16 @ c2_

    results["joint_lookup"]["library_ms_bfloat16"] = graph_ms(
        joint_library_bf16)

    # The joint lookup at the int8 step's shapes: the int8 stream's first
    # batch over its compact block of 256 slots of 32 rows, f32 (as
    # dequant_compact returns it), here gathered from the f32 table.
    tb8 = batch_to_torch(lowprec["int8"]["batches"][0], dev)
    f8 = [tb8[k].contiguous() for k in ("sel", "q_inv", "q_wgt", "d_inv",
                                        "d_wgt")]
    compact8 = gather_row_groups(table, tb8["uniq"], 32, impl="kernel")
    lk8 = joint_lookup(compact8, *f8, impl="kernel")
    lp8 = joint_lookup_plain(compact8, *f8)
    err8 = max(float((a_ - b_).abs().max()) for a_, b_ in zip(lk8, lp8))
    scale8 = max(float(b_.abs().max()) for b_ in lp8)
    check(err8 <= 1e-5 * scale8, f"joint_lookup at the int8 step's shapes: "
          f"max err {err8} over 1e-5 x {scale8}")
    cnt_q8 = count_matrix(f8[1], f8[2], f8[0].numel())
    cnt_d8 = count_matrix(f8[3], f8[4], f8[0].numel())

    def joint_library_int8():  # as row 5's library at the smoke's shape
        c2_ = compact8.index_select(0, f8[0].long())
        return cnt_q8 @ c2_, cnt_d8 @ c2_

    nnz8 = int((f8[2] != 0).sum() + (f8[4] != 0).sum())
    both8 = torch.unique(torch.cat([
        f8[0].long()[f8[1].long()[f8[2] != 0]],
        f8[0].long()[f8[3].long()[f8[4] != 0]]])).numel()
    rj = results["joint_lookup"]
    rj["max_abs_err"] = max(rj["max_abs_err"], err8)
    rj.update(
        ms_int8_step=graph_ms(lambda: joint_lookup(compact8, *f8,
                                                   impl="kernel")),
        plain_ms_int8_step=graph_ms(lambda: joint_lookup_plain(compact8,
                                                               *f8)),
        library_ms_int8_step=graph_ms(joint_library_int8),
        bound_ms_int8_step=bound_ms(
            (f8[1].numel() + f8[3].numel()) * 8 + f8[0].numel() * 4
            + both8 * h * 4 + 2 * rows_n * h * 4, 2.0 * nnz8 * h, "f32")[0],
        shape_int8_step=f"compact {tuple(compact8.shape)} f32, {nnz8} live "
                        f"lookups on {both8} rows")
    print("joint_lookup at the int8 step's shapes and on the bf16 compact "
          f"block, on {card}: " + json.dumps(
              {k: v for k, v in rj.items() if k.endswith("_int8_step")
               or k == "library_ms_bfloat16"}))
    del compact8, lk8, lp8, cnt_q8, cnt_d8
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

    rank_big = {}
    for n_, nd_ in ((1000, 1777), (RANK_MULTIHOST, RANK_MULTIHOST),
                    (RANK_N, RANK_N)):
        rq, rd, margin = rank_case(n_, nd_)
        r_k = rank_counts(rq, rd, impl="kernel")
        r_p = rank_counts_plain(rq, rd)
        torch.cuda.synchronize()
        check(torch.equal(r_k, r_p), f"rank_counts differs from its plain "
              f"version at {n_} x {nd_} ({int((r_k != r_p).sum())} ranks)")
        check(int(r_k.min()) == 1 and int(r_k.max()) > 10,
              f"rank_counts: ranks {int(r_k.min())}..{int(r_k.max())}")
        if n_ == RANK_MULTIHOST:
            true_r = true_scores(rq, rd)
            rank_big = dict(
                ms_13107=graph_ms(lambda: rank_counts(rq, rd, impl="kernel"),
                                  reps=3),
                ms_plain_13107=graph_ms(lambda: rank_counts_plain(rq, rd),
                                        reps=3),
                ms_library_13107=graph_ms(
                    lambda: (rq @ rd.T > true_r[:, None]).sum(1), reps=3),
                ms_bound_13107=bound_ms(
                    (rq.numel() + rd.numel() + 2 * n_) * 4,
                    2.0 * n_ * n_ * dims[-1], "f32")[0])
        del r_p
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
              f"1000 x 1777 and at {RANK_MULTIHOST}^2 (ms_13107)",
        **rank_big,
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

    lap("3c")
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

    raw_seq_np = next(seq_stream("cnn", False))
    raw_full_np = next(batch_iterator(
        hashed_train, cfg.train.batch_size, seed=cfg.train.seed))
    raw_seq = batch_to_torch(raw_seq_np, dev)
    raw_full = batch_to_torch(raw_full_np, dev)
    bag_inputs = {
        "cnn": (seq_params["cnn"]["shared"]["Wc"], raw_seq["d_idx"],
                raw_seq["d_wgt"], raw_seq_np),
        "lstm": (seq_params["lstm"]["shared"]["Win"], raw_seq["d_idx"],
                 raw_seq["d_wgt"], raw_seq_np),
        "full": (table, raw_full["d_idx"], raw_full["d_wgt"], raw_full_np),
    }
    bag_cases = {}
    for case, (tbl32, b_idx, b_wgt, b_np) in bag_inputs.items():
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
            dw_k2 = embedding_bag_dwgt(tbl, b_idx, g_b, impl="kernel")
            dw_p = embedding_bag_dwgt_plain(tbl, b_idx, g_b)
            torch.cuda.synchronize()
            check(torch.equal(dw_k, dw_k2), f"embedding_bag_bwd ({case}, "
                  f"{dname}): two calls differ (bit-equal expected)")
            err_f, sc_f = (float((out_k - out_p).abs().max()),
                           float(out_p.abs().max()))
            check(err_f <= 1e-5 * sc_f, f"embedding_bag ({case}, {dname}): "
                  f"max err {err_f} over 1e-5 x max |out| {sc_f}")
            # One kernel body: the count lookup over the whole table gives
            # the bag's bits.
            check(torch.equal(out_k, count_lookup(tbl, b_idx, b_wgt,
                                                  impl="kernel")),
                  f"embedding_bag ({case}, {dname}): differs from "
                  "count_lookup on the same inputs (bit-equal expected)")
            err_w, sc_w = (float((dw_k - dw_p).abs().max()),
                           float(dw_p.abs().max()))
            check(err_w <= 1e-5 * sc_w, f"embedding_bag_bwd ({case}, {dname}):"
                  f" max err {err_w} over 1e-5 x max |d_wgt| {sc_w}")
            del out_k, out_p, dw_k, dw_k2, dw_p
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
            # The range check runs on the host, on the numpy batch before
            # it is moved (bridge.check_raw_rows, both sides): timed alone
            # on the host clock. The wrapper reads nothing back on the card.
            check_ms = []
            for _ in range(21):
                t0 = time.perf_counter()
                check_raw_rows(b_np, tbl.shape[0])
                check_ms.append((time.perf_counter() - t0) * 1e3)
            bag_cases[(case, dname)] = dict(
                fwd_ms=graph_ms(lambda: embedding_bag(tbl, b_idx, b_wgt,
                                                      impl="kernel")),
                host_check_ms=statistics.median(check_ms),
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
    # The count lookup at the cnn and lstm eval shapes: each side's 16384
    # word rows of 8 lookups into compact2, the block's selected rows in the
    # compute dtype (bf16) as the eval path forms it, from Wc [30000, 1024]
    # and from Win [30000, 384]; bit-equal to the joint lookup through
    # sel = arange(u2) on both sides; timed on the d side.
    count_seq = {}
    for arch, tbl_ in (("cnn", wc),
                       ("lstm", seq_params["lstm"]["shared"]["Win"])):
        c2_s = select_rows(gather_row_groups(tbl_, uniq_c, 8, impl="kernel"),
                           jf[0], torch.bfloat16).contiguous()
        err_s = max(count_check(c2_s, jf[1], jf[2], f"{arch} q side"),
                    count_check(c2_s, jf[3], jf[4], f"{arch} d side"))
        count_joint_equal(c2_s, *jf[1:], f"at the {arch} shapes")
        count_seq[arch] = dict(
            ms=graph_ms(lambda: count_lookup(c2_s, jf[3], jf[4],
                                             impl="kernel")),
            plain_ms=graph_ms(lambda: count_lookup_plain(c2_s, jf[3], jf[4])),
            library_ms=graph_ms(lambda: count_matrix(
                jf[3], jf[4], c2_s.shape[0]) @ c2_s.float()),
            bound_ms=count_bound(c2_s, jf[3], jf[4])[0], max_abs_err=err_s,
            shape=f"compact2 {tuple(c2_s.shape)} bf16, inv/wgt "
                  f"{tuple(jf[3].shape)}, {int((jf[4] != 0).sum())} live")
        del c2_s
    rc = results["count_lookup"]
    rc["max_abs_err"] = max(rc["max_abs_err"], *(
        r_["max_abs_err"] for r_ in count_seq.values()))
    for arch, r_ in count_seq.items():
        rc.update({f"ms_{arch}": r_["ms"], f"ms_plain_{arch}": r_["plain_ms"],
                   f"ms_library_{arch}": r_["library_ms"],
                   f"ms_bound_{arch}": r_["bound_ms"]})
    print("count_lookup at the cnn and lstm eval shapes (d side; both sides "
          "bit-equal to joint_lookup through sel = arange(u2)): "
          + json.dumps(count_seq) + f" on {card}")
    # Library calls at the cnn shapes: the gather's index_select of the
    # group rows; the joint lookup's products with count matrices built
    # outside the call, as row 5's library at the full shapes.
    rows_cg = (torch.where((uniq_c >= 0) & (uniq_c < wc.shape[0] // 8),
                           uniq_c, 0).long()[:, None] * 8
               + torch.arange(8, device=dev)).reshape(-1)
    cnt_qc = count_matrix(jf[1], jf[2], jf[0].numel())
    cnt_dc = count_matrix(jf[3], jf[4], jf[0].numel())

    def joint_library_cnn():
        c2_ = comp_c.index_select(0, jf[0].long())
        return cnt_qc @ c2_, cnt_dc @ c2_

    cnn_shapes = {
        "fused_gather_joint_lookup": fused_c,
        "gather_row_groups": dict(
            ms=graph_ms(lambda: gather_row_groups(wc, uniq_c, 8,
                                                  impl="kernel")),
            plain_ms=graph_ms(lambda: gather_row_groups(wc, uniq_c, 8,
                                                        impl="plain")),
            library_ms=graph_ms(lambda: wc.index_select(0, rows_cg)),
            bound_ms=bound_ms((real_c + uniq_c.numel()) * 8 * hc * 4
                              + uniq_c.numel() * 4, 0, "f32")[0],
            max_abs_err=0.0),
        "joint_lookup": dict(
            ms=graph_ms(lambda: joint_lookup(comp_c, *jf, impl="kernel")),
            plain_ms=graph_ms(lambda: joint_lookup_plain(comp_c, *jf)),
            library_ms=graph_ms(joint_library_cnn),
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
        results[name]["ms_library_cnn"] = r_["library_ms"]
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
    del flat_qc, flat_dc, rows_cg, cnt_qc, cnt_dc

    # The scatter-add at the cnn width: the cnn dedupe step's f32 update of
    # Wc (8-row groups, the batch's 1024 slots), bit-equal to the plain
    # version, with index_add_ of the real rows beside it.
    hw = wc.shape[1]
    vals_c = torch.from_numpy(rng.normal(size=(uniq_c.numel() * 8, hw)).astype(
        np.float32)).to(dev) * 1e-3
    real_cm = (uniq_c >= 0) & (uniq_c < wc.shape[0] // 8)
    n_real_c = int(real_cm.sum())
    wk, wp = wc.clone(), wc.clone()
    scatter_add_row_groups(wk, uniq_c, vals_c, 8, impl="kernel")
    scatter_add_row_groups_plain(wp, uniq_c, vals_c, 8)
    torch.cuda.synchronize()
    check(torch.equal(wk, wp) and not torch.equal(wk, wc),
          "scatter_add_row_groups differs from its plain version at the cnn "
          "width (bit-exact expected)")
    del wp
    rows_sc = (uniq_c[real_cm].long()[:, None] * 8
               + torch.arange(8, device=dev)).reshape(-1)
    vals_sc = vals_c.reshape(uniq_c.numel(), 8, hw)[real_cm].reshape(-1, hw)
    sc_cnn = dict(
        ms_cnn=graph_ms(lambda: scatter_add_row_groups(wk, uniq_c, vals_c, 8,
                                                       impl="kernel")),
        ms_plain_cnn=graph_ms(lambda: scatter_add_row_groups_plain(
            wk, uniq_c, vals_c, 8)),
        ms_library_cnn=graph_ms(lambda: wk.index_add_(0, rows_sc, vals_sc)),
        ms_bound_cnn=bound_ms(3 * n_real_c * 8 * hw * 4 + uniq_c.numel() * 4,
                              n_real_c * 8 * hw, "f32")[0])
    results["scatter_add_row_groups"].update(sc_cnn)
    print(f"scatter_add_row_groups at the cnn width (Wc {tuple(wc.shape)} "
          f"f32, {uniq_c.numel()} slots of 8 rows, {n_real_c} real): "
          + json.dumps(sc_cnn) + f" on {card}")
    del wk, vals_c, vals_sc, rows_sc

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

    lap("4")
    # ---- phase 4: the training path at full width ------------------------
    def clone_params(p):
        return {tw: {k: v.clone() for k, v in tp_.items()}
                for tw, tp_ in p.items()}

    def run_steps(run_cfg, state, batches_np, impl):
        """Drive the steps as cli/train does (numpy batch -> device ->
        step, no wait in between); (state, losses, wall s). Through the
        kernels the compiled step (its first call captures the graph, and
        the wall time holds it); through the plain versions the body run
        eagerly (they read values back, which a capture refuses)."""
        step_fn = (make_eager_train_step(run_cfg, impl) if impl == "plain"
                   else make_train_step(run_cfg, impl))
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
                         dedup_group=group, loss_tol=2e-2, first_tol=1e-2):
        """The same steps from the same state through the kernels and
        through the plain versions; checks and returns the kernel run.
        ONE step from the same state: every f32 parameter's largest
        difference is held to first_tol (1e-2) of that tensor's largest
        update (a gradient formed in bf16 compute parts by one bf16
        rounding, 2^-8 of itself, where an f32 sum's last bits tip it;
        2.3e-3 to 4.6e-3 read on an H100 over every branch), and a
        bf16 or int8 table is compared in grid steps (both runs draw the
        same random stream, so they part only where the accumulators' last
        bits tip a rounding). The whole run: under bf16 compute the two
        runs drift apart step by step (a tower activation rounds to the
        neighbouring bf16 value, the kernels sum in another order than
        the plain versions), so the loss curves are held to loss_tol and each
        parameter's update (the table's on its touched rows) to 0.1 of
        itself, by update_gap: a wrong update reads 1 or more, the sound
        runs of every branch on an H100 at most 0.039 (the cnn's). Under
        adam the dense parameters are compared by their first moments (the
        gradients' running mean) against zero: adam moves a parameter by
        the sign of a gradient that is f32 noise, +-lr in either run."""
        steps = len(batches_np)
        key = model_base.TABLE_KEY[run_cfg.tower.arch]
        adam = run_cfg.train.optimizer == "adam"

        def compared(state_, tw, k):
            """(tensor, its value before the run) two runs' updates of
            parameter k of tower tw are compared by."""
            if adam and k != key:
                mu_ = state_.opt_state["mu"][tw][k]
                return mu_, torch.zeros_like(mu_)
            return state_.params[tw][k], init[tw][k]

        # Warm-up outside the counted run (cuBLAS handles, allocator): one
        # step of each on copies, kept for the one-step comparison.
        first = {}
        for impl in ("auto", "plain"):
            first[impl] = run_steps(
                run_cfg, create_run_state(run_cfg, clone_params(init)),
                batches_np[:1], impl)[0]
        first_gap, first_share, first_param_gap, first_rel = 0.0, 0.0, 0.0, 0.0
        for tw in init:
            for k, want in first["plain"].params[tw].items():
                if want.dtype != torch.float32 or k == f"{key}_scale":
                    continue  # a low-precision table: in grid steps, below
                want, before = compared(first["plain"], tw, k)
                got = compared(first["auto"], tw, k)[0]
                apart = float((got - want).abs().max())
                moved = float((want - before).abs().max())
                first_param_gap = max(first_param_gap, apart)
                first_rel = max(first_rel, apart / moved if moved > 0 else (
                    0.0 if apart == 0 else float("inf")))
            if init[tw][key].dtype != torch.float32:
                hit = touched_rows(tw, init, batches_np[:1], dedup_group, key)
                first_gap, first_share = grid_steps_apart(
                    first["auto"].params[tw][key][hit],
                    first["plain"].params[tw][key][hit], init[tw][key][hit])
        del first
        check(first_rel <= first_tol, f"{what}: after one step from the "
              f"same state kernel and plain parameters differ by "
              f"{first_param_gap}, {first_rel} of the tensor's largest update"
              f" > {first_tol}")
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
                    want, before = compared(s_p, tw, k)
                    dense_rel = max(dense_rel, update_gap(
                        compared(s_k, tw, k)[0], want, before))
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

    step_fn = make_eager_train_step(cfg, "auto")  # the eager step's time
    # A copy: the step updates its state in place, and phase 5 saves the
    # trained one.
    state_prof = create_run_state(cfg, clone_params(tr["state"].params))
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
    scatter_ms_t = kernel_ms(prof_t, ("scatter_add_row_groups_kernel",))[
        "scatter_add_row_groups_kernel"] / n_prof
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
        scatter_add_ms_per_step_traced=scatter_ms_t,
        scatter_add_share_traced=(
            None if not dev_us_t else scatter_ms_t * 1e3 * n_prof / dev_us_t),
        peak_mem_gb=tr["peak"] / 1e9,
        resident_before_run_gb=tr["resident"] / 1e9,
        real_group_slots_first_batch=real_t,
    )
    print("training path: " + json.dumps(train_path))
    traced_summary["full f32 joint step"] = dict(
        device_busy_ms=train_path["traced_device_busy_ms_per_step"],
        scatter_add_ms=scatter_ms_t,
        scatter_add_share=train_path["scatter_add_share_traced"])
    print(f"device time by kernel in the traced steps (us, {n_prof} steps): "
          + json.dumps(top_t))

    def traced_step(what, cfg_, state_, batches_, names_):
        """Device busy time a step of `batches_` from `state_`, traced
        (their wire fields moved to the card first), the top kernels, and
        the device time a step of the kernels whose names hold one of
        `names_`, together and each with its share of the busy time;
        returns the state after the steps and those numbers."""
        tb_ = [batch_to_torch(b_, dev) for b_ in batches_]
        step_ = make_eager_train_step(cfg_, "auto")  # the eager step's time
        state_, _ = step_(state_, tb_[0])  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            t0_ = time.perf_counter()
            for b_ in tb_:
                state_, _ = step_(state_, b_)
            torch.cuda.synchronize()
            wall_ = time.perf_counter() - t0_
        us_, top_ = device_time_us(prof_, 10)
        by_name = kernel_ms(prof_, names_)
        named_ms = sum(by_name.values())
        out_ = dict(device_busy_ms_per_step=(
            None if us_ is None else us_ / 1e3 / len(tb_)),
            wall_ms_per_step=wall_ * 1e3 / len(tb_),
            named_kernels=list(names_),
            named_kernels_ms_per_step=(
                None if us_ is None else named_ms / len(tb_)),
            by_kernel=None if us_ is None else {
                n_: dict(ms_per_step=ms_ / len(tb_),
                         share_of_busy=ms_ * 1e3 / us_)
                for n_, ms_ in by_name.items()},
            top_kernels_us=top_)
        print(f"{what}, traced ({len(tb_)} steps, on {card}): "
              + json.dumps(out_))
        return state_, out_

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
    traced_step("per-side step, f32 table", cfg_ps, ps["state"],
                [next(it) for _ in range(PER_SIDE_STEPS)],
                ("bwd_rank_kernel", "bwd_scan_kernel", "bwd_place_kernel",
                 "bwd_reduce_kernel"))  # the 2 count_lookup_bwd calls a step
    del params_ps, ps

    lap("4b")
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
        # is rounded to bf16 first, and where the sum order tips that rounding
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
        if tname == "int8":
            traced_step("int8 joint step", cfg_lp, run["state"],
                        lp["batches"][:PER_SIDE_STEPS],
                        ("joint_lookup_kernel", "scatter_sr_kernel"))
        else:
            traced_step("bf16 joint step", cfg_lp, run["state"],
                        lp["batches"][:PER_SIDE_STEPS],
                        ("scatter_sr_kernel",))
        del params_lp, run

    lap("4c")
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
        if tname == "float32":
            # One cached pass traced: the device's busy time, and the rank
            # count's, the count lookups' and the gathers' shares of it.
            eval_runs[tname]["traced_cached_pass"] = traced_pass(
                lambda: eval_mod.evaluate(params_e, cfg_e, hashed_eval, bs,
                                          "auto", cache=True),
                (("rank_counts", "rank_counts_kernel"),
                 ("count_lookup", "lookup_fwd_kernel"),
                 ("gather_row_groups", "gather_row_groups_kernel")))
            traced_summary["full cached eval pass (f32 table)"] = eval_runs[
                tname]["traced_cached_pass"]
        print(f"evaluate, {tname} table: " + json.dumps(eval_runs[tname]))
        del q_e, d_e
    results["rank_counts"]["launches"] = counts_e["rank_counts"]
    eval_mod._EVAL_CACHES.clear()
    del lowprec_runs, eval_models

    lap("5")
    # ---- phase 5: train -> save -> restore ---------------------------------
    t0 = time.perf_counter()
    ckpt = Checkpointer(workdir)
    ckpt.save(tr["state"].step, tr["state"])
    t1 = time.perf_counter()
    restored = ckpt.restore(device=dev)
    check(restored.step == TRAIN_STEPS == restored.host_step,
          f"restored step {restored.host_step}")
    for k, v in tr["state"].params["shared"].items():
        check(torch.equal(restored.params["shared"][k], v),
              f"restored {k} differs from the trained one")
    print(f"checkpoint: saved step {restored.host_step} in {t1 - t0:.1f} s, "
          f"restored bit-identically in {time.perf_counter() - t1:.1f} s")
    params = restored.params  # the serving phase embeds from these
    remap = load_remap(workdir)
    check(remap is not None and np.array_equal(remap, train_remap),
          "the saved vocab remap did not come back")
    tmp_dir.cleanup()
    del tr, restored, state_prof

    lap("6")
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
    t4 = time.perf_counter()
    hash_batch(titles, t.vocab_size, cfg.data.max_trigrams,
               cfg.data.normalize_counts, impl="plain")
    host_split = dict(hash_both_sides_s=t1 - t0, remap_s=t2 - t1,
                      dedupe_s=t3 - t2, hash_doc_side_alone_s=t4 - t3,
                      hash_doc_side_alone_plain_s=time.perf_counter() - t4)
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

    lap("6b")
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
            step_fn = make_eager_train_step(run_cfg, "auto")
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
            # The bag forward and the count lookup share one kernel body
            # (lookup_fwd_kernel); a training step runs it only as the bag.
            named_s = kernel_ms(prof_s, ("lookup_fwd_kernel",
                                         "scatter_add_row_groups_kernel"))
            bag_ms_s = named_s["lookup_fwd_kernel"] / SEQ_PROFILED_STEPS
            scatter_ms_s = (named_s["scatter_add_row_groups_kernel"]
                            / SEQ_PROFILED_STEPS)
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
                embedding_bag_ms_per_step_traced=bag_ms_s,
                embedding_bag_share_traced=(
                    None if not dev_us_s
                    else bag_ms_s * 1e3 * SEQ_PROFILED_STEPS / dev_us_s),
                scatter_add_ms_per_step_traced=scatter_ms_s,
                scatter_add_share_traced=(
                    None if not dev_us_s
                    else scatter_ms_s * 1e3 * SEQ_PROFILED_STEPS / dev_us_s),
                peak_mem_gb=run["peak"] / 1e9,
                resident_before_run_gb=run["resident"] / 1e9,
                launches_per_step={k: v // SEQ_STEPS
                                   for k, v in run["counts"].items() if v})
            print(f"training path, {arch} preset, {branch} branch: "
                  + json.dumps(summary))
            if (arch, branch) == ("cnn", "joint"):
                traced_summary["cnn dedupe step"] = dict(
                    device_busy_ms=summary["traced_device_busy_ms_per_step"],
                    scatter_add_ms=scatter_ms_s,
                    scatter_add_share=summary["scatter_add_share_traced"])
            if (arch, branch) == ("cnn", "raw"):
                traced_summary["cnn raw step"] = dict(
                    device_busy_ms=summary["traced_device_busy_ms_per_step"],
                    embedding_bag_ms=bag_ms_s,
                    embedding_bag_share=summary[
                        "embedding_bag_share_traced"])
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
        traced_e = None
        if arch == "cnn":
            # One cached pass traced: the gathers' and the count lookups'
            # shares (dedupe branch), or the bags' (raw branch; the bag and
            # the count lookup share the kernel body lookup_fwd_kernel).
            traced_e = traced_pass(
                lambda: eval_mod.evaluate(params_e, cfg_e, seq_eval, bs,
                                          "auto", cache=True),
                (("gather_row_groups", "gather_row_groups_kernel"),
                 ("count_lookup" if branch == "joint" else "embedding_bag",
                  "lookup_fwd_kernel"),
                 ("rank_counts", "rank_counts_kernel")))
            traced_summary[f"cnn cached eval pass ({branch} branch)"] = (
                traced_e)
        print(f"evaluate, {arch} preset ({branch} branch): " + json.dumps(dict(
            card=card, eval_pairs=len(seq_eval), metrics=m_cold,
            metric_gap_kernel_vs_plain=metric_gap, first_pass_s=cold,
            cached_pass_s=hot, traced_cached_pass=traced_e)))
        del q_e, d_e
    eval_mod._EVAL_CACHES.clear()
    print(f"traced device busy ms, with the gathers', the bags' and the "
          f"scatter-add's shares (on {card}): " + json.dumps(
              {k: {k2: v2 for k2, v2 in v.items() if k2 != "top_kernels_us"}
               for k, v in traced_summary.items()}))

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

    lap("6c")
    # ---- phase 6c: the host plane: C++ against plain, the thread pool ----
    # The C++ host data plane (data/native.py) against its plain Python /
    # numpy versions: the hashing of both toy corpora and the dedupe of the
    # first HOST_FULL_BATCHES `full` joint batches and HOST_SEQ_BATCHES cnn /
    # lstm union batches (the two presets share their corpus, caps and
    # seed, so one stream is both), bit-equal, each timed serially; pooled
    # batches bit-identical to serial ones, with the time a consumer spends
    # inside next() at each pool width; then training fed live by the loader as cli.train feeds it (a
    # prefetch thread over batch_iterator), the plain host path at no pool
    # against the C++ one at each pool width, with the device's busy share
    # of a traced window.
    def timed(fn):
        t0_ = time.perf_counter()
        out_ = fn()
        return out_, time.perf_counter() - t0_

    def same(a_, b_, what):
        if isinstance(a_, dict):
            check(sorted(a_) == sorted(b_), f"{what}: fields differ")
            a_, b_ = [a_[k_] for k_ in sorted(a_)], [b_[k_] for k_ in sorted(b_)]
        for x_, y_ in zip(a_, b_):
            check(x_.dtype == y_.dtype and np.array_equal(x_, y_),
                  f"{what}: C++ and plain differ")

    host = dict(card=card, host_cpus=os.cpu_count())
    norm = cfg.data.normalize_counts
    kq_full = cfg.data.max_trigrams_query or cfg.data.max_trigrams
    hash_cases = (
        ("full queries", train_pairs.queries, lambda x_, i_: hash_batch(
            x_, t.vocab_size, kq_full, norm, impl=i_)),
        ("full titles", train_pairs.titles, lambda x_, i_: hash_batch(
            x_, t.vocab_size, cfg.data.max_trigrams, norm, impl=i_)),
        ("cnn / lstm titles, per word", seq_train_p.titles,
         lambda x_, i_: hash_batch_sequence(
             x_, sc.tower.vocab_size, sc.data.max_words,
             sc.data.max_trigrams_per_word, norm, impl=i_)))
    host["hashing_texts_per_s"] = {}
    for what, texts_, fn_ in hash_cases:
        got_, s_native = timed(lambda: fn_(texts_, "auto"))
        want_, s_plain = timed(lambda: fn_(texts_, "plain"))
        same(got_, want_, f"hashing {what}")
        host["hashing_texts_per_s"][what] = dict(
            texts=len(texts_), cpp=len(texts_) / s_native,
            plain=len(texts_) / s_plain)

    def full_stream(impl="auto", workers=0, **kw_):
        return batch_iterator(
            hashed_train, cfg.train.batch_size, seed=cfg.train.seed,
            dedup_unique=cfg.data.max_unique, dedup_group=group,
            dedup_unique_rows=cfg.data.max_unique_rows, dedup_joint=True,
            wire_compress=True, sort_rows=True, pipeline_workers=workers,
            impl=impl, **kw_)

    def seq_joint_stream(impl="auto", workers=0):
        c = seq_cfg["cnn"]
        return batch_iterator(
            seq_train, c.train.batch_size, True, seed=c.train.seed,
            dedup_unique=c.data.max_unique, dedup_group=8,
            dedup_unique_rows=c.data.max_unique_rows, dedup_joint=True,
            pipeline_workers=workers, impl=impl)

    def next_ms(it_, n_):
        """The batches and the ms a consumer spends inside each next()."""
        out_, ms_ = [], []
        for _ in range(n_):
            b_, s_ = timed(lambda: next(it_))
            out_.append(b_)
            ms_.append(s_ * 1e3)
        it_.close()
        return out_, ms_

    host["prep_ms_per_batch_serial"] = {}
    serial_ref = {}
    for what, make_, n_ in (("full joint", full_stream, HOST_FULL_BATCHES),
                            ("cnn / lstm union", seq_joint_stream,
                             HOST_SEQ_BATCHES)):
        got_, ms_native = next_ms(make_("auto"), n_)
        want_, ms_plain = next_ms(make_("plain"), n_)
        for i_, (a_, b_) in enumerate(zip(got_, want_)):
            same(a_, b_, f"{what} batch {i_}")
        serial_ref[what] = got_
        host["prep_ms_per_batch_serial"][what] = dict(
            batches=n_, cpp=statistics.median(ms_native),
            plain=statistics.median(ms_plain))

    # Where a `full` batch's serial C++ prep goes: the slice of the corpus
    # rows, the dedupe (the C++ call and the keep masks), the row sort and
    # the wire compression (ms, median over the batches).
    plan_full = wire_dtype_plan(hashed_train, cfg.data.max_unique,
                                cfg.data.max_unique_rows)
    split_ms = {k_: [] for k_ in ("slice", "dedupe", "sort", "compress")}
    perm_ = np.random.default_rng((cfg.train.seed, 0)).permutation(
        len(hashed_train))
    for i_ in range(HOST_FULL_BATCHES):
        rows_ = perm_[i_ * cfg.train.batch_size:(i_ + 1) * cfg.train.batch_size]
        b_, s_slice = timed(lambda: select_batch(hashed_train, rows_))
        b_, s_dedupe = timed(lambda: add_dedup_fields(
            b_, cfg.data.max_unique, group, cfg.data.max_unique_rows, True))
        b_, s_sort = timed(lambda: sort_batch_rows(b_))
        b_, s_compress = timed(lambda: compress_wire(b_, plan_full))
        for k_, v_ in zip(split_ms, (s_slice, s_dedupe, s_sort, s_compress)):
            split_ms[k_].append(v_ * 1e3)
    host["full_prep_split_ms_cpp"] = {k_: statistics.median(v_)
                                      for k_, v_ in split_ms.items()}

    # Pooled against serial, and the consumer's next() time at each width
    # (nothing between the calls: the pool's throughput).
    host["next_ms_per_batch_no_consumer"] = {}
    for what, make_, n_ in (("full joint", full_stream, HOST_POOL_BATCHES),
                            ("cnn / lstm union", seq_joint_stream,
                             HOST_SEQ_BATCHES * 3)):
        row_ = {}
        for workers in (0, 4, 8):
            got_, ms_ = next_ms(make_(workers=workers), n_)
            for i_, (a_, b_) in enumerate(zip(got_, serial_ref[what])):
                same(a_, b_, f"{what} batch {i_}, {workers} pool threads")
            row_[f"workers_{workers}"] = statistics.median(ms_[2:])
        host["next_ms_per_batch_no_consumer"][what] = row_
    pooled_cached, _ = next_ms(full_stream(
        workers=8, reshuffle_each_epoch=False, cache_epoch_batches=True),
        2 * (len(hashed_train) // cfg.train.batch_size) + 1)
    fixed_, _ = next_ms(full_stream(reshuffle_each_epoch=False),
                        len(pooled_cached))
    for i_, (a_, b_) in enumerate(zip(pooled_cached, fixed_)):
        same(a_, b_, f"epoch-cached full batch {i_}")

    print("host plane: " + json.dumps(host))

    # Training fed live by the loader, as cli.train feeds it.
    def streamed(run_cfg, state, make_stream, steps, impl, workers):
        """steps/s and the ms inside next() a step over `steps` steps (after
        4 to warm up), then a traced window of STREAM_TRACED steps: the
        device's busy share of its wall time."""
        step_fn_ = make_train_step(run_cfg, "auto")
        batches_ = prefetch(make_stream(impl=impl, workers=workers), depth=2)
        for _ in range(4):
            state, _ = step_fn_(state, batch_to_torch(next(batches_), dev))
        torch.cuda.synchronize()
        wait_ms = []
        t0_ = time.perf_counter()
        for _ in range(steps):
            b_, s_ = timed(lambda: next(batches_))
            wait_ms.append(s_ * 1e3)
            state, _ = step_fn_(state, batch_to_torch(b_, dev))
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0_
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            t1_ = time.perf_counter()
            for _ in range(STREAM_TRACED):
                state, _ = step_fn_(state, batch_to_torch(next(batches_), dev))
            torch.cuda.synchronize()
            traced_wall_ = time.perf_counter() - t1_
        batches_.close()
        us_, _ = device_time_us(prof_, 4)
        return state, dict(
            host=impl if isinstance(impl, str) else "prepared",
            pool_threads=workers, steps=steps,
            steps_per_s=steps / wall_,
            next_ms_per_step=statistics.median(wait_ms),
            traced_wall_ms_per_step=traced_wall_ * 1e3 / STREAM_TRACED,
            device_busy_share_traced=(
                None if us_ is None else us_ / 1e6 / traced_wall_))

    def prepared_stream(impl, workers):
        """The first batches of the `full` stream, made ahead, in a cycle:
        prefetch's hand-off with no prep behind it."""
        return itertools.cycle(serial_ref["full joint"])

    def cached_stream(impl, workers):
        return full_stream(impl, workers, reshuffle_each_epoch=False,
                           cache_epoch_batches=True)

    stream_runs = []
    state_s = create_run_state(cfg, clone_params(params))
    seq_state = seq_runs[("cnn", "joint")]
    for what, run_cfg, make_, steps, settings in (
            ("full", cfg, full_stream, STREAM_STEPS,
             (("plain", 0), ("auto", 0), ("auto", 4), ("auto", 8))),
            ("full, made ahead", cfg, prepared_stream, STREAM_STEPS,
             ((None, 0),)),
            ("full, epoch cache", cfg, cached_stream, STREAM_STEPS,
             (("auto", 8),)),
            ("cnn", seq_state["cfg"], seq_joint_stream, STREAM_SEQ_STEPS,
             (("plain", 0), ("auto", 0), ("auto", 4), ("auto", 8)))):
        state_ = seq_state["state"] if what == "cnn" else state_s
        for impl, workers in settings:
            state_, row_ = streamed(run_cfg, state_, make_, steps, impl,
                                    workers)
            if make_ is cached_stream:
                # Batches 4 .. 4 + steps - 1 are timed; one from the second
                # epoch on is a cache hit.
                bpe_ = len(hashed_train) // cfg.train.batch_size
                row_.update(batches_per_epoch=bpe_, cache_hit_share_timed=sum(
                    i_ >= bpe_ for i_ in range(4, 4 + steps)) / steps)
            stream_runs.append(dict(preset=what, **row_))
            if what != "cnn":
                state_s = state_
    print(f"training fed live by the loader (prefetch over batch_iterator, "
          f"as cli.train; on {card}): " + json.dumps(stream_runs))
    del state_s, seq_state, state_, serial_ref, pooled_cached, fixed_

    lap("6d")
    # ---- phase 6d: the dense-table step and K steps a call ---------------
    # The full preset off the sparse path (train.sparse_embed_update=False,
    # or adam with the sgd table optimizer), on raw-index batches of the
    # smoke's stream, as cli.train feeds it: both towers from the table on,
    # the whole tree differentiated (the table's gradient is the bag's
    # dense [V, H] f32 d_table, a segment sum), the dense optimizer over
    # all of it. sgd: DENSE_STEPS through the kernels and through the plain
    # versions from one state (compare_training), then the same steps
    # against the sparse joint step, under f32 compute, on the dedupe
    # batches of the same pairs (the dense step on each one's raw lookups:
    # the same mathematics, held to dssm_tpu's rtol 1e-4); adam (lr
    # ADAM_LR): DENSE_STEPS with the first batch's loss falling, the peak
    # memory. Then K_CALL steps a call against one (make_multi_train_step):
    # K_CHECK_STEPS from one state bit-equal on the joint step's f32, bf16
    # and int8 tables, the dense step within its atomics' f32 noise; and
    # steps/s at K = 1 and K_CALL on batches made ahead.
    from dssm_tpu_torch.kernels.embed import embedding_bag_grad_plain
    from dssm_tpu_torch.train.loop import (
        make_loss_fn, make_multi_train_step, stack_batches)

    dense_kernels = {"embedding_bag": 2, "dense_tower_residuals": 2,
                     "in_batch_loss": 1, "in_batch_loss_dq": 1,
                     "in_batch_loss_dd": 1}
    cfg_dense = validate(cfg.replace(
        data=cfg.data.replace(dedup_lookup=False),
        train=cfg.train.replace(sparse_embed_update=False)))
    cfg_adam = validate(cfg_dense.replace(train=cfg.train.replace(
        optimizer="adam", learning_rate=ADAM_LR)))
    vocab = t.vocab_size
    raw_it = batch_iterator(hashed_train, cfg.train.batch_size,
                            seed=cfg.train.seed)
    dense_np = [next(raw_it) for _ in range(2 * DENSE_STEPS + K_TIMED_STEPS)]
    params_d = model_base.init_params(t, seed=cfg.train.seed, device=dev)
    dn = compare_training(cfg_dense, params_d, dense_np[:DENSE_STEPS],
                          "dense-table step (sgd)", dense_kernels)
    print(f"dense-table step, sgd, {DENSE_STEPS} steps: loss {dn['loss']}; "
          f"launches {json.dumps({k: dn['counts'][k] for k in dense_kernels})}"
          f"; kernel vs plain: {json.dumps(gaps(dn))}")

    def raw_from_dedupe(b_):
        """The raw-index batch a joint dedupe batch stands for: each
        lookup's table row and its weight, as the dedupe kept it (a lookup
        whose group overflowed the slots has weight 0)."""
        uq_, sl_ = b_["uniq"].astype(np.int64), b_["sel"].astype(np.int64)
        out_ = {}
        for s_ in "qd":
            c_ = sl_[b_[f"{s_}_inv"].astype(np.int64)]
            w_ = b_[f"{s_}_wgt"].astype(np.float32)
            rows_ = uq_[c_ // group] * group + c_ % group
            out_[f"{s_}_idx"] = np.where(w_ != 0, rows_, 0).astype(np.int32)
            out_[f"{s_}_wgt"] = w_
        return out_

    cfg32 = validate(cfg.replace(tower=t.replace(compute_dtype="float32")))
    cfg32_dense = validate(cfg_dense.replace(tower=cfg32.tower))
    ded_it = batch_iterator(
        hashed_train, cfg.train.batch_size, seed=cfg.train.seed,
        dedup_unique=cfg.data.max_unique, dedup_group=group,
        dedup_unique_rows=cfg.data.max_unique_rows, dedup_joint=True,
        wire_compress=True, sort_rows=False)
    ded_np = [next(ded_it) for _ in range(DENSE_STEPS)]
    kept = sum(float((b_[f"{s_}_wgt"] != 0).sum()) for b_ in ded_np
               for s_ in "qd") / sum(float((b_[f"{s_}_wgt"] != 0).sum())
                                     for b_ in dense_np[:DENSE_STEPS]
                                     for s_ in "qd")
    s_dense = create_run_state(cfg32_dense, clone_params(params_d))
    s_sparse = create_run_state(cfg32, clone_params(params_d))
    step_d, step_s = make_train_step(cfg32_dense), make_train_step(cfg32)
    ds_loss_gap = 0.0
    for b_ in ded_np:
        s_dense, a_d = step_d(s_dense, batch_to_torch(
            raw_from_dedupe(b_), dev, vocab_size=vocab))
        s_sparse, a_s = step_s(s_sparse, batch_to_torch(b_, dev))
        ds_loss_gap = max(ds_loss_gap, abs(float(a_d["loss"])
                                           - float(a_s["loss"])))
    ds_gap = 0.0
    for k_, want in s_sparse.params["shared"].items():
        got = s_dense.params["shared"][k_]
        ds_gap = max(ds_gap, float((got - want).abs().max()))
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-6),
              f"dense vs sparse step (f32 compute): {k_} differs by "
              f"{float((got - want).abs().max())} (rtol 1e-4, atol 1e-6)")
    check(ds_loss_gap <= 1e-5 * float(a_s["loss"]),
          f"dense vs sparse step: losses differ by {ds_loss_gap}")
    del s_dense, s_sparse
    print(f"dense-table step against the sparse joint step, f32 compute, "
          f"{DENSE_STEPS} steps on the same lookups (the dedupe kept "
          f"{kept:.4f} of the raw batches' live lookups): loss gap "
          f"{ds_loss_gap:.3g}, largest parameter gap {ds_gap:.3g} "
          "(rtol 1e-4, atol 1e-6)")

    # adam: the table's moments live beside it; the peak of the step.
    loss_fn = make_loss_fn(cfg_adam)
    first_tb = batch_to_torch(dense_np[0], dev, vocab_size=vocab)
    with torch.no_grad():
        adam_before = float(loss_fn(params_d, first_tb)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_a = torch.cuda.memory_allocated()
    s_adam = create_run_state(cfg_adam, clone_params(params_d))
    _build.reset_launch_counts()
    s_adam, adam_losses, adam_wall = run_steps(
        cfg_adam, s_adam, dense_np[:DENSE_STEPS], "auto")
    adam_counts = _build.launch_counts()
    peak_a = torch.cuda.max_memory_allocated()
    for name, n in adam_counts.items():
        check(n == dense_kernels.get(name, 0) * DENSE_STEPS,
              f"dense-table step (adam): kernel {name} launched {n} times "
              f"in {DENSE_STEPS} steps")
    with torch.no_grad():
        adam_after = float(loss_fn(s_adam.params, first_tb)[0])
    check(all(np.isfinite(adam_losses)) and adam_after < adam_before,
          f"dense-table step (adam): losses {adam_losses}, the first "
          f"batch's loss {adam_before} -> {adam_after}")
    check(s_adam.opt_state["count"] == DENSE_STEPS
          and s_adam.opt_state["mu"]["shared"]["W0"].shape
          == params_d["shared"]["W0"].shape,
          "dense-table step (adam): no moments over the table")

    # The table gradient alone (PyTorch, as in dssm_tpu: outside any
    # kernel): the doc side's d_table of the first raw batch, eager.
    tb_raw = batch_to_torch(dense_np[0], dev, vocab_size=vocab)
    w_cols = params_d["shared"]["W0"].shape[1]
    g_dt = torch.from_numpy(rng.normal(
        size=(cfg.train.batch_size, w_cols)).astype(np.float32)).to(dev)
    dtable_ms = eager_ms(lambda: embedding_bag_grad_plain(
        g_dt, tb_raw["d_idx"], tb_raw["d_wgt"], vocab), reps=5, trials=5)
    # Its least bytes: the [V, H] f32 output written once, idx, wgt, g read.
    dtable_bound, _ = bound_ms(vocab * w_cols * 4
                               + tb_raw["d_idx"].numel() * 8
                               + g_dt.numel() * 4, 0.0, "f32")
    del g_dt

    # Traced: busy ms a step of the dense sgd and adam steps, with the
    # d_table's segment sum and zero fill (index_add_, fill) and the
    # elementwise kernels (the optimizer over the table), beside the sparse
    # f32 joint step's (phase 4).
    dense_names = ("indexFunc", "FillFunctor", "elementwise_kernel")
    dn["state"], tr_sgd = traced_step(
        "dense-table step, sgd", cfg_dense, dn["state"],
        dense_np[DENSE_STEPS:2 * DENSE_STEPS], dense_names)
    s_adam, tr_adam = traced_step(
        "dense-table step, adam", cfg_adam, s_adam,
        dense_np[DENSE_STEPS:2 * DENSE_STEPS], dense_names)

    def timed_steps(run_cfg, state_, batches_np, k_):
        """steps/s over batches made ahead, each batch (k_ = 1) or block
        of k_ stacked batches moved and stepped as cli.train does it (the
        stacking, cli.train's background thread's work, done ahead)."""
        fn_ = (make_train_step(run_cfg) if k_ == 1
               else make_multi_train_step(run_cfg))
        units_ = (batches_np if k_ == 1 else [
            stack_batches(batches_np[i_:i_ + k_])
            for i_ in range(0, len(batches_np), k_)])
        state_, _ = fn_(state_, batch_to_torch(units_[0], dev))  # warm
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        for u_ in units_:
            state_, _ = fn_(state_, batch_to_torch(u_, dev,
                                                   vocab_size=vocab))
        torch.cuda.synchronize()
        return state_, len(batches_np) / (time.perf_counter() - t0_)

    rates = {}
    timed_np = dense_np[2 * DENSE_STEPS:]
    for what, run_cfg, state_fn, b_np in (
            ("sparse f32 joint", cfg,
             lambda: create_run_state(cfg, clone_params(params_d)),
             list(itertools.islice(itertools.cycle(host_batches_t),
                                   K_TIMED_STEPS))),
            ("dense sgd", cfg_dense, lambda: dn["state"], timed_np),
            ("dense adam", cfg_adam, lambda: s_adam, timed_np)):
        for k_ in (1, K_CALL):
            st_, rates[f"{what}, K={k_}"] = timed_steps(run_cfg, state_fn(),
                                                        b_np, k_)
            del st_
    dense_summary = dict(
        card=card, steps=DENSE_STEPS, adam_lr=ADAM_LR,
        sgd_loss=dn["loss"], adam_loss=adam_losses,
        adam_first_batch_loss_before_after=[adam_before, adam_after],
        adam_peak_mem_gb=peak_a / 1e9,
        adam_resident_before_gb=resident_a / 1e9,
        adam_peak_above_resident_gb=(peak_a - resident_a) / 1e9,
        sgd_peak_mem_gb=dn["peak"] / 1e9,
        sgd_peak_above_resident_gb=(dn["peak"] - dn["resident"]) / 1e9,
        sgd_steps_per_s_first_run=DENSE_STEPS / dn["wall_s"],
        adam_steps_per_s_first_run=DENSE_STEPS / adam_wall,
        traced_busy_ms_per_step=dict(
            dense_sgd=tr_sgd["device_busy_ms_per_step"],
            dense_adam=tr_adam["device_busy_ms_per_step"],
            sparse_f32_joint=traced_summary["full f32 joint step"][
                "device_busy_ms"]),
        traced_wall_ms_per_step=dict(
            dense_sgd=tr_sgd["wall_ms_per_step"],
            dense_adam=tr_adam["wall_ms_per_step"]),
        d_table_ms=dtable_ms, d_table_bound_ms=dtable_bound,
        steps_per_s_made_ahead=rates)
    print("dense-table path: " + json.dumps(dense_summary))
    del dn, s_adam, first_tb, tb_raw

    # K_CALL steps a call against one step a call, K_CHECK_STEPS steps from
    # one state; every count set to 0 before the K-step run and read after.
    joint_counts = {k: 1 for k in joint_kernels}
    k_cases = [("f32 joint", cfg, lambda: clone_params(params_d),
                host_batches_t[:K_CHECK_STEPS], joint_counts, True)]
    for tname, sr_name in (("bfloat16", "scatter_sr_row_groups"),
                           ("int8", "scatter_sr_int8_row_groups")):
        cfg_lp = validate(cfg.replace(tower=t.replace(table_dtype=tname)))
        lp_kernels = joint_kernels[:-1] + (sr_name,)
        if tname == "int8":
            lp_kernels = ("gather_row_groups", "joint_lookup") + lp_kernels[1:]
        k_cases.append((
            f"{tname} joint", cfg_lp,
            lambda c_=cfg_lp: model_base.init_params(
                c_.tower, seed=cfg.train.seed, device=dev),
            lowprec[tname]["batches"][:K_CHECK_STEPS],
            {k: 1 for k in lp_kernels}, True))
    k_cases.append(("dense f32 compute", cfg32_dense,
                    lambda: clone_params(params_d),
                    dense_np[:K_CHECK_STEPS], dense_kernels, False))
    k_check = {}
    for what, run_cfg, make_params, b_np, want_counts, exact in k_cases:
        init_ = make_params()
        ends = {}
        for k_ in (1, K_CALL):
            st_ = create_run_state(run_cfg, clone_params(init_))
            _build.reset_launch_counts()
            if k_ == 1:
                fn_ = make_train_step(run_cfg)
                for b_ in b_np:
                    st_, _ = fn_(st_, batch_to_torch(b_, dev,
                                                     vocab_size=vocab))
            else:
                fn_ = make_multi_train_step(run_cfg)
                for i_ in range(0, len(b_np), k_):
                    st_, aux_ = fn_(st_, batch_to_torch(
                        stack_batches(b_np[i_:i_ + k_]), dev,
                        vocab_size=vocab))
                    check(aux_["loss"].shape == (k_,),
                          f"K = {k_} ({what}): aux not stacked [K]")
            counts_ = _build.launch_counts()
            for name, n in counts_.items():
                check(n == want_counts.get(name, 0) * len(b_np),
                      f"K = {k_} ({what}): kernel {name} launched {n} "
                      f"times in {len(b_np)} steps")
            check(st_.step == len(b_np), f"K = {k_} ({what}): step count")
            ends[k_] = st_.params
        worst = 0.0
        for tw, tp_ in ends[1].items():
            for k2, v in tp_.items():
                if exact:
                    check(torch.equal(v, ends[K_CALL][tw][k2]),
                          f"K = {K_CALL} against K = 1 ({what}): {tw}/{k2} "
                          "differs (bit-equal expected)")
                else:
                    worst = max(worst, update_gap(ends[K_CALL][tw][k2], v,
                                                  init_[tw][k2]))
        check(worst <= 1e-4, f"K = {K_CALL} against K = 1 ({what}): "
              f"updates {worst} of themselves apart > 1e-4")
        k_check[what] = "bit-equal" if exact else dict(update_gap=worst)
        del init_, ends, st_
    print(f"{K_CALL} steps a call against 1, {K_CHECK_STEPS} steps from one "
          f"state (launches as K single steps): " + json.dumps(k_check))

    # The raw bag on a batch with live lookups outside the table: the host
    # refuses the batch; the kernel, given it anyway, reads nothing for
    # them and adds nothing, as its plain version (and as the same lookups
    # at weight 0).
    w0_d = params_d["shared"]["W0"]
    oob_np = {k: v.copy() for k, v in dense_np[0].items()}
    live_ = np.argwhere(oob_np["d_wgt"] != 0)[::97]
    oob_np["d_idx"][tuple(live_[0::2].T)] = vocab + 5
    oob_np["d_idx"][tuple(live_[1::2].T)] = -3
    try:
        check_raw_rows(oob_np, vocab)
        check(False, "check_raw_rows passed live lookups outside the table")
    except IndexError:
        pass
    oob = batch_to_torch(oob_np, dev)
    dead_np = dict(oob_np, d_wgt=oob_np["d_wgt"].copy())
    dead_np["d_wgt"][tuple(live_.T)] = 0.0
    oob_k = embedding_bag(w0_d, oob["d_idx"], oob["d_wgt"], impl="kernel")
    oob_dead = embedding_bag(w0_d, oob["d_idx"],
                             batch_to_torch(dead_np, dev)["d_wgt"],
                             impl="kernel")
    oob_p = embedding_bag_plain(w0_d, oob["d_idx"], oob["d_wgt"])
    oob_err = float((oob_k - oob_p).abs().max())
    check(torch.equal(oob_k, oob_dead) and oob_err <= 1e-5 * float(
        oob_p.abs().max()), f"embedding_bag on lookups outside the table: "
          f"max err {oob_err} against the plain version")
    print(f"embedding_bag with {len(live_)} live lookups outside the table "
          f"(of {int((oob_np['d_wgt'] != 0).sum())}): refused on the host; "
          f"the kernel equals itself with them at weight 0, and the plain "
          f"version to {oob_err:.3g}")
    del params_d, oob, oob_k, oob_dead, oob_p

    lap("6e")
    # ---- phase 6e: the multi-device path on one card ---------------------
    # The multihost preset at model_parallel = 1 (what dssm_tpu runs on one
    # device): its full width (500k x 384 f32 table, 300->300->128 bf16),
    # its full 65,536-row batch and caps, the union dedupe with one
    # per-shard slot space of max_unique_rows_local = 2048 (sel_local
    # [1, 2048]), on its own toy corpus (131,072 pairs, 8192 words, the
    # frequency remap) built as cli.train builds it: the epoch holds one
    # batch, so the epoch cache replays the first. The path's kernels at
    # its shapes against their plain versions; MH_STEPS steps through the
    # kernels (the counts reset just before and read just after), their
    # steps/s and peak memory; MH_TRACED more traced. Then the
    # shard-local bodies of the mp = 2 table (kernels/sharded_embed.py),
    # both shards in this process, summed by hand against the unsharded
    # kernels. (The parallel step over an NCCL group of one: phase 6j.)
    from dssm_tpu_torch.data.loader import reslot_local
    from dssm_tpu_torch.kernels.gather import sublane_group
    from dssm_tpu_torch.kernels.sharded_embed import (
        embedding_bag_local, gather_compact_local, scatter_add_groups_local,
        scatter_sr_groups_local)
    cfg_mh = validate(get_preset("multihost").replace(
        mesh=get_preset("multihost").mesh.replace(model_parallel=1)))
    tm, dm = cfg_mh.tower, cfg_mh.data
    bm = cfg_mh.train.batch_size
    t0 = time.perf_counter()
    mh_pairs = make_toy_pairs(dm.toy_num_pairs, dm.toy_vocab_words, dm.seed)
    mh_train_p, mh_eval_p = train_eval_split(mh_pairs, eval_frac=dm.eval_frac,
                                             seed=dm.seed)
    mh_train = hash_pairs(mh_train_p, tm, dm)
    mh_remap = build_freq_remap(mh_train, tm.vocab_size, num_shards=1)
    mh_train = apply_remap(mh_train, mh_remap)
    mh_hash_s = time.perf_counter() - t0
    params_mh = model_base.init_params(tm, seed=cfg_mh.train.seed, device=dev)
    table_mh = params_mh["shared"]["W0"]
    group_mh = sublane_group(table_mh.dtype)

    def mh_stream(**kw):
        return batch_iterator(
            mh_train, bm, seed=cfg_mh.train.seed,
            dedup_unique=dm.max_unique, dedup_group=group_mh,
            dedup_unique_rows=dm.max_unique_rows, dedup_joint=True,
            wire_compress=True, sort_rows=True,
            local_sel_cap=dm.max_unique_rows_local,
            reshuffle_each_epoch=False, cache_epoch_batches=True, **kw)

    mh_it = mh_stream()
    t0 = time.perf_counter()
    mh_np = next(mh_it)
    mh_prep_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    check(next(mh_it) is mh_np, "multihost: the epoch cache did not replay "
          "the epoch's one batch")
    mh_cached_ms = (time.perf_counter() - t0) * 1e3
    # The first batch's prep split: the global dedupe (select_batch), the
    # row sort, the slot space, the wire compression.
    rows_mh = np.random.default_rng((cfg_mh.train.seed, 0)).permutation(
        len(mh_train))[:bm]
    mh_split = {}
    t0 = time.perf_counter()
    b_ = select_batch(mh_train, rows_mh, dm.max_unique, group_mh,
                      dm.max_unique_rows, True)
    mh_split["select_and_dedupe"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    b_ = sort_batch_rows(b_)
    mh_split["row_sort"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    b_ = reslot_local(b_, dm.max_unique_rows_local)
    mh_split["reslot_local"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    b_ = compress_wire(b_, wire_dtype_plan(mh_train, dm.max_unique,
                                           dm.max_unique_rows))
    mh_split["compress_wire"] = (time.perf_counter() - t0) * 1e3
    check(all(np.array_equal(b_[k], mh_np[k]) for k in mh_np),
          "multihost: the batch built step by step differs from the loader's")
    del b_
    live_local = np.unique(np.concatenate([
        mh_np[f"{s_}_inv"][mh_np[f"{s_}_wgt"] != 0].astype(np.int64)
        for s_ in "qd"])).size
    print(f"multihost corpus: {len(mh_train)} train pairs hashed + remapped "
          f"in {mh_hash_s:.1f} s; the first batch ({bm} rows, sel_local "
          f"{list(mh_np['sel_local'].shape)}, {live_local} of "
          f"{dm.max_unique_rows_local} local slots used, "
          f"{int((mh_np['uniq'] < tm.vocab_size // group_mh).sum())} of "
          f"{mh_np['uniq'].shape[0]} groups real) built in {mh_prep_ms:.1f} "
          f"ms uncached, {mh_cached_ms:.3f} ms from the epoch cache; split "
          f"(ms): {json.dumps({k: round(v, 2) for k, v in mh_split.items()})}")

    tbm = batch_to_torch(mh_np, dev)
    from dssm_tpu_torch.train.sparse_update import joint_fields, joint_row_sel

    mh_fields = joint_fields(tbm, joint_row_sel(tbm))
    row_sel_mh, qi_m, qw_m, di_m, dw_m = mh_fields
    n_gr = tbm["uniq"].shape[0] * group_mh
    mh_kern = {}

    def mh_time(fn, reps=5):
        return eager_ms(fn, reps=reps, trials=3)

    def mh_record(name, err, ms, plain_ms, nbytes, flops, kind="f32"):
        b_ms, b_by = bound_ms(nbytes, flops, kind)
        mh_kern[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by)
        results[name].update({"ms_multihost": ms, "plain_ms_multihost":
                              plain_ms, "bound_ms_multihost": b_ms,
                              "max_abs_err_multihost": err})

    # The fused gather + joint lookup (its outputs two [65536, 384] f32).
    lq_mk, ld_mk, c_mk = fused_gather_joint_lookup(
        table_mh, tbm["uniq"], *mh_fields, group_mh, impl="kernel")
    lq_mp, ld_mp, c_mp = fused_gather_joint_lookup_plain(
        table_mh, tbm["uniq"], *mh_fields, group_mh)
    err = max(float((lq_mk - lq_mp).abs().max()),
              float((ld_mk - ld_mp).abs().max()))
    check(torch.equal(c_mk, c_mp) and err <= 1e-5 * max(
        1.0, float(lq_mp.abs().max()), float(ld_mp.abs().max())),
        f"multihost: fused_gather_joint_lookup differs by {err}")
    hm = table_mh.shape[1]
    mh_record("fused_gather_joint_lookup", err,
              mh_time(lambda: fused_gather_joint_lookup(
                  table_mh, tbm["uniq"], *mh_fields, group_mh,
                  impl="kernel")),
              mh_time(lambda: fused_gather_joint_lookup_plain(
                  table_mh, tbm["uniq"], *mh_fields, group_mh), reps=1),
              c_mk.numel() * 4 * 2 + (qi_m.numel() + di_m.numel()) * 8
              + (lq_mk.numel() + ld_mk.numel()) * 4,
              2.0 * int((qw_m != 0).sum() + (dw_m != 0).sum()) * hm)
    # Its backward at the step's gradients (f32 [65536, 384] a side).
    gen_ = torch.Generator(device=dev).manual_seed(SEED)
    g_lqm = torch.randn(lq_mk.shape, device=dev, generator=gen_) * 1e-3
    g_ldm = torch.randn(ld_mk.shape, device=dev, generator=gen_) * 1e-3
    dc_k = joint_lookup_bwd(*mh_fields, g_lqm, g_ldm, n_gr, impl="kernel")
    dc_p = joint_lookup_bwd_plain(*mh_fields, g_lqm, g_ldm, n_gr)
    err = float((dc_k - dc_p).abs().max())
    check(err <= 1e-5 * max(1.0, float(dc_p.abs().max())),
          f"multihost: joint_lookup_bwd differs by {err}")
    check(torch.equal(dc_k, joint_lookup_bwd(*mh_fields, g_lqm, g_ldm, n_gr,
                                             impl="kernel")),
          "multihost: two joint_lookup_bwd calls differ")
    mh_record("joint_lookup_bwd", err,
              mh_time(lambda: joint_lookup_bwd(*mh_fields, g_lqm, g_ldm,
                                               n_gr, impl="kernel")),
              mh_time(lambda: joint_lookup_bwd_plain(
                  *mh_fields, g_lqm, g_ldm, n_gr), reps=1),
              (g_lqm.numel() + g_ldm.numel() + dc_k.numel()) * 4
              + (qi_m.numel() + di_m.numel()) * 8,
              2.0 * int((qw_m != 0).sum() + (dw_m != 0).sum()) * hm)
    # The loss kernels at 65,536 x 65,536: the plain version on slices of
    # 4096 query rows against the whole pool (the full logits would be 17
    # GB), dd summed over the slices.
    gq_ = torch.randn(bm, tm.semantic_dim, device=dev, generator=gen_)
    gd_ = torch.randn(bm, tm.semantic_dim, device=dev, generator=gen_)
    qm_, dm_ = F.normalize(gq_, dim=1), F.normalize(gd_, dim=1)
    lab_ = torch.arange(bm, device=dev, dtype=torch.int32)
    gam = cfg_mh.loss.gamma
    nll_k, lse_k, _, _ = in_batch_nll_kernel(qm_, dm_, lab_, gam)
    gnl = torch.full((bm,), 1.0 / bm, device=dev)
    dq_k = in_batch_loss_dq(qm_, dm_, lab_, gam, lse_k, gnl)
    dd_k = in_batch_loss_dd(qm_, dm_, lab_, gam, lse_k, gnl)
    errs_l = dict(nll=0.0, dq=0.0, dd=0.0)
    dd_p = torch.zeros_like(dd_k)
    t0 = time.perf_counter()
    for lo in range(0, bm, 4096):
        sl_ = slice(lo, lo + 4096)
        nll_p, lse_p, _, _ = in_batch_nll_plain(qm_[sl_], dm_, lab_[sl_], gam)
        dq_p, dd_part = in_batch_loss_grads_plain(
            qm_[sl_], dm_, lab_[sl_], gam, lse_p, gnl[sl_])
        dd_p += dd_part
        errs_l["nll"] = max(errs_l["nll"],
                            float((nll_k[sl_] - nll_p).abs().max()))
        errs_l["dq"] = max(errs_l["dq"], float((dq_k[sl_] - dq_p).abs().max()))
    torch.cuda.synchronize()
    loss_plain_ms = (time.perf_counter() - t0) * 1e3
    errs_l["dd"] = float((dd_k - dd_p).abs().max())
    check(errs_l["nll"] <= 1e-4
          and errs_l["dq"] <= 1e-4 * float(dq_k.abs().max())
          and errs_l["dd"] <= 1e-4 * float(dd_p.abs().max()),
          f"multihost: the loss kernels differ from plain (1e-4; grads 1e-4 "
          f"x max |grad|): {errs_l}")
    loss_flops = 2.0 * bm * bm * tm.semantic_dim
    for name, fn, err in (
            ("in_batch_loss", lambda: in_batch_nll_kernel(qm_, dm_, lab_,
                                                          gam), errs_l["nll"]),
            ("in_batch_loss_dq", lambda: in_batch_loss_dq(
                qm_, dm_, lab_, gam, lse_k, gnl), errs_l["dq"]),
            ("in_batch_loss_dd", lambda: in_batch_loss_dd(
                qm_, dm_, lab_, gam, lse_k, gnl), errs_l["dd"])):
        mh_record(name, err, mh_time(fn, reps=2), loss_plain_ms,
                  (qm_.numel() + dm_.numel()) * 4 + bm * 12,
                  loss_flops * (1 if name == "in_batch_loss" else 2))
    # The tower with residuals, both sides stacked (131,072 rows), on the
    # step's layer-0 activations: y and the residuals against the plain
    # version (bf16 compute: 2e-2, as at `full`).
    cdt = model_base.torch_dtype(tm.compute_dtype)
    sh_ = params_mh["shared"]
    x_m = torch.tanh(torch.cat([lq_mk, ld_mk])[:, :tm.embed_width].to(cdt)
                     + sh_["b0"].to(cdt)).contiguous()
    layers_m = [(sh_[f"W{i}"].to(cdt), sh_[f"b{i}"].to(cdt))
                for i in range(1, len(tm.hidden_dims) + 2)]
    y_k, hs_k = dense_tower_residuals(x_m, layers_m, "tanh", False,
                                      impl="kernel")
    y_p, hs_p = dense_tower_residuals(x_m, layers_m, "tanh", False,
                                      impl="plain")
    err = max(float((a_ - b_).abs().max())
              for a_, b_ in zip([y_k, *hs_k], [y_p, *hs_p]))
    check(err <= 2e-2, f"multihost: dense_tower_residuals differs by {err}")
    tw_dims = [x_m.shape[1]] + [w_.shape[1] for w_, _ in layers_m]
    mh_record("dense_tower_residuals", err,
              mh_time(lambda: dense_tower_residuals(
                  x_m, layers_m, "tanh", False, impl="kernel")),
              mh_time(lambda: dense_tower_residuals(
                  x_m, layers_m, "tanh", False, impl="plain"), reps=1),
              x_m.numel() * 2 + x_m.shape[0] * sum(tw_dims[1:]) * 4 * 2,
              2.0 * x_m.shape[0] * sum(a_ * b_ for a_, b_ in
                                       zip(tw_dims, tw_dims[1:])), "bf16")
    del x_m, y_k, hs_k, y_p, hs_p
    # The scatter-add of the step's compact update.
    vals_m = torch.randn(n_gr, hm, device=dev, generator=gen_) * 1e-3
    tk_, tp_ = table_mh.clone(), table_mh.clone()
    scatter_add_row_groups(tk_, tbm["uniq"], vals_m, group_mh, impl="kernel")
    scatter_add_row_groups_plain(tp_, tbm["uniq"], vals_m, group_mh)
    err = float((tk_ - tp_).abs().max())
    check(err == 0.0, f"multihost: scatter_add_row_groups differs by {err}")
    real_g = int((tbm["uniq"] < tm.vocab_size // group_mh).sum())
    mh_record("scatter_add_row_groups", err,
              mh_time(lambda: scatter_add_row_groups(
                  tk_, tbm["uniq"], vals_m, group_mh, impl="kernel")),
              mh_time(lambda: scatter_add_row_groups_plain(
                  tp_, tbm["uniq"], vals_m, group_mh), reps=1),
              real_g * group_mh * hm * 4 * 3, real_g * group_mh * hm * 1.0)
    del tk_, tp_, dc_k, dc_p, lq_mp, ld_mp, c_mp, g_lqm, g_ldm, dd_p
    print(f"multihost kernels at the step's shapes, kernel vs plain on "
          f"{card}: " + json.dumps(mh_kern))

    # MH_STEPS steps through the kernels, as cli.train runs them.
    mh_path = ("fused_gather_joint_lookup", "joint_lookup_bwd",
               "dense_tower_residuals", "in_batch_loss", "in_batch_loss_dq",
               "in_batch_loss_dd", "scatter_add_row_groups")
    torch.cuda.synchronize()
    resident_mh = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s_mh = create_run_state(cfg_mh, clone_params(params_mh))
    _build.reset_launch_counts()
    s_mh, mh_losses, mh_wall = run_steps(cfg_mh, s_mh, [mh_np] * MH_STEPS,
                                         "auto")
    mh_counts = _build.launch_counts()
    peak_mh = torch.cuda.max_memory_allocated()
    for name, n in mh_counts.items():
        want = MH_STEPS if name in mh_path else 0
        check(n == want, f"multihost step: kernel {name} launched {n} times "
              f"in {MH_STEPS} steps, expected {want}")
    for name in mh_path:
        results[name]["launches_multihost"] = mh_counts[name]
    # Five sgd steps at lr 0.1 on the epoch's one batch overshoot and
    # recover (10.95 -> 8.05 -> 10.62 on an H100); the loss must fall below
    # the first step's.
    check(all(np.isfinite(mh_losses)) and min(mh_losses[1:]) < mh_losses[0],
          f"multihost steps: losses {mh_losses}")
    s_mh, mh_traced = traced_step(
        "multihost step (mp = 1, 65,536 rows)", cfg_mh, s_mh,
        [mh_np] * MH_TRACED,
        # The loss kernel's forward, dq and dd instances (<0>, <1>, <2>).
        ("fused_gather", "bwd_", "in_batch_loss_kernel<0",
         "in_batch_loss_kernel<1", "in_batch_loss_kernel<2",
         "dense_tower", "scatter_add"))
    mh_summary = dict(
        card=card, steps=MH_STEPS, losses=mh_losses,
        steps_per_s=MH_STEPS / mh_wall, wall_ms_per_step=mh_wall * 1e3
        / MH_STEPS, peak_above_resident_gb=(peak_mh - resident_mh) / 1e9,
        peak_gb=peak_mh / 1e9, first_batch_prep_ms=mh_prep_ms,
        cached_batch_ms=mh_cached_ms,
        traced_busy_ms_per_step=mh_traced["device_busy_ms_per_step"],
        traced_wall_ms_per_step=mh_traced["wall_ms_per_step"])
    print("multihost training path, mp = 1: " + json.dumps(mh_summary))

    # The shard-local bodies of the mp = 2 table, both shards here.
    rows_half = tm.vocab_size // 2
    shards = [table_mh[m * rows_half:(m + 1) * rows_half].clone()
              for m in range(2)]
    whole_c = gather_row_groups(table_mh, tbm["uniq"], group_mh)
    check(torch.equal(sum(gather_compact_local(s_, tbm["uniq"], group_mh, m)
                          for m, s_ in enumerate(shards)), whole_c),
          "mp = 2: the shards' gathers summed differ from the gather")
    want_t = scatter_add_row_groups(table_mh.clone(), tbm["uniq"], vals_m,
                                    group_mh)
    check(torch.equal(torch.cat([scatter_add_groups_local(
        s_.clone(), tbm["uniq"], vals_m, group_mh, m)
        for m, s_ in enumerate(shards)]), want_t),
        "mp = 2: the shards' scatter-adds differ from the scatter-add")
    del want_t
    t16 = table_mh.to(torch.bfloat16)
    # The batch's groups as 16-row groups (distinct: set semantics).
    uniq16 = torch.unique(torch.div(tbm["uniq"], 2, rounding_mode="floor")
                          ).to(torch.int32)
    vals16 = vals_m[: uniq16.numel() * 16]
    for m in range(2):
        want_sr = scatter_sr_row_groups(t16.clone(), uniq16, vals16, 16,
                                        7 * 2 + m)
        got_sr = scatter_sr_groups_local(
            t16[m * rows_half:(m + 1) * rows_half].clone(), uniq16, vals16,
            16, 7, m, 2)
        check(torch.equal(got_sr, want_sr[m * rows_half:(m + 1) * rows_half]),
              f"mp = 2: shard {m}'s stochastic-rounding scatter differs")
    del t16, want_sr, got_sr
    raw_q = torch.randint(0, tm.vocab_size, (4096, 32), device=dev,
                          generator=gen_, dtype=torch.int32)
    raw_w = torch.rand(4096, 32, device=dev, generator=gen_)
    bag_gap = float((sum(embedding_bag_local(s_, raw_q, raw_w, m)
                         for m, s_ in enumerate(shards))
                     - embedding_bag(table_mh, raw_q, raw_w)).abs().max())
    check(bag_gap <= 1e-5, f"mp = 2: the shards' bags differ by {bag_gap}")
    del shards, whole_c, vals_m
    print(f"mp = 2 shard-local bodies on the multihost table, both shards on "
          f"this card: gathers summed and scatter-adds bit-equal to the "
          f"unsharded kernels, stochastic-rounding scatters (bf16, seed "
          f"* 2 + shard) bit-equal to the unsharded kernel on each shard's "
          f"rows, bags summed within {bag_gap:.3g} of the bag")
    del s_mh, params_mh, table_mh, tbm, mh_fields, lq_mk, ld_mk, c_mk


    lap("6f")
    # ---- phase 6f: a dssm_tpu workdir on the card ------------------------
    # tests/fixtures/dssm_tpu_workdir, written by dssm_tpu on the CPU
    # (tests/fixtures/make_dssm_tpu_workdir.py): the full preset's widths
    # with the vocabulary cut to 2048 rows, a bf16 table, adam on the dense
    # subtree and the AdaGrad table, 4 steps; beside it what dssm_tpu
    # computed from it. (a) the zstd decoder the reader loads; (b) every
    # leaf the reader returns bit-equal to the stored state; (c) cli.export
    # on a copy of the workdir through the serving kernels, against
    # dssm_tpu's index of the same titles (bf16 compute: 2e-2, the serving
    # tolerance of tests/test_torch_serve.py); (d) cli.eval against
    # dssm_tpu's eval line (each metric within FX_EVAL_TOL) and cli.train
    # --resume for FX_RESUME_STEPS steps from the saved step + 1, its first
    # loss within FX_LOSS_TOL of dssm_tpu's next-step loss; (e) approximate
    # against exact top_k at TOPK_N docs x TOPK_N queries, k = 10. Each
    # command line runs with the counts reset just before and read after.
    import shutil

    from dssm_tpu_torch.cli import eval as cli_eval
    from dssm_tpu_torch.cli import export as cli_export
    from dssm_tpu_torch.cli import train as cli_train
    from dssm_tpu_torch.io import orbax_reader
    from dssm_tpu_torch.serve import load_index
    from dssm_tpu_torch.serve.retrieval import approx_bins

    fx_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "dssm_tpu_workdir")
    with open(os.path.join(fx_root, "reference.json")) as f:
        fx_ref = json.load(f)
    print(f"phase 6f, a dssm_tpu workdir ({fx_root}) on {card}")
    print(f"(a) zstd decoder: {orbax_reader.zstd_library()}")

    def flat_leaves(tree_, path_=""):
        if isinstance(tree_, dict):
            items_ = tree_.items()
        elif isinstance(tree_, list):
            items_ = enumerate(tree_)
        else:
            return {} if tree_ is None else {path_[1:]: tree_}
        out_ = {}
        for k_, v_ in items_:
            out_.update(flat_leaves(v_, f"{path_}/{k_}"))
        return out_

    fx_src = os.path.join(fx_root, "workdir")
    fx_bytes = sum(os.path.getsize(os.path.join(d_, n_))
                   for d_, _, names_ in os.walk(os.path.join(
                       fx_src, "checkpoints")) for n_ in names_)
    read_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fx_step, fx_tree = orbax_reader.read_checkpoint(fx_src)
        read_ms.append((time.perf_counter() - t0) * 1e3)
    fx_got = flat_leaves(fx_tree)
    with np.load(os.path.join(fx_root, "reference.npz")) as z_:
        fx_want = {k_[len("state/"):]: z_[k_] for k_ in z_.files
                   if k_.startswith("state/")}
        fx_index_want = z_["index"]
    check(fx_step == fx_ref["steps"] and sorted(fx_got) == sorted(fx_want),
          f"phase 6f: the reader read step {fx_step} with leaves "
          f"{sorted(fx_got)}, the fixture stores {sorted(fx_want)}")
    for name_, w_ in fx_want.items():
        g_ = fx_got[name_]
        check(g_.dtype == w_.dtype and g_.shape == w_.shape
              and g_.tobytes() == w_.tobytes()
              and (name_ in fx_ref["bfloat16_leaves"])
              == isinstance(g_, orbax_reader.BFloat16Array),
              f"phase 6f: leaf {name_} is not the stored one")
    print(f"(b) read step {fx_step}: {len(fx_got)} leaves, {fx_bytes} bytes "
          f"on disk, bit-equal to the stored state; read ms (3 reads, warm "
          f"file cache) {[round(x_, 2) for x_ in read_ms]} on {card}")

    fx_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_fx_")
    fx_work = os.path.join(fx_dir.name, "workdir")
    shutil.copytree(fx_src, fx_work)
    fx_flags = list(fx_ref["flags"]) + [f"--io.workdir={fx_work}"]

    def fx_cli(main_, argv_):
        out_, err_ = io.StringIO(), io.StringIO()
        _build.reset_launch_counts()
        t0_ = time.perf_counter()
        with contextlib.redirect_stdout(out_), contextlib.redirect_stderr(
                err_):
            main_(argv_)
        torch.cuda.synchronize()
        secs_ = time.perf_counter() - t0_
        counts_ = _build.launch_counts()
        check("from the dssm_tpu (orbax) checkpoint" in err_.getvalue()
              or "(the dssm_tpu (orbax) checkpoint" in err_.getvalue(),
              f"phase 6f: {main_.__module__} did not read the dssm_tpu "
              f"checkpoint: {err_.getvalue()[-2000:]}")
        return out_.getvalue().strip().splitlines(), counts_, secs_

    fx_index = os.path.join(fx_dir.name, "index.npz")
    _, counts_x, secs_x = fx_cli(cli_export.main, fx_flags + [
        f"--data.path={os.path.join(fx_root, 'titles.tsv')}",
        f"--out={fx_index}"])
    for name in ("gather_row_groups", "count_lookup", "dense_tower"):
        check(counts_x[name] > 0, f"phase 6f: cli.export launched no {name}")
    fx_emb, fx_titles = load_index(fx_index)
    check(fx_titles == fx_ref["titles"] and fx_emb.shape
          == fx_index_want.shape, "phase 6f: cli.export indexed "
          f"{len(fx_titles)} titles, dssm_tpu {len(fx_ref['titles'])}")
    export_gap = float(np.abs(fx_emb - fx_index_want).max())
    check(export_gap <= 2e-2, f"phase 6f: cli.export's index is "
          f"{export_gap} from dssm_tpu's (tolerance 2e-2)")
    serving_launches = {k_: counts_x[k_] for k_ in (
        "gather_row_groups", "count_lookup", "dense_tower")}
    print(f"(c) cli.export of {len(fx_titles)} titles from the dssm_tpu "
          f"checkpoint in {secs_x:.2f} s: max |index - dssm_tpu's| "
          f"{export_gap:.3g} (tolerance 2e-2); launches {serving_launches} "
          f"on {card}")

    lines_e, counts_e, secs_e = fx_cli(cli_eval.main, fx_flags)
    fx_eval = json.loads(lines_e[-1])
    fx_eval_ref = fx_ref["eval"]
    eval_gaps = {k_: abs(fx_eval[k_] - fx_eval_ref[k_])
                 for k_ in ("recall@1", "recall@10", "ndcg@10", "mrr")}
    check(counts_e["rank_counts"] > 0 and counts_e["count_lookup"] > 0,
          "phase 6f: cli.eval launched no rank_counts or count_lookup")
    check(fx_eval["step"] == fx_ref["steps"] and fx_eval["num_queries"]
          == fx_eval_ref["num_queries"]
          and max(eval_gaps.values()) <= FX_EVAL_TOL,
          f"phase 6f: cli.eval reports {fx_eval}, dssm_tpu's eval line is "
          f"{fx_eval_ref} (tolerance {FX_EVAL_TOL})")
    print(f"(d) cli.eval of step {fx_eval['step']} in {secs_e:.2f} s: "
          f"{ {k_: fx_eval[k_] for k_ in eval_gaps} }, |gap| to dssm_tpu's "
          f"{eval_gaps} (tolerance {FX_EVAL_TOL}) on {card}")
    resumed_to = fx_ref["steps"] + FX_RESUME_STEPS
    with open(os.path.join(fx_work, "metrics.jsonl")) as f:
        fx_before = len(f.readlines())
    _, counts_t, secs_t = fx_cli(cli_train.main, fx_flags + [
        "--resume", f"--train.max_steps={resumed_to}",
        "--train.log_every=1"])
    with open(os.path.join(fx_work, "metrics.jsonl")) as f:
        fx_records = [json.loads(line) for line in f.readlines()[fx_before:]]
    fx_losses = [(r_["step"], r_["loss"]) for r_ in fx_records
                 if r_["tag"] == "train"]
    loss_gap = abs(fx_losses[0][1] - fx_ref["next_step_loss"])
    check([s_ for s_, _ in fx_losses]
          == list(range(fx_ref["steps"], resumed_to))
          and all(np.isfinite([l_ for _, l_ in fx_losses]))
          and loss_gap <= FX_LOSS_TOL,
          f"phase 6f: cli.train --resume recorded {fx_losses}; dssm_tpu's "
          f"loss of step {fx_ref['steps']} is {fx_ref['next_step_loss']} "
          f"(tolerance {FX_LOSS_TOL})")
    for name in ("fused_gather_joint_lookup", "joint_lookup_bwd",
                 "dense_tower_residuals", "in_batch_loss"):
        check(counts_t[name] >= FX_RESUME_STEPS,
              f"phase 6f: cli.train --resume launched {name} "
              f"{counts_t[name]} times")
    check(counts_t["scatter_sr_row_groups"] + counts_t[
        "scatter_add_row_groups"] >= FX_RESUME_STEPS,
          "phase 6f: cli.train --resume updated no table rows")
    check(orbax_reader.checkpoint_steps(fx_work) == [fx_ref["steps"]]
          and Checkpointer(fx_work).latest_step() == resumed_to,
          "phase 6f: cli.train --resume did not save its own checkpoint "
          "beside dssm_tpu's")
    print(f"(d) cli.train --resume: steps {[s_ for s_, _ in fx_losses]} in "
          f"{secs_t:.2f} s (hashing, 3 steps, final eval, checkpoint), "
          f"losses {[l_ for _, l_ in fx_losses]}; first loss "
          f"{fx_losses[0][1]:.6f} against dssm_tpu's next-step loss "
          f"{fx_ref['next_step_loss']:.6f}: |gap| {loss_gap:.3g} "
          f"(tolerance {FX_LOSS_TOL}) on {card}")
    fx_dir.cleanup()

    # (e) approximate against exact top-k, TOPK_N unit-norm 128-wide docs
    # and as many queries, k = 10; one call each in turns (exact, approx,
    # approx, exact, ...), its results copied back to the host.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d_top = F.normalize(torch.randn(TOPK_N, 128, device=dev, generator=gen),
                        dim=1)
    q_top = F.normalize(torch.randn(TOPK_N, 128, device=dev, generator=gen),
                        dim=1)

    def timed_top_k(exact_):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        s_, i_ = top_k(q_top, d_top, k=10, exact=exact_, device=dev)
        return s_, i_, (time.perf_counter() - t0_) * 1e3

    timed_top_k(True)
    timed_top_k(False)
    topk_ms = {True: [], False: []}
    for exact_ in (True, False, False, True, True, False):
        s_, i_, ms_ = timed_top_k(exact_)
        topk_ms[exact_].append(ms_)
        if exact_:
            s_exact, i_exact = s_, i_
        else:
            s_approx, i_approx = s_, i_
    agree = float(np.mean(
        (i_approx[:, :, None] == i_exact[:, None, :]).any(-1).sum(-1) / 10))
    approx_scores_ok = bool(np.all(np.diff(s_approx, axis=1) <= 0))
    check(approx_scores_ok and agree >= 0.93,
          f"phase 6f: approximate top-10 agrees {agree} with the exact one "
          f"(at least 0.93), rows descending: {approx_scores_ok}")
    print(f"(e) top_k at {TOPK_N} docs x {TOPK_N} queries, k = 10 (chunks "
          f"of 1024 queries, results to the host): exact ms "
          f"{[round(x_, 2) for x_ in topk_ms[True]]}, approximate ms "
          f"{[round(x_, 2) for x_ in topk_ms[False]]} "
          f"({approx_bins(TOPK_N, 10)} bins), mean top-10 id agreement "
          f"{agree:.4f} on {card}")
    del d_top, q_top

    lap("6g")
    # ---- phase 6g: configurations no earlier phase ran -------------------
    # At the presets' widths, from seeded fresh inits: per-side cnn and lstm
    # steps (the count lookup's backward at Wc's 1024 and Win's 384
    # columns); cnn and lstm on bf16 and int8 tables (the stochastic-
    # rounding scatters at those widths; an int8 table's 32-row groups need
    # a vocabulary that is a multiple of 32 and holds the preset's 1024
    # slots of them, so G_INT8_VOCAB rows, hashed anew); the row-wise
    # AdaGrad table with adam on the dense parameters (the dssm_tpu
    # fixture's optimizers and lr) on `full`'s f32 and bf16 tables and
    # cnn's f32 table; momentum on `full` (with the sgd table optimizer,
    # the dense-table step: the table, its d_table and its trace, three
    # [500000, 384] f32 tensors); the rotate loss on `full` (f32, bf16) and
    # cnn, its batches unsorted with each step's rot_offsets, as cli.train
    # makes them. G_STEPS of each through the kernels and the plain
    # versions from one state (compare_training; the counts reset just
    # before the kernel run and read just after, every kernel's launches a
    # step checked); steps/s on batches made ahead and peak memory; then
    # G_TRACED steps of each traced in a process of its own. Also the
    # count lookup backward and the two stochastic-rounding scatters timed
    # at the cnn and lstm widths on those runs' batches, and cli.train
    # --loss.mode=rotate at K_CALL steps a call (blocks stacked inline)
    # against K = 1.
    import pickle

    from dssm_tpu_torch.train.loop import add_rotation_offsets
    from dssm_tpu_torch.train.sparse_update import logical_table_width

    t0_g = time.perf_counter()
    loss3 = {"in_batch_loss": 1, "in_batch_loss_dq": 1, "in_batch_loss_dd": 1}
    fused1 = {"fused_gather_joint_lookup": 1, "joint_lookup_bwd": 1}
    adam_ada = dict(optimizer="adam", table_optimizer="adagrad",
                    learning_rate=G_ADAGRAD_LR)
    seq_int8 = {a: validate(c.replace(tower=c.tower.replace(
        table_dtype="int8", vocab_size=G_INT8_VOCAB)))
        for a, c in seq_cfg.items()}
    seq_train_int8 = hash_pairs(seq_train_p, seq_int8["cnn"].tower, sc.data)
    g_cases = []
    per_side = {"gather_row_groups": 2, "count_lookup": 2,
                "count_lookup_bwd": 2, "scatter_add_row_groups": 2, **loss3}
    for a, c in seq_cfg.items():
        g_cases += [
            (f"{a} per-side", validate(c.replace(tower=c.tower.replace(
                shared_weights=False))), seq_train, per_side),
            (f"{a} bf16 table", validate(c.replace(tower=c.tower.replace(
                table_dtype="bfloat16"))), seq_train,
             {**fused1, "scatter_sr_row_groups": 1, **loss3}),
            (f"{a} int8 table", seq_int8[a], seq_train_int8,
             {"gather_row_groups": 1, "joint_lookup": 1,
              "joint_lookup_bwd": 1, "scatter_sr_int8_row_groups": 1,
              **loss3})]
    # The per-side lstm's first step under f32 compute: the control of its
    # bf16 one (g_first_tol).
    g_cases.append(("lstm per-side, f32 compute", validate(
        seq_cfg["lstm"].replace(tower=seq_cfg["lstm"].tower.replace(
            shared_weights=False, compute_dtype="float32"))), seq_train,
        per_side))
    full_ada = validate(cfg.replace(train=cfg.train.replace(**adam_ada)))
    full_rot = validate(cfg.replace(loss=cfg.loss.replace(mode="rotate")))
    bf16_full = t.replace(table_dtype="bfloat16")
    mlp1 = {**fused1, "dense_tower_residuals": 1}
    g_cases += [
        ("full AdaGrad f32 table, adam", full_ada, hashed_train,
         {**mlp1, "scatter_add_row_groups": 1, **loss3}),
        ("full AdaGrad bf16 table, adam",
         validate(full_ada.replace(tower=bf16_full)), hashed_train,
         {**mlp1, "scatter_sr_row_groups": 1, **loss3}),
        ("cnn AdaGrad f32 table, adam",
         validate(sc.replace(train=sc.train.replace(**adam_ada))), seq_train,
         {**fused1, "scatter_add_row_groups": 1, **loss3}),
        ("full momentum (dense-table step)", validate(cfg.replace(
            data=cfg.data.replace(dedup_lookup=False),
            train=cfg.train.replace(optimizer="momentum"))), hashed_train,
         {"embedding_bag": 2, "dense_tower_residuals": 2, **loss3}),
        ("full rotate loss, f32 table", full_rot, hashed_train,
         {**mlp1, "scatter_add_row_groups": 1}),
        ("full rotate loss, bf16 table",
         validate(full_rot.replace(tower=bf16_full)), hashed_train,
         {**mlp1, "scatter_sr_row_groups": 1}),
        ("cnn rotate loss",
         validate(sc.replace(loss=sc.loss.replace(mode="rotate"))),
         seq_train, {**fused1, "scatter_add_row_groups": 1})]

    def g_group(c):
        return sublane_group(model_base.torch_dtype(
            c.tower.table_dtype_resolved))

    def g_stream(c, hashed_):
        """G_STEPS + G_TRACED + 1 batches of c's stream, as cli.train makes
        them (rotate: rows unsorted, each step's rot_offsets)."""
        seq_, dedup_ = c.tower.is_sequence_model, c.data.dedup_lookup
        flat_ = dedup_ and not seq_
        it_ = batch_iterator(
            hashed_, c.train.batch_size, seq_, seed=c.train.seed,
            dedup_unique=c.data.max_unique if dedup_ else None,
            dedup_group=g_group(c),
            dedup_unique_rows=c.data.max_unique_rows,
            dedup_joint=c.tower.shared_weights, wire_compress=flat_,
            sort_rows=flat_ and c.loss.mode != "rotate")
        return [add_rotation_offsets(next(it_), c, i_)
                for i_ in range(G_STEPS + G_TRACED + 1)]

    # The per-side lstm's towers each take one side's gradient, summed over
    # 16 recurrent bf16 steps whose terms nearly cancel at init (the loss
    # sits at ~6.91): a rounding tipped in the recurrence moves an element
    # of bh's or Wh's first gradient by ~3 of the tensor's bf16 ulps, 0.0114
    # of the largest update on an H100 (doc/bh), 0.0019 under f32 compute
    # (the control case above, held to 1e-2).
    g_first_tol = {"lstm per-side": 2e-2}

    def run_phase_6g():
        """Every configuration kernels against plain; the count backward
        and the SR scatters at the cnn and lstm widths; cli.train with the
        rotate loss at K_CALL against 1. Returns the summaries."""
        g_summary, g_inits, g_first = {}, {}, {}
        for name, c, _, expect in g_cases:
            b_np = g_batches[name]
            init_ = g_init_params(g_inits, c, dev)
            key_ = model_base.TABLE_KEY[c.tower.arch]
            run = compare_training(
                c, init_, b_np[:G_STEPS], f"phase 6g, {name}", expect,
                dedup_group=g_group(c),
                loss_tol=0.1 if c.tower.is_sequence_model else 2e-2,
                first_tol=g_first_tol.get(name, 1e-2))
            check(all(("rot_offsets" in b_) == (c.loss.mode == "rotate")
                      for b_ in b_np), f"phase 6g, {name}: rot_offsets")
            extra = {}
            if c.train.table_optimizer == "adagrad":
                # The accumulator rides in the table's last padding column:
                # it moved on gathered rows only; the dead columns before it
                # stay 0.
                tab_ = run["state"].params["shared"][key_]
                hit_ = touched_rows("shared", init_, b_np[:G_STEPS],
                                    g_group(c), key_)
                acc_moved = tab_[:, -1] != init_["shared"][key_][:, -1]
                dead_ = tab_[:, logical_table_width(c):-1]
                check(bool(acc_moved[hit_].any())
                      and not bool(acc_moved[~hit_].any())
                      and not bool(dead_.float().any()),
                      f"phase 6g, {name}: the AdaGrad accumulator moved on "
                      f"{int(acc_moved[hit_].sum())} gathered and "
                      f"{int(acc_moved[~hit_].sum())} other rows; dead "
                      f"padding columns nonzero: {int((dead_ != 0).sum())}")
                extra = dict(accumulator_rows_moved=int(acc_moved.sum()),
                             accumulator_max=float(tab_[hit_, -1].max()),
                             dead_columns=dead_.shape[1])
            if c.train.optimizer == "momentum":
                trace_ = run["state"].opt_state["trace"]["shared"][key_]
                check(trace_.shape == init_["shared"][key_].shape,
                      f"phase 6g, {name}: no momentum trace over the table")
                extra = dict(table_and_trace_gb=2 * trace_.numel() * 4 / 1e9)
            g_summary[name] = dict(
                card=card, steps=G_STEPS,
                loss=[round(v, 5) for v in run["loss"]],
                step_ms=run["wall_s"] * 1e3 / G_STEPS,
                steps_per_s=G_STEPS / run["wall_s"],
                plain_steps_per_s=G_STEPS / run["plain_wall_s"],
                peak_mem_gb=run["peak"] / 1e9,
                peak_above_resident_gb=(run["peak"] - run["resident"]) / 1e9,
                launches_per_step={k: v // G_STEPS for k, v in
                                   run["counts"].items() if v},
                first_step_grid_gap=run["first_step_grid_gap"],
                first_step_differ_share=run["first_step_differ_share"],
                **gaps(run), **extra)
            print(f"phase 6g, {name}: " + json.dumps(g_summary[name]))
            g_first[name] = b_np[0]
            del run
        del g_inits

        # The count lookup backward (row 3) on the per-side runs' first
        # batch, the doc side, g f32 (the step's), and the two stochastic-
        # rounding scatters (rows 9, 10) on the bf16 / int8 runs' first
        # batch, each at the cnn and lstm widths; kernel against plain (the
        # backward to 1e-5 of its largest element and two calls bit-equal,
        # the scatters bit-equal), bound, library call.
        g_cfg = {name: c for name, c, _, _ in g_cases}
        for a, c in seq_cfg.items():
            hw = -(-logical_table_width(c) // 128) * 128  # the table's width
            tb_ = batch_to_torch(g_first[f"{a} per-side"], dev)
            inv_, wgt_ = tb_["d_inv"].contiguous(), tb_["d_wgt"].contiguous()
            u2_ = tb_["d_sel"].numel()
            valid_ = (inv_ >= 0) & (inv_ < u2_)
            nnz_ = int(((wgt_ != 0) & valid_).sum())
            idx_ = torch.where(valid_, inv_, 0).long().reshape(-1)
            w0_ = torch.where(valid_, wgt_, 0.0)
            g_ = torch.from_numpy(rng.normal(
                size=(*inv_.shape[:-1], hw)).astype(np.float32)).to(dev)
            dk_ = count_lookup_bwd(inv_, wgt_, g_, u2_, impl="kernel")
            dp_ = count_lookup_bwd_plain(inv_, wgt_, g_, u2_)
            err = float((dk_ - dp_).abs().max())
            check(err <= 1e-5 * float(dp_.abs().max()) and torch.equal(
                dk_, count_lookup_bwd(inv_, wgt_, g_, u2_, impl="kernel")),
                f"count_lookup_bwd at the {a} per-side shape: max err "
                f"{err}, or two calls differ")
            b_ms, b_by = bound_ms(inv_.numel() * 8 + g_.numel() * 4
                                  + u2_ * hw * 4, 2.0 * nnz_ * hw, "f32")
            results["count_lookup_bwd"].update({
                f"ms_{a}": graph_ms(lambda: count_lookup_bwd(
                    inv_, wgt_, g_, u2_, impl="kernel")),
                f"plain_ms_{a}": graph_ms(lambda: count_lookup_bwd_plain(
                    inv_, wgt_, g_, u2_)),
                f"library_ms_{a}": graph_ms(lambda: torch.zeros(
                    (u2_, hw), device=dev).index_add_(0, idx_, (
                        w0_[..., None] * g_[..., None, :]).reshape(-1, hw))),
                f"bound_ms_{a}": b_ms, f"bound_by_{a}": b_by,
                f"max_abs_err_{a}": err,
                f"shape_{a}": f"d side inv {tuple(inv_.shape)} -> ({u2_}, "
                              f"{hw}) f32, {nnz_} live lookups"})
            del dk_, dp_, g_
            for tname, sr_name, fn_k, fn_p in (
                    ("bf16", "scatter_sr_row_groups", scatter_sr_row_groups,
                     scatter_sr_row_groups_plain),
                    ("int8", "scatter_sr_int8_row_groups",
                     scatter_sr_int8_row_groups,
                     scatter_sr_int8_row_groups_plain)):
                c_ = g_cfg[f"{a} {tname} table"]
                grp_ = g_group(c_)
                tab_ = g_init_params({}, c_, dev)["shared"][
                    model_base.TABLE_KEY[a]]
                gid_ = batch_to_torch(g_first[f"{a} {tname} table"],
                                      dev)["uniq"]
                shape_ = (gid_.numel() * grp_, hw)
                vals_ = torch.from_numpy((
                    rng.uniform(-3, 3, size=shape_) if tname == "int8"
                    else rng.normal(size=shape_) * 1e-4).astype(
                        np.float32)).to(dev)
                real_ = (gid_ >= 0) & (gid_ < tab_.shape[0] // grp_)
                nreal = int(real_.sum())
                rows_ = (gid_[real_].long()[:, None] * grp_
                         + torch.arange(grp_, device=dev)).reshape(-1)
                sk_ = fn_k(tab_.clone(), gid_, vals_, grp_, 7, impl="kernel")
                check(torch.equal(sk_, fn_p(tab_.clone(), gid_, vals_, grp_,
                                            7)),
                      f"{sr_name} at the {a} width: kernel and plain differ")
                work_ = tab_.clone()
                finished_ = sk_[rows_].clone()
                b_ms, b_by = bound_ms(eval_kernels.scatter_bytes(
                    nreal, gid_.numel(), grp_ * hw, tab_.element_size(), 4),
                    0.0, "f32")
                results[sr_name].update({
                    f"ms_{a}": graph_ms(lambda: fn_k(
                        work_, gid_, vals_, grp_, seed5, impl="kernel")),
                    f"plain_ms_{a}": eager_ms(lambda: fn_p(
                        work_, gid_, vals_, grp_, seed5), reps=2, trials=3),
                    f"library_ms_{a}": graph_ms(lambda: work_.index_copy_(
                        0, rows_, finished_)),
                    f"bound_ms_{a}": b_ms, f"bound_by_{a}": b_by,
                    f"max_abs_err_{a}": 0.0,
                    f"shape_{a}": f"table {tuple(tab_.shape)} {tab_.dtype}, "
                                  f"{gid_.numel()} slots of {grp_} rows, "
                                  f"{nreal} real"})
                del tab_, work_, sk_, vals_, finished_
        print(f"phase 6g kernels at the cnn and lstm widths, on {card}: "
              + json.dumps({n_: {k: v for k, v in results[n_].items()
                                 if k.endswith(("_cnn", "_lstm"))}
                            for n_ in ("count_lookup_bwd",
                                       "scatter_sr_row_groups",
                                       "scatter_sr_int8_row_groups")}))

        # cli.train --loss.mode=rotate at K_CALL steps a call (the blocks
        # stacked inline: their offsets follow the step counter) and at 1
        # from the same fresh init: the same steps, so the same losses and
        # final eval.
        from dssm_tpu_torch.cli import train as cli_train

        rot_eval = {}
        for k_ in (K_CALL, 1):
            cli_dir = tempfile.TemporaryDirectory(
                prefix=f"dssm_smoke_rot{k_}_")
            _build.reset_launch_counts()
            t1 = time.perf_counter()
            cli_train.main([
                "--preset=full", f"--io.workdir={cli_dir.name}",
                f"--data.toy_num_pairs={CLI_PAIRS}", "--loss.mode=rotate",
                f"--train.steps_per_call={k_}",
                f"--train.max_steps={G_CLI_STEPS}", "--train.log_every=1"])
            torch.cuda.synchronize()
            wall_r = time.perf_counter() - t1
            counts_r = _build.launch_counts()
            with open(os.path.join(cli_dir.name, cfg.io.metrics_file)) as f:
                recs_ = [json.loads(line) for line in f]
            for name_, n_ in (("fused_gather_joint_lookup", G_CLI_STEPS),
                              ("joint_lookup_bwd", G_CLI_STEPS),
                              ("scatter_add_row_groups", G_CLI_STEPS),
                              ("in_batch_loss", 0)):
                check(counts_r[name_] == n_, f"cli.train --loss.mode=rotate "
                      f"at K = {k_}: {name_} launched {counts_r[name_]} "
                      f"times, expected {n_}")
            final_ = [r_ for r_ in recs_ if r_["tag"] == "eval_final"][-1]
            rot_eval[k_] = dict(
                final={m_: v_ for m_, v_ in final_.items() if m_ != "time"},
                losses={r_["step"]: r_["loss"] for r_ in recs_
                        if r_["tag"] == "train"}, wall_s=wall_r)
            cli_dir.cleanup()
        same_steps = sorted(set(rot_eval[1]["losses"])
                            & set(rot_eval[K_CALL]["losses"]))
        check(same_steps and all(rot_eval[1]["losses"][s_]
                                 == rot_eval[K_CALL]["losses"][s_]
                                 for s_ in same_steps)
              and rot_eval[1]["final"] == rot_eval[K_CALL]["final"],
              f"cli.train --loss.mode=rotate: K = {K_CALL} and 1 part: "
              f"{json.dumps(rot_eval)}")
        print(f"cli.train --preset=full --loss.mode=rotate, {G_CLI_STEPS} "
              f"steps at K = {K_CALL} and 1 (wall s, hashing and the final "
              f"eval included): {rot_eval[K_CALL]['wall_s']:.1f} / "
              f"{rot_eval[1]['wall_s']:.1f}; losses at steps {same_steps} "
              f"and the final eval equal "
              f"({json.dumps(rot_eval[1]['final'])}) on {card}")
        return g_summary

    g_batches = {name: g_stream(c, hashed_) for name, c, hashed_, _ in
                 g_cases}
    # The traced steps' process starts now: its start-up and inits overlap
    # the comparisons below; it takes its first profiler window only when
    # told to, once this process leaves the card idle (PERF.md: a window
    # late in a long process loses device events). The f32-compute control
    # is not traced.
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump([(name, c, g_batches[name][G_STEPS:], ("eager",))
                     for name, c, _, _ in g_cases
                     if "f32 compute" not in name], f)
    g_trace_file = f.name
    g_trace_err = tempfile.TemporaryFile(mode="w+")
    t_trace = time.perf_counter()
    g_tracer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--trace-steps",
         g_trace_file], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=g_trace_err, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        g_summary = run_phase_6g()
        traced_out, _ = g_tracer.communicate("go\n", timeout=600)
    finally:
        if g_tracer.poll() is None:
            g_tracer.kill()
            g_tracer.communicate()
        os.unlink(g_trace_file)
    g_trace_err.seek(0)
    check(g_tracer.returncode == 0, "phase 6g: the traced steps' process "
          f"failed: {g_trace_err.read()[-3000:]}")
    g_trace_err.close()
    traced_g = {name: tr_["eager"] for name, tr_ in json.loads(
        traced_out.strip().splitlines()[-1]).items()}
    for name, tr_ in traced_g.items():
        g_summary[name].update(tr_)
    print(f"phase 6g, traced ({G_TRACED} steps each after a warm step, one "
          f"process of its own, {time.perf_counter() - t_trace:.1f} s from "
          f"its start, the comparisons above overlapping its start-up) on "
          f"{card}: " + json.dumps(traced_g))
    print(f"phase 6g: {len(g_cases)} configurations in "
          f"{time.perf_counter() - t0_g:.1f} s")
    del g_batches

    lap("6h")
    # ---- phase 6h: the compiled step --------------------------------------
    # On the card make_train_step's step is a captured CUDA graph replayed
    # on the state's own tensors, updated in place (train/compiled.py:
    # dssm_tpu's jitted step with its state donated), and
    # make_multi_train_step's K steps one graph of K bodies (its lax.scan).
    # At the presets' widths, from seeded fresh inits, each configuration
    # below takes len(H_ORDER) compiled steps and the same eager steps (the
    # body run eagerly; kernels on both sides) from one state, in lockstep,
    # calls 2 and 3 on one batch: after every call both states bit-equal
    # (the raw branch and the dense step end in index_add_'s atomics: their
    # updates within H_ATOMICS_TOL of themselves), every kernel's launches
    # in the call equal, the aux of every call intact after the later
    # replays; on a bf16 or int8 table the two replays on one batch equal
    # the eager steps, whose seeds come from their own step numbers (a seed
    # baked into the graph would repeat the captured step's stream). Then
    # steps/s on batches made ahead, compiled and eager in turns (median,
    # min and max of H_REPEATS repeats of H_TIMED steps); the peak memory
    # above resident of the first compiled call (the warm step and the
    # capture: the graph's pool) and of an eager step; and wall, traced busy
    # and CUDA-event ms a step of both in a process of their own. Also
    # K_CALL steps a call (one replay a block) against one, compiled and
    # eager, from one state.
    t0_h = time.perf_counter()
    h_raw = {a: validate(c.replace(data=c.data.replace(dedup_lookup=False)))
             for a, c in seq_cfg.items()}
    h_cases = [  # (name, config, hashed corpus, bit-equal)
        ("full f32 joint", cfg, hashed_train, True),
        ("full bf16 joint", validate(cfg.replace(
            tower=t.replace(table_dtype="bfloat16"))), hashed_train, True),
        ("full int8 joint", validate(cfg.replace(
            tower=t.replace(table_dtype="int8"))), hashed_train, True),
        ("full per-side", validate(cfg.replace(
            tower=t.replace(shared_weights=False))), hashed_train, True),
        ("full AdaGrad table, adam", full_ada, hashed_train, True),
        ("cnn dedupe", sc, seq_train, True),
        ("cnn raw", h_raw["cnn"], seq_train, False),
        ("lstm dedupe", seq_cfg["lstm"], seq_train, True),
        ("lstm raw", h_raw["lstm"], seq_train, False),
        ("dense sgd", cfg_dense, hashed_train, False),
        ("dense adam", cfg_adam, hashed_train, False)]
    h_n = max(H_ORDER) + 1 + H_TIMED + 1 + H_TRACED

    def h_stream(c, hashed_):
        seq_, dedup_ = c.tower.is_sequence_model, c.data.dedup_lookup
        flat_ = dedup_ and not seq_
        it_ = batch_iterator(
            hashed_, c.train.batch_size, seq_, seed=c.train.seed,
            dedup_unique=c.data.max_unique if dedup_ else None,
            dedup_group=g_group(c), dedup_unique_rows=c.data.max_unique_rows,
            dedup_joint=c.tower.shared_weights, wire_compress=flat_,
            sort_rows=flat_)
        return [next(it_) for _ in range(h_n)]

    h_batches = {name: h_stream(c, hashed_) for name, c, hashed_, _ in
                 h_cases}
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump([(name, c, h_batches[name][-(H_TRACED + 1):],
                      ("eager", "compiled")) for name, c, _, _ in h_cases], f)
    h_trace_file = f.name
    h_trace_err = tempfile.TemporaryFile(mode="w+")
    h_tracer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--trace-steps",
         h_trace_file], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=h_trace_err, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))

    def h_leaves(st_):
        """{(tree, name): tensor} of a state: its counters, parameters and
        optimizer trees."""
        out_ = {("step", "step"): st_.step}
        for tw, tp_ in st_.params.items():
            out_.update({(tw, k): v for k, v in tp_.items()})
        for tree_name, tree_ in st_.opt_state.items():
            if tree_name == "count":
                out_[("count", "count")] = tree_
                continue
            for tw, tp_ in tree_.items():
                out_.update({(f"{tree_name}/{tw}", k): v
                             for k, v in tp_.items()})
        return out_

    def state_gap(a_, b_, init_, what_, exact):
        """0.0 where two states are bit-equal; else (a failure where they
        should be, or the counters differ) the largest update_gap of their
        parameters and optimizer trees."""
        la_, lb_ = h_leaves(a_), h_leaves(b_)
        worst_ = 0.0
        for key_, x_ in la_.items():
            y_ = lb_[key_]
            if torch.equal(x_, y_):
                continue
            check(not exact and key_[0] not in ("step", "count"),
                  f"{what_}: compiled and eager differ at {key_}")
            before_ = init_.get(key_[0], {}).get(key_[1],
                                                 torch.zeros_like(y_))
            worst_ = max(worst_, update_gap(x_, y_, before_))
        return worst_

    h_summary, h_inits = {}, {}
    try:
        for name, c, _, exact in h_cases:
            what = f"phase 6h, {name}"
            b_np = h_batches[name]
            init_ = g_init_params(h_inits, c, dev)
            states = {m: create_run_state(c, clone_params(init_))
                      for m in ("compiled", "eager")}
            steps = {"compiled": make_train_step(c),
                     "eager": make_eager_train_step(c)}
            auxes = {m: [] for m in steps}
            worst, peaks = 0.0, {}
            for j_, i_ in enumerate(H_ORDER):
                counts_ = {}
                for m in ("compiled", "eager"):
                    tb_ = (batch_to_device if m == "compiled"
                           else batch_to_torch)(b_np[i_], dev,
                                                vocab_size=c.tower.vocab_size)
                    torch.cuda.synchronize()
                    if j_ == 0:
                        # Cached blocks out: what the first call reserves
                        # is then its working set (compiled: the warm
                        # step's, then the graph's pool, which stays).
                        torch.cuda.empty_cache()
                    resident_ = torch.cuda.memory_allocated()
                    reserved_ = torch.cuda.memory_reserved()
                    torch.cuda.reset_peak_memory_stats()
                    _build.reset_launch_counts()
                    states[m], aux_ = steps[m](states[m], tb_)
                    torch.cuda.synchronize()
                    counts_[m] = {k_: v_ for k_, v_ in
                                  _build.launch_counts().items() if v_}
                    if j_ == 0:
                        peaks[m] = dict(
                            peak_above_resident_gb=(
                                torch.cuda.max_memory_allocated()
                                - resident_) / 1e9,
                            reserved_after_gb=(torch.cuda.memory_reserved()
                                               - reserved_) / 1e9)
                    auxes[m].append(aux_)
                check(counts_["compiled"] == counts_["eager"]
                      and counts_["eager"], f"{what}, call {j_ + 1}: "
                      f"launches {counts_['compiled']} compiled against "
                      f"{counts_['eager']} eager")
                check(int(states["compiled"].step) == j_ + 1
                      == states["compiled"].host_step,
                      f"{what}: step counter after call {j_ + 1}")
                worst = max(worst, state_gap(states["compiled"],
                                             states["eager"], init_, what,
                                             exact))
            check(steps["compiled"].num_graphs == 1,
                  f"{what}: {steps['compiled'].num_graphs} graphs captured")
            aux_gap = max(abs(float(a_[k_]) - float(e_[k_]))
                          for a_, e_ in zip(auxes["compiled"], auxes["eager"])
                          for k_ in e_)
            check((aux_gap == 0.0) if exact else worst <= H_ATOMICS_TOL,
                  f"{what}: compiled and eager part: aux {aux_gap}, "
                  f"updates {worst} of themselves apart")
            # Steps/s on batches made ahead, compiled and eager in turns.
            timed_np = b_np[max(H_ORDER) + 1:max(H_ORDER) + 1 + H_TIMED]
            made = {"compiled": [batch_to_device(b_, dev).to_device()
                                 for b_ in timed_np],
                    "eager": [batch_to_torch(b_, dev) for b_ in timed_np]}
            rates = {m: [] for m in made}
            for _ in range(H_REPEATS):
                for m in ("compiled", "eager"):
                    torch.cuda.synchronize()
                    t1_ = time.perf_counter()
                    for tb_ in made[m]:
                        states[m], aux_ = steps[m](states[m], tb_)
                    float(aux_["loss"])  # the last step's loss, read
                    torch.cuda.synchronize()
                    rates[m].append(len(timed_np)
                                    / (time.perf_counter() - t1_))
            check(steps["compiled"].num_graphs == 1,
                  f"{what}: a timed batch was captured anew")
            h_summary[name] = dict(
                card=card, calls=len(H_ORDER),
                compared="bit-equal" if exact else dict(
                    update_gap=worst, aux_gap=aux_gap),
                launches_per_step=counts_["compiled"],
                steps_per_s={m: dict(median=statistics.median(r_),
                                     min=min(r_), max=max(r_))
                             for m, r_ in rates.items()},
                first_call_memory=peaks)
            print(f"{what}: " + json.dumps(h_summary[name]))
            del states, steps, made, auxes

        # K_CALL steps a call against one, compiled and eager, from one
        # state: bit-equal; steps/s of each on blocks made ahead.
        c = cfg
        b_np = h_batches["full f32 joint"][:2 * K_CALL]
        init_ = g_init_params(h_inits, c, dev)
        ends, k_rates = {}, {}
        for what_k, fn_, k_ in (
                ("compiled K=1", make_train_step(c), 1),
                (f"compiled K={K_CALL}", make_multi_train_step(c), K_CALL),
                (f"eager K={K_CALL}", make_eager_train_step(c, multi=True),
                 K_CALL)):
            st_ = create_run_state(c, clone_params(init_))
            units_ = ([batch_to_device(b_, dev) for b_ in b_np] if k_ == 1
                      else [batch_to_device(stack_batches(
                          b_np[i_:i_ + k_]), dev)
                          for i_ in range(0, len(b_np), k_)])
            _build.reset_launch_counts()
            for u_ in units_:
                st_, aux_ = fn_(st_, u_)
            counts_ = {k2: v2 for k2, v2 in _build.launch_counts().items()
                       if v2}
            check(counts_ == {k2: len(b_np) for k2 in joint_kernels},
                  f"K steps a call, {what_k}: launches {counts_}")
            ends[what_k] = {k2: v2.clone() for k2, v2 in h_leaves(st_).items()}
            units_ = [u_.to_device() for u_ in units_]  # made ahead
            r_ = []
            for _ in range(H_REPEATS):
                torch.cuda.synchronize()
                t1_ = time.perf_counter()
                for _ in range(H_TIMED // len(b_np)):
                    for u_ in units_:
                        st_, aux_ = fn_(st_, u_)
                float(aux_["loss"][-1] if k_ > 1 else aux_["loss"])
                torch.cuda.synchronize()
                r_.append(len(b_np) * (H_TIMED // len(b_np))
                          / (time.perf_counter() - t1_))
            k_rates[what_k] = dict(median=statistics.median(r_), min=min(r_),
                                   max=max(r_))
        for what_k, leaves_ in ends.items():
            for key_, v_ in leaves_.items():
                check(torch.equal(v_, ends["compiled K=1"][key_]),
                      f"phase 6h, {what_k} against compiled K=1, "
                      f"{len(b_np)} steps from one state: {key_} differs "
                      "(bit-equal expected)")
        h_summary[f"K={K_CALL} against K=1"] = dict(
            card=card, steps=len(b_np), compared="bit-equal",
            steps_per_s=k_rates)
        print(f"phase 6h, {K_CALL} steps a call against 1, full f32 joint, "
              f"{len(b_np)} steps from one state: bit-equal; steps/s on "
              f"blocks made ahead: {json.dumps(k_rates)} on {card}")
        del ends, h_inits
        torch.cuda.synchronize()
        traced_out, _ = h_tracer.communicate("go\n", timeout=600)
    finally:
        if h_tracer.poll() is None:
            h_tracer.kill()
            h_tracer.communicate()
        os.unlink(h_trace_file)
    h_trace_err.seek(0)
    check(h_tracer.returncode == 0, "phase 6h: the traced steps' process "
          f"failed: {h_trace_err.read()[-3000:]}")
    h_trace_err.close()
    traced_h = json.loads(traced_out.strip().splitlines()[-1])
    for name, tr_ in traced_h.items():
        h_summary[name]["traced"] = tr_
    print(f"phase 6h, traced ({H_TRACED} steps of each mode after a warm "
          f"step, one process of its own) on {card}: "
          + json.dumps(traced_h))
    print(f"phase 6h: {len(h_cases)} configurations in "
          f"{time.perf_counter() - t0_h:.1f} s")
    del h_batches

    lap("6i")
    # ---- phase 6i: eval's and serving's dispatch --------------------------
    # On the card an eval pass is one replay a K-batch block of the stacked
    # forward's CUDA graph (train/eval.py::EMBED_STACKED, dssm_tpu's jitted
    # lax.scan) over the blocks EvalCache keeps on the card, and one replay
    # of the rank graph (RANK); serving embeds a batch a replay (EMBED) and
    # runs every top-k chunk in one graph (serve/retrieval.py::TOPK). Here,
    # at the presets' widths from seeded fresh inits: compiled against
    # eager from one state (embeddings and ranks bit-equal, metrics equal,
    # launches equal), for `full` at the held-out split (K = 4) and at
    # I_PAIRS pairs (K = 64), then cnn and lstm on their dedupe and raw
    # branches; first and cached pass seconds, peak and pool GB; one graph
    # over in-place training steps, one more for new parameter tensors;
    # traced busy ms in a process of its own; the index of I_PAIRS titles,
    # the I_QUERIES-query latency and top_k at I_PAIRS x I_PAIRS, exact and
    # approximate.
    from dssm_tpu_torch.serve import retrieval as serve_mod

    t0_i = time.perf_counter()
    i_fwds = {"embed": eval_mod.EMBED, "embed_stacked": eval_mod.EMBED_STACKED,
              "rank": eval_mod.RANK, "top_k": serve_mod.TOPK}

    def i_drop_graphs():
        for f_ in i_fwds.values():
            f_.clear()

    def i_tally():
        return {n_: (f_.captures, f_.replays) for n_, f_ in i_fwds.items()}

    def i_moved(before_):
        """{forward: [captures, replays]} since the tally `before_`."""
        return {n_: [c_ - before_[n_][0], r_ - before_[n_][1]]
                for n_, (c_, r_) in i_tally().items()
                if (c_, r_) != before_[n_]}

    pairs_i = make_toy_pairs(I_PAIRS, cfg.data.toy_vocab_words,
                             cfg.data.seed)
    hashed_i = hash_pairs(pairs_i, t, cfg.data)
    i_corpora = [("held-out split", hashed_eval), (f"{I_PAIRS} pairs",
                                                   hashed_i)]
    # cnn and lstm share vocab and data layout: one corpus serves both.
    seq_big = hash_pairs(make_toy_pairs(I_SEQ_PAIRS, sc.data.toy_vocab_words,
                                        sc.data.seed), sc.tower, sc.data)
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump([(f"full, {n_}", cfg, h_) for n_, h_ in i_corpora]
                    + [(f"{a_}, {I_SEQ_PAIRS} pairs", c_, seq_big)
                       for a_, c_ in seq_cfg.items()], f)
    i_trace_file = f.name
    i_trace_err = tempfile.TemporaryFile(mode="w+")
    i_tracer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--trace-evals",
         i_trace_file], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=i_trace_err, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))

    def i_pass(params_, c_, hashed_, eager_, cache_=True):
        """One timed evaluate: (metrics, stats, wall s, launches)."""
        stats_ = {}
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t1_ = time.perf_counter()
        m_ = eval_mod.evaluate(params_, c_, hashed_, c_.train.batch_size,
                               cache=cache_, stats=stats_, eager=eager_)
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t1_
        return m_, stats_, wall_, {k_: v_ for k_, v_ in
                                   _build.launch_counts().items() if v_}

    def i_compare(what_, params_, c_, hashed_):
        """Compiled against eager from one state on one corpus: the first
        pass (filling the cache; compiled: the captures) and I_REPEATS
        cached passes of each mode in turns, then the embeddings and ranks
        of both; returns the summary."""
        bs_ = c_.train.batch_size
        k_ = eval_mod._k_block(len(hashed_), bs_)
        blocks_ = -(-len(hashed_) // (bs_ * k_))
        per_mode, embs = {}, {}
        for mode_ in ("compiled", "eager"):
            eval_mod._EVAL_CACHES.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            resident_ = torch.cuda.memory_allocated()
            reserved_ = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            tally_ = i_tally()
            m_, first_, wall_, _ = i_pass(params_, c_, hashed_,
                                          mode_ == "eager")
            per_mode[mode_] = dict(
                metrics=m_, first_pass=dict(wall_s=wall_, **first_),
                first_pass_graphs=i_moved(tally_),
                peak_above_resident_gb=(torch.cuda.max_memory_allocated()
                                        - resident_) / 1e9,
                reserved_after_gb=(torch.cuda.memory_reserved()
                                   - reserved_) / 1e9,
                pools_gb={n_: i_fwds[n_].pool_bytes / 1e9
                          for n_ in ("embed_stacked", "rank")},
                static_buffers_gb={n_: i_fwds[n_].buffer_bytes / 1e9
                                   for n_ in ("embed_stacked", "rank")},
                cached_s=[], launches=None)
        for _ in range(I_REPEATS):
            for mode_ in ("compiled", "eager"):
                tally_ = i_tally()
                m_, hot_, wall_, counts_ = i_pass(params_, c_, hashed_,
                                                  mode_ == "eager")
                r_ = per_mode[mode_]
                check(m_ == r_["metrics"] and hot_["cache_hit"] == 1.0,
                      f"{what_}, {mode_}: a cached pass gave {m_}, the "
                      f"first {r_['metrics']}")
                r_["cached_s"].append(dict(wall_s=wall_, **hot_))
                r_["launches"] = counts_
                if mode_ == "compiled":
                    check(i_moved(tally_) == {
                        "embed_stacked": [0, blocks_], "rank": [0, 1]},
                        f"{what_}: a cached compiled pass made "
                        f"{i_moved(tally_)} captures / replays, expected "
                        f"{blocks_} replays of one graph and 1 rank replay")
        check(per_mode["compiled"]["launches"]
              == per_mode["eager"]["launches"],
              f"{what_}: launches a pass {per_mode['compiled']['launches']} "
              f"compiled, {per_mode['eager']['launches']} eager")
        check(per_mode["compiled"]["metrics"] == per_mode["eager"]["metrics"],
              f"{what_}: metrics {per_mode['compiled']['metrics']} compiled, "
              f"{per_mode['eager']['metrics']} eager")
        for mode_ in ("compiled", "eager"):
            q_, d_ = eval_mod.embed_corpus(params_, c_, hashed_, bs_,
                                           cache=True, eager=mode_ == "eager")
            embs[mode_] = (q_, d_, eval_mod.compute_ranks(
                q_, d_, eager=mode_ == "eager"))
        (qc_, dc_, rc_), (qe_, de_, re_) = embs["compiled"], embs["eager"]
        emb_gap = max(float((qc_ - qe_).abs().max()),
                      float((dc_ - de_).abs().max()))
        check(emb_gap == 0.0 and np.array_equal(rc_, re_),
              f"{what_}: compiled and eager embeddings {emb_gap} apart, "
              f"{int((rc_ != re_).sum())} ranks differ (bit-equal expected)")
        for mode_, r_ in per_mode.items():
            r_["cached_s"] = dict(
                median_wall_s=statistics.median(x_["wall_s"]
                                                for x_ in r_["cached_s"]),
                min_wall_s=min(x_["wall_s"] for x_ in r_["cached_s"]),
                last=r_["cached_s"][-1])
        eval_mod._EVAL_CACHES.clear()
        return dict(card=card, pairs=len(hashed_), batch=bs_, k_block=k_,
                    blocks=blocks_, compared="bit-equal", **per_mode)

    i_summary = {}
    try:
        # `full`, f32 table: a state from the seeded fresh init, moved by
        # I_STEPS compiled steps first.
        i_drop_graphs()
        state_i = create_run_state(cfg, model_base.init_params(
            t, seed=cfg.train.seed, device=dev))
        step_i = make_train_step(cfg)
        i_train = h_stream(cfg, hashed_train)[:2 * I_STEPS]
        for b_ in i_train[:I_STEPS]:
            state_i, _ = step_i(state_i, batch_to_device(
                b_, dev, vocab_size=t.vocab_size))
        # The traced process's own passes are done before any time here.
        check(i_tracer.stdout.readline().strip() == "ready",
              "phase 6i: the traced evals' process did not start")
        def i_dedupe_launches(what_, tower_kernels_):
            """A dedupe pass's launches: per body and side the gather, the
            count lookup and the tower's kernels; the rank count once."""
            bodies_ = i_summary[what_]["k_block"] * i_summary[what_]["blocks"]
            want_ = {"rank_counts": 1, **{
                k_: 2 * bodies_ for k_ in ("gather_row_groups",
                                           "count_lookup") + tower_kernels_}}
            check(i_summary[what_]["eager"]["launches"] == want_,
                  f"{what_}: launches a pass "
                  f"{i_summary[what_]['eager']['launches']}, expected {want_}")

        for cname_, hashed_ in i_corpora:
            what = f"phase 6i, full eval, {cname_}"
            i_summary[what] = i_compare(what, state_i.params, cfg, hashed_)
            i_dedupe_launches(what, ("dense_tower",))
            print(f"{what}: " + json.dumps(i_summary[what]))
        # One graph over in-place steps; new parameter tensors capture once.
        graphs_ = (eval_mod.EMBED_STACKED.num_graphs,
                   eval_mod.RANK.num_graphs)
        tally_ = i_tally()
        for b_ in i_train[I_STEPS:]:
            state_i, _ = step_i(state_i, batch_to_device(
                b_, dev, vocab_size=t.vocab_size))
            m_c = eval_mod.evaluate(state_i.params, cfg, hashed_eval,
                                    cfg.train.batch_size)
            m_e = eval_mod.evaluate(state_i.params, cfg, hashed_eval,
                                    cfg.train.batch_size, eager=True)
            check(m_c == m_e, f"phase 6i: after an in-place step the "
                  f"compiled eval gave {m_c}, the eager {m_e}")
        moved_ = i_moved(tally_)
        check((eval_mod.EMBED_STACKED.num_graphs, eval_mod.RANK.num_graphs)
              == graphs_ and moved_ == {"embed_stacked": [0, I_STEPS],
                                        "rank": [0, I_STEPS]},
              f"phase 6i: {I_STEPS} evals between in-place steps made "
              f"{moved_} captures / replays (none captured expected)")
        copy_i = clone_params(state_i.params)
        tally_ = i_tally()
        check(eval_mod.evaluate(copy_i, cfg, hashed_eval,
                                cfg.train.batch_size) == m_c
              and i_moved(tally_) == {"embed_stacked": [1, 0],
                                      "rank": [0, 1]},
              f"phase 6i: new parameter tensors made {i_moved(tally_)} "
              "captures / replays (one new forward graph expected)")
        print(f"phase 6i: {I_STEPS} evals between in-place compiled steps "
              f"replayed the forward and rank graphs (captures / replays "
              f"{moved_}); a copy of the parameters captured once more; "
              f"graphs held {eval_mod.EMBED_STACKED.num_graphs} forward, "
              f"{eval_mod.RANK.num_graphs} rank on {card}")
        del copy_i

        # cnn and lstm on their dedupe and raw branches.
        for arch_, c_ in seq_cfg.items():
            for branch_, cb_ in (("dedupe", c_), ("raw", h_raw[arch_])):
                what = f"phase 6i, {arch_} eval, {branch_} branch"
                params_s = model_base.init_params(cb_.tower,
                                                  seed=cb_.train.seed,
                                                  device=dev)
                i_summary[what] = i_compare(what, params_s, cb_, seq_eval)
                print(f"{what}: " + json.dumps(i_summary[what]))
                del params_s
        # and on the dedupe branch at I_SEQ_PAIRS pairs: K = 64, two
        # blocks, the second padded
        for arch_, c_ in seq_cfg.items():
            what = f"phase 6i, {arch_} eval, {I_SEQ_PAIRS} pairs"
            params_s = model_base.init_params(c_.tower, seed=c_.train.seed,
                                              device=dev)
            i_summary[what] = i_compare(what, params_s, c_, seq_big)
            check(i_summary[what]["k_block"] == 64
                  and i_summary[what]["blocks"] == 2,
                  f"{what}: K = {i_summary[what]['k_block']}, "
                  f"{i_summary[what]['blocks']} blocks (64, 2 expected)")
            i_dedupe_launches(what, ())
            print(f"{what}: " + json.dumps(i_summary[what]))
            del params_s

        # Serving, `full` f32 model: an index of I_PAIRS titles and the
        # embeddings of I_PAIRS queries, compiled (after a first call that
        # captures) against eager; the I_QUERIES-query latency (embed and
        # top-10 against the index on the card), median of I_QUERY_REPS,
        # modes in turns; top_k at I_PAIRS x I_PAIRS.
        params_v = state_i.params
        titles_i, queries_i = list(pairs_i.titles), list(pairs_i.queries)
        bs = cfg.train.batch_size
        serve_s, embs_v = {}, {}
        for mode_ in ("compiled", "eager", "compiled"):
            eager_ = mode_ == "eager"
            tally_ = i_tally()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d_v = build_doc_index(params_v, cfg, titles_i, bs, eager=eager_)
            t2 = time.perf_counter()
            q_v = embed_queries(params_v, cfg, queries_i, bs, eager=eager_)
            t3 = time.perf_counter()
            serve_s.setdefault(mode_, []).append(dict(
                index_s=t2 - t1, index_titles_per_s=len(titles_i) / (t2 - t1),
                queries_s=t3 - t2, graphs=i_moved(tally_)))
            embs_v[mode_] = (d_v, q_v)
        check(all(np.array_equal(embs_v["compiled"][j_], embs_v["eager"][j_])
                  for j_ in (0, 1)),
              "phase 6i: compiled and eager serving embeddings differ "
              "(bit-equal expected)")
        d_v, q_v = embs_v["compiled"]
        d_dev = torch.from_numpy(d_v).to(dev)
        lat = {"compiled": [], "eager": []}
        for _ in range(I_QUERY_REPS):
            for mode_ in ("compiled", "eager"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                q64 = embed_queries(params_v, cfg, queries_i[:I_QUERIES], bs,
                                    eager=mode_ == "eager")
                s64, i64 = top_k(q64, d_dev, k=10, eager=mode_ == "eager")
                lat[mode_].append((time.perf_counter() - t1) * 1e3)
        check(i64.shape == (I_QUERIES, 10), "phase 6i: 64-query top-10")
        topk_i = {}
        for exact_ in (True, False):
            route_ = "exact" if exact_ else "approximate"
            tally_ = i_tally()
            res_, ms_ = {}, {"compiled": [], "eager": []}
            for rep_ in range(I_TOPK_REPS + 1):  # the first compiled: capture
                for mode_ in ("compiled", "eager"):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    res_[mode_] = top_k(q_v, d_dev, k=10, exact=exact_,
                                        eager=mode_ == "eager")
                    if rep_:
                        ms_[mode_].append((time.perf_counter() - t1) * 1e3)
            check(np.array_equal(res_["compiled"][1], res_["eager"][1])
                  and np.array_equal(res_["compiled"][0], res_["eager"][0]),
                  f"phase 6i: top_k {route_} at {I_PAIRS}^2: compiled and "
                  "eager ids / scores differ (bit-equal expected)")
            check(i_moved(tally_) == {"top_k": [1, I_TOPK_REPS]},
                  f"phase 6i: top_k {route_}: {i_moved(tally_)} captures / "
                  "replays")
            topk_i[route_] = dict(
                ms={m_: dict(median=statistics.median(v_), min=min(v_),
                             max=max(v_)) for m_, v_ in ms_.items()},
                pool_gb=serve_mod.TOPK.pool_bytes / 1e9,
                static_buffers_gb=serve_mod.TOPK.buffer_bytes / 1e9,
                score_block_gb=1024 * I_PAIRS * 4 / 1e9)
        i_summary["serving"] = dict(
            card=card, titles=len(titles_i), queries=len(queries_i),
            passes=serve_s, compared="bit-equal",
            query_latency_ms={m_: dict(median=statistics.median(v_),
                                       min=min(v_), max=max(v_),
                                       n=len(v_)) for m_, v_ in lat.items()},
            top_k=topk_i)
        print(f"phase 6i, serving: " + json.dumps(i_summary["serving"]))
        del state_i, step_i, params_v, d_dev, embs_v, d_v, q_v
        torch.cuda.synchronize()
        traced_out, _ = i_tracer.communicate("go\n", timeout=600)
    finally:
        if i_tracer.poll() is None:
            i_tracer.kill()
            i_tracer.communicate()
        os.unlink(i_trace_file)
    i_trace_err.seek(0)
    check(i_tracer.returncode == 0, "phase 6i: the traced evals' process "
          f"failed: {i_trace_err.read()[-3000:]}")
    i_trace_err.close()
    traced_i = json.loads(traced_out.strip().splitlines()[-1])
    print(f"phase 6i, traced (one cached pass of each mode, one process of "
          f"its own) on {card}: " + json.dumps(traced_i))
    # The CLIs below reach these graphs: phase 7 checks their captures and
    # replays.
    i_drop_graphs()
    eval_mod._EVAL_CACHES.clear()
    print(f"phase 6i: {len(i_summary)} runs in "
          f"{time.perf_counter() - t0_i:.1f} s")
    del pairs_i, hashed_i, i_corpora, seq_big

    lap("6j")
    # ---- phase 6j: the parallel steps compiled -----------------------------
    # On the card make_parallel_train_step's step is a captured CUDA graph
    # with its NCCL collectives inside, replayed on the state's own tensors
    # (parallel/, train/compiled.py: dssm_tpu's jitted, donated parallel
    # step), make_parallel_multi_step's K steps one graph of K bodies. The
    # card forms only an NCCL group of one (NCCL refuses two ranks on one
    # GPU), whose data and model groups are real process groups: the
    # sparse step's graph holds the g_basis all-reduce and the dense
    # gradients' all-reduce. On it, from seeded fresh inits: the multihost
    # preset at model_parallel = 1 on its bf16 wire, `full` f32 joint, and
    # the dense-table step with sgd and adam take the calls of H_ORDER
    # compiled and eager (the parallel body run eagerly) from one state in
    # lockstep, and, on an f32 wire, the single-device compiled step too:
    # after every call the states bit-equal (the dense step's index_add_
    # atomics: within H_ATOMICS_TOL of its update) and the launches equal.
    # Then K_CALL steps a call (the second block a replay) against K = 1;
    # steps/s compiled and eager in turns (median, min, max of H_REPEATS);
    # the first compiled call's peak above resident and its pool. One
    # replay of each is traced in a process of its own, with the NCCL
    # kernels it holds as the trace names them. At the end, cli.train
    # --preset=full under DSSM_COORDINATOR / DSSM_NUM_PROCS=1 /
    # DSSM_PROC_ID=0 at K = 1 and K_CALL against the single-process run:
    # the same records.
    from dssm_tpu_torch.parallel import dist as pdist
    from dssm_tpu_torch.parallel.mesh import make_mesh
    from dssm_tpu_torch.parallel.train_step import (
        create_sharded_state, make_eager_parallel_train_step,
        make_parallel_multi_step, make_parallel_train_step)
    from dssm_tpu_torch.train.compiled import state_tensors

    t0_j = time.perf_counter()
    nccl_v = torch.cuda.nccl.version()
    nccl_version = (".".join(map(str, nccl_v)) if isinstance(nccl_v, tuple)
                    else str(nccl_v))
    cfg_mhw = validate(cfg_mh.replace(mesh=cfg_mh.mesh.replace(
        collective_dtype="float32")))
    full_np_j = h_stream(cfg, hashed_train)
    dense_np_j = h_stream(cfg_dense, hashed_train)
    j_cases = [  # (name, config, batches, bit-equal, steps a timed repeat)
        ("multihost bf16 wire", cfg_mh, [mh_np] * 3, True, J_MH_TIMED),
        ("multihost f32 wire", cfg_mhw, [mh_np] * 3, True, 0),
        ("full f32 joint", cfg, full_np_j, True, J_TIMED),
        ("dense sgd", cfg_dense, dense_np_j, False, J_TIMED),
        ("dense adam", cfg_adam, dense_np_j, False, J_TIMED)]
    j_tmp = tempfile.TemporaryDirectory(prefix="dssm_smoke_nccl_")
    with open(os.path.join(j_tmp.name, "cases.pkl"), "wb") as f:
        pickle.dump([(name, c, (b_np * 3)[:3]) for name, c, b_np, _, _ in
                     j_cases if name != "multihost f32 wire"], f)
    j_trace_err = tempfile.TemporaryFile(mode="w+")
    j_tracer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--trace-parallel",
         os.path.join(j_tmp.name, "cases.pkl")], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=j_trace_err, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))

    def j_tracer_failed(what_):
        j_trace_err.seek(0)
        return (f"phase 6j: the traced replays' process {what_}: "
                f"{j_trace_err.read()[-3000:]}")
    pdist.initialize(f"file://{j_tmp.name}/init", 1, 0)
    j_summary, j_inits = {}, {}
    try:
        mesh_j = make_mesh(cfg.mesh, dev)
        check(mesh_j.groups["data"] is not None
              and torch.distributed.get_backend() == "nccl",
              "phase 6j: no NCCL group of one")
        for name, c, b_np, exact, timed in j_cases:
            what = f"phase 6j, {name}"
            init_ = g_init_params(j_inits, c, dev)
            steps = {"compiled": make_parallel_train_step(c, mesh_j)}
            if timed:
                steps["eager"] = make_eager_parallel_train_step(c, mesh_j)
            if c.mesh.collective_dtype == "float32":
                steps["single"] = make_train_step(c)
            states = {m: create_run_state(c, clone_params(init_))
                      if m == "single" else
                      create_sharded_state(c, mesh_j, clone_params(init_))
                      for m in steps}
            where = {m: [t_.data_ptr() for t_ in state_tensors(s_)]
                     for m, s_ in states.items()}
            order = H_ORDER if timed else (0, 1, 2)
            worst, peaks, auxes = 0.0, {}, {m: [] for m in steps}
            launches = {}
            for j_, i_ in enumerate(order):
                counts_ = {}
                for m in steps:
                    tb_ = (batch_to_torch if m == "eager" else
                           batch_to_device)(b_np[i_ % len(b_np)], dev,
                                            vocab_size=c.tower.vocab_size)
                    torch.cuda.synchronize()
                    if j_ == 0:
                        torch.cuda.empty_cache()
                    resident_ = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    _build.reset_launch_counts()
                    states[m], aux_ = steps[m](states[m], tb_)
                    torch.cuda.synchronize()
                    counts_[m] = {k_: v_ for k_, v_ in
                                  _build.launch_counts().items() if v_}
                    if j_ == 0:
                        peaks[m] = dict(peak_above_resident_gb=(
                            torch.cuda.max_memory_allocated()
                            - resident_) / 1e9)
                    auxes[m].append(aux_)
                # (the single-device joint step fuses the gather into its
                # lookup, the parallel one gathers first: other launches)
                check(counts_["compiled"] and counts_.get(
                    "eager", counts_["compiled"]) == counts_["compiled"],
                    f"{what}, call {j_ + 1}: launches {counts_}")
                for m in steps:
                    worst = max(worst, state_gap(states["compiled"],
                                                 states[m], init_,
                                                 f"{what} against {m}",
                                                 exact))
                check(int(states["compiled"].step) == j_ + 1
                      == states["compiled"].host_step,
                      f"{what}: step counter after call {j_ + 1}")
                for n_, v_ in counts_["compiled"].items():
                    launches[n_] = launches.get(n_, 0) + v_
            check(steps["compiled"].num_graphs == 1,
                  f"{what}: {steps['compiled'].num_graphs} graphs captured")
            for m, s_ in states.items():
                check([t_.data_ptr() for t_ in state_tensors(s_)] == where[m],
                      f"{what}: the {m} step put new tensors into the state")
            aux_gap = max(abs(float(a_[k_]) - float(e_[k_]))
                          for m in steps for a_, e_ in
                          zip(auxes["compiled"], auxes[m]) for k_ in e_)
            check((aux_gap == 0.0) if exact else worst <= H_ATOMICS_TOL,
                  f"{what}: compiled and eager / single-device part: aux "
                  f"{aux_gap}, updates {worst} of themselves apart")
            peaks["compiled"]["pool_gb"] = steps["compiled"].pool_bytes / 1e9
            for n_, v_ in launches.items():
                results[n_].setdefault("launches_parallel", {})[name] = v_
            j_summary[name] = dict(
                card=card, nccl=nccl_version, calls=len(order),
                against=[m for m in steps if m != "compiled"],
                compared="bit-equal" if exact else dict(
                    update_gap=worst, aux_gap=aux_gap),
                launches_per_call=counts_["compiled"],
                first_call_memory=peaks)
            if timed:
                # K_CALL steps a call (two blocks: the second a replay)
                # against K = 1, compiled, from one state.
                k_np = [b_np[i_ % len(b_np)] for i_ in range(2 * K_CALL)]
                ends = {}
                for k_ in (1, K_CALL):
                    fn_ = (make_parallel_train_step(c, mesh_j) if k_ == 1
                           else make_parallel_multi_step(c, mesh_j))
                    st_ = create_sharded_state(c, mesh_j, clone_params(init_))
                    units_ = ([batch_to_device(b_, dev) for b_ in k_np]
                              if k_ == 1 else
                              [batch_to_device(stack_batches(
                                  k_np[i_:i_ + K_CALL]), dev)
                               for i_ in (0, K_CALL)])
                    for u_ in units_:
                        _build.reset_launch_counts()
                        st_, aux_ = fn_(st_, u_)
                    torch.cuda.synchronize()
                    # The last call a replay: its launches k_ steps'.
                    check(fn_.num_graphs == 1 and {
                        k2: v2 for k2, v2 in _build.launch_counts().items()
                        if v2} == {k2: v2 * k_ for k2, v2 in
                                   counts_["compiled"].items()}
                        and int(st_.step) == 2 * K_CALL,
                        f"{what}, K={k_}: {fn_.num_graphs} graphs, launches "
                        f"{_build.launch_counts()} in the last call")
                    ends[k_] = st_
                    del fn_
                k_gap = state_gap(ends[K_CALL], ends[1], init_,
                                  f"{what}, K={K_CALL} against K=1", exact)
                check(k_gap <= H_ATOMICS_TOL, f"{what}: K={K_CALL} against "
                      f"K=1: updates {k_gap} of themselves apart")
                del ends
                # Steps/s on batches made ahead, compiled and eager in
                # turns.
                t_np = [b_np[i_ % len(b_np)] for i_ in range(timed)]
                made = {"compiled": [batch_to_device(b_, dev).to_device()
                                     for b_ in t_np],
                        "eager": [batch_to_torch(b_, dev) for b_ in t_np]}
                if name == "multihost bf16 wire":
                    # The tracer's captures are done before any timing.
                    check(j_tracer.stdout.readline().strip() == "ready",
                          j_tracer_failed("did not start"))
                rates = {m: [] for m in made}
                for _ in range(H_REPEATS):
                    for m in ("compiled", "eager"):
                        torch.cuda.synchronize()
                        t1_ = time.perf_counter()
                        for tb_ in made[m]:
                            states[m], aux_ = steps[m](states[m], tb_)
                        float(aux_["loss"])
                        torch.cuda.synchronize()
                        rates[m].append(timed / (time.perf_counter() - t1_))
                check(steps["compiled"].num_graphs == 1,
                      f"{what}: a timed batch was captured anew")
                j_summary[name].update(
                    k_call=dict(k=K_CALL, steps=2 * K_CALL,
                                compared=("bit-equal" if exact else
                                          dict(update_gap=k_gap))),
                    steps_per_s={m: dict(median=statistics.median(r_),
                                         min=min(r_), max=max(r_))
                                 for m, r_ in rates.items()})
                del made
            print(f"{what}: " + json.dumps(j_summary[name]))
            del steps, states, auxes
        del j_inits
    finally:
        pdist.shutdown()
    torch.cuda.synchronize()
    try:
        traced_out, _ = j_tracer.communicate("go\n", timeout=600)
    finally:
        if j_tracer.poll() is None:
            j_tracer.kill()
            j_tracer.communicate()
    check(j_tracer.returncode == 0, j_tracer_failed("failed"))
    j_trace_err.close()
    traced_j = json.loads(traced_out.strip().splitlines()[-1])
    for name, tr_ in traced_j.items():
        check(tr_["graphs"] == 1, f"phase 6j, traced {name}: "
              f"{tr_['graphs']} graphs")
        j_summary[name]["traced"] = tr_
    print(f"phase 6j, traced (one replay each after a capture and a "
          f"replay, one process of its own, NCCL {nccl_version}) on {card}: "
          + json.dumps(traced_j))

    # cli.train --preset=full under DSSM_* (a world-1 NCCL group, the
    # compiled parallel step on wire blocks) and in one process, at K = 1
    # and K_CALL: the same records (the timing keys aside).
    from dssm_tpu_torch.cli import train as cli_train_j

    def j_values(r_):
        """A record's values but its clock and durations."""
        return {q: v for q, v in r_.items()
                if q != "time" and not q.endswith(("_s", "_ms", "_sec"))}

    j_cli = {}
    for k_ in (1, K_CALL):
        recs_ = {}
        for how in ("one process", "world 1"):
            work_ = tempfile.mkdtemp(prefix="dssm_smoke_j_cli_",
                                     dir=j_tmp.name)
            env_ = ({"DSSM_COORDINATOR": f"file://{work_}/init",
                     "DSSM_NUM_PROCS": "1", "DSSM_PROC_ID": "0"}
                    if how == "world 1" else {})
            os.environ.update(env_)
            try:
                cli_train_j.main([
                    "--preset=full", f"--io.workdir={work_}",
                    f"--data.toy_num_pairs={CLI_PAIRS}",
                    f"--train.max_steps={J_CLI_STEPS}",
                    "--train.log_every=1", "--train.eval_every=12",
                    f"--train.steps_per_call={k_}"])
            finally:
                for v_ in env_:
                    os.environ.pop(v_)
            check(not torch.distributed.is_initialized(),
                  f"cli.train {how}: the process group outlived the run")
            with open(os.path.join(work_, cfg.io.metrics_file)) as f:
                recs_[how] = [json.loads(line) for line in f]
        one_, w1_ = recs_["one process"], recs_["world 1"]
        check([(r_["tag"], r_["step"]) for r_ in w1_]
              == [(r_["tag"], r_["step"]) for r_ in one_]
              and all(j_values(a_) == j_values(b_)
                      for a_, b_ in zip(w1_, one_)),
              f"cli.train at K={k_}: the world-1 records differ from the "
              f"one-process run's: {w1_} against {one_}")
        j_cli[f"K={k_}"] = {
            how: dict(records=len(r_), steps_per_s=statistics.median(
                [x["steps_per_sec"] for x in r_
                 if x["tag"] == "train"][1:]))
            for how, r_ in recs_.items()}
    j_summary["cli.train"] = j_cli
    print(f"phase 6j, cli.train --preset=full, {J_CLI_STEPS} steps, world-1 "
          f"NCCL against one process: the same records; steps/s (median of "
          f"the train records after the first) {json.dumps(j_cli)} on {card}")
    j_tmp.cleanup()
    print(f"phase 6j: {len(j_cases)} configurations in "
          f"{time.perf_counter() - t0_j:.1f} s")

    lap("7")
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
        tally_ = i_tally()
        with contextlib.redirect_stdout(out_):
            cli_export.main(flags + [f"--out={cli_index}"])
            cli_export.main(flags + [f"--index={cli_index}",
                                     f"--query={cli_query}", "--k=5"])
        built_, answer_ = (json.loads(line)
                           for line in out_.getvalue().splitlines())
        check(built_["indexed_docs"] > 0 and built_["dim"] == t.semantic_dim,
              f"cli.export index: {built_}")
        # Phase 6i's graphs: the index a graph replay a batch but its
        # first, the query one more call, its top-5 one graph.
        moved_ = i_moved(tally_)
        index_b_ = -(-built_["indexed_docs"] // cfg.train.batch_size)
        check(sum(moved_.get("embed", ())) == index_b_ + 1
              and moved_["embed"][1] >= index_b_ - 1
              and sum(moved_.get("top_k", ())) == 1
              and set(moved_) == {"embed", "top_k"},
              f"cli.export: captures / replays {moved_} of the forward "
              f"graphs ({index_b_} index batches and one query)")
        print(f"cli.export: forward graphs' captures / replays {moved_}")
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
    tally_cli = i_tally()
    cli_train.main(cli_flags + [f"--train.max_steps={CLI_LOWPREC_STEPS}",
                                "--train.log_every=2",
                                "--train.eval_every=3"])
    torch.cuda.synchronize()
    cli_counts = _build.launch_counts()
    # Its two evals (step 3, the end) on the state updated in place: one
    # forward graph, captured at the first and replayed at the second.
    moved_cli = i_moved(tally_cli)
    check(moved_cli.get("embed_stacked") == [1, 1]
          and sum(moved_cli.get("rank", ())) == 2,
          f"cli.train (bf16 table): its evals made {moved_cli} captures / "
          "replays of the eval graphs ([1, 1] expected)")
    print(f"cli.train (bf16 table), periodic and final eval: eval graphs' "
          f"captures / replays {moved_cli}")
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
    tally_cli = i_tally()
    with contextlib.redirect_stdout(out_eval):
        cli_eval.main(cli_flags)
    moved_cli = i_moved(tally_cli)
    check(sum(moved_cli.get("embed_stacked", ())) == 1
          and sum(moved_cli.get("rank", ())) == 1,
          f"cli.eval: {moved_cli} captures / replays of the eval graphs "
          "(one block and one rank pass expected)")
    print(f"cli.eval: eval graphs' captures / replays {moved_cli}")
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

    # cli.train and cli.eval on a corpus file: toy pairs written as TSV by
    # write_tsv (the toy corpus's pairs, so the same split), the full preset
    # at pool widths 0 and 8 and once with the epoch batch cache, and the
    # cnn preset at 0 and 8; steps/s from the metrics.jsonl records after
    # the first two log intervals (the first holds the warm-up).
    corpus_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_corpus_")
    tsv = {"full": os.path.join(corpus_dir.name, "full.tsv"),
           "cnn": os.path.join(corpus_dir.name, "cnn.tsv")}
    write_tsv(make_toy_pairs(CLI_PAIRS, cfg.data.toy_vocab_words,
                             cfg.data.seed), tsv["full"])
    write_tsv(seq_pairs, tsv["cnn"])
    n_eval_cnn = -(-len(seq_eval) // seq_cfg["cnn"].train.batch_size)
    pool8 = ["--data.pipeline_workers=8"]
    cached = pool8 + ["--data.reshuffle_each_epoch=False",
                      "--data.cache_epoch_batches=True"]
    file_runs = []
    for preset, steps, every, extra in (
            ("full", FILE_STEPS, FILE_LOG_EVERY, []),
            ("full", FILE_STEPS, FILE_LOG_EVERY, pool8),
            ("full", FILE_STEPS, FILE_LOG_EVERY, cached),
            ("cnn", SEQ_FILE_STEPS, SEQ_FILE_LOG_EVERY, []),
            ("cnn", SEQ_FILE_STEPS, SEQ_FILE_LOG_EVERY, pool8)):
        cli_dir = tempfile.TemporaryDirectory(prefix=f"dssm_smoke_{preset}_")
        cli_flags = [f"--preset={preset}", f"--io.workdir={cli_dir.name}",
                     f"--data.path={tsv[preset]}", *extra]
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        cli_train.main(cli_flags + [f"--train.max_steps={steps}",
                                    f"--train.log_every={every}",
                                    "--train.eval_every=0"])
        torch.cuda.synchronize()
        cli_counts = _build.launch_counts()
        t1 = time.perf_counter()
        if preset == "full":
            want = cli_expected(steps, 1, "scatter_add_row_groups")
            want_pairs = cli_eval_pairs
        else:
            want = {k: steps for k in seq_joint_kernels}
            want.update(gather_row_groups=2 * n_eval_cnn,
                        count_lookup=2 * n_eval_cnn, rank_counts=1)
            want_pairs = len(seq_eval)
        for name, n in cli_counts.items():
            check(n == want.get(name, 0), f"cli.train --preset={preset} on "
                  f"a corpus file {extra}: kernel {name} launched {n} times, "
                  f"expected {want.get(name, 0)}")
        records = cli_records(cli_dir.name)
        rates = [r["steps_per_sec"] for r in records
                 if r["tag"] == "train" and r["step"] > every]
        losses = [r["loss"] for r in records if r["tag"] == "train"]
        final = records[-1]
        check(len(losses) == -(-steps // every) and all(np.isfinite(losses))
              and final["tag"] == "eval_final"
              and final["num_queries"] == want_pairs
              and 0 < final["recall@1"] <= 1,
              f"cli.train --preset={preset} on a corpus file {extra}: "
              f"records {records}")
        # Steps every + 1 .. steps are timed; with the epoch cache one from
        # the second epoch on replays a cached batch.
        n_pairs = CLI_PAIRS if preset == "full" else len(seq_pairs.queries)
        bpe = (n_pairs - want_pairs) // (
            cfg if preset == "full" else seq_cfg["cnn"]).train.batch_size
        hits = (sum(s_ > bpe for s_ in range(every + 1, steps + 1))
                / (steps - every)) if extra == cached else 0.0
        run_ = dict(preset=preset, flags=extra, steps=steps,
                    batches_per_epoch=bpe, cache_hit_share_timed=hits,
                    steps_per_s=statistics.median(rates),
                    steps_per_s_by_interval=rates,
                    loss_first_last=[losses[0], losses[-1]],
                    final_recall_at_1=final["recall@1"],
                    cli_train_s=t1 - t0)
        if extra == pool8:
            out_eval = io.StringIO()
            with contextlib.redirect_stdout(out_eval):
                cli_eval.main(cli_flags)
            reported = json.loads(out_eval.getvalue().strip().splitlines()[-1])
            check(reported["step"] == steps and all(
                reported[k] == final[k] for k in ("recall@1", "ndcg@10",
                                                  "mrr", "num_queries")),
                f"cli.eval --preset={preset} on a corpus file reports "
                f"{reported}, the run's final eval was {final}")
            run_["cli_eval_matches_final_eval"] = True
        file_runs.append(run_)
        cli_dir.cleanup()
    corpus_dir.cleanup()
    print(f"cli.train on a corpus file (on {card}): " + json.dumps(file_runs))

    # K steps a call and the dense-table step through cli.train: the full
    # preset at --train.steps_per_call=K_CALL over CLI_K_STEPS steps (5
    # blocks and a tail of 2), its records, evals and checkpoints on the
    # steps dssm_tpu's rule gives (a block's last step, where step % every
    # < K); the same flags at K = 1 beside it; then --train.optimizer=adam
    # (the dense-table step on raw batches) for CLI_ADAM_STEPS steps and
    # cli.eval on its workdir.
    def block_rule(max_steps, k_, log_every, eval_every, ckpt_every):
        """dssm_tpu/cli/train.py's record steps at k_ steps a call: (train
        records, evals, checkpoints, the final one included)."""
        step_, stride_ = 0, k_
        logs_, evals_, ckpts_ = [], [], []
        while step_ < max_steps:
            if k_ > 1 and max_steps - step_ >= k_:
                step_ += k_ - 1
            if step_ % log_every < stride_:
                logs_.append(step_)
            if eval_every and step_ and step_ % eval_every < stride_:
                evals_.append(step_)
            if ckpt_every and step_ and step_ % ckpt_every < stride_:
                ckpts_.append(step_)
            step_ += 1
        return logs_, evals_, ckpts_ + [max_steps]

    saved_steps = []
    checkpoint_save = Checkpointer.save

    def recording_save(self, step_, state_, mesh_=None):
        saved_steps.append(step_)
        return checkpoint_save(self, step_, state_, mesh_)

    k_runs = {}
    Checkpointer.save = recording_save
    try:
        for k_ in (K_CALL, 1):
            cli_dir = tempfile.TemporaryDirectory(prefix=f"dssm_smoke_k{k_}_")
            k_flags = ["--preset=full", f"--io.workdir={cli_dir.name}",
                       f"--data.toy_num_pairs={CLI_PAIRS}",
                       f"--train.steps_per_call={k_}", "--train.log_every=5",
                       "--train.eval_every=10", "--train.checkpoint_every=10",
                       f"--train.max_steps={CLI_K_STEPS}"]
            saved_steps.clear()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            cli_train.main(k_flags)
            torch.cuda.synchronize()
            wall_k = time.perf_counter() - t0
            counts_k = _build.launch_counts()
            logs_, evals_, ckpts_ = block_rule(CLI_K_STEPS, k_, 5, 10, 10)
            records = cli_records(cli_dir.name)
            got_ = ([r["step"] for r in records if r["tag"] == "train"],
                    [r["step"] for r in records if r["tag"] == "eval"],
                    list(saved_steps))
            check(got_ == (logs_, evals_, ckpts_) and records[-1]["tag"]
                  == "eval_final" and records[-1]["step"] == CLI_K_STEPS,
                  f"cli.train at K = {k_}: train / eval / checkpoint steps "
                  f"{got_}, dssm_tpu's rule gives {(logs_, evals_, ckpts_)}")
            for name, n in cli_expected(CLI_K_STEPS, len(evals_) + 1,
                                        "scatter_add_row_groups").items():
                check(counts_k[name] == n, f"cli.train at K = {k_}: kernel "
                      f"{name} launched {counts_k[name]} times, expected {n}")
            check(Checkpointer(cli_dir.name).latest_step() == CLI_K_STEPS,
                  f"cli.train at K = {k_}: no checkpoint of its last step")
            k_runs[k_] = dict(
                train_steps=logs_, eval_steps=evals_, checkpoint_steps=ckpts_,
                losses=[r["loss"] for r in records if r["tag"] == "train"],
                steps_per_sec_records=[r["steps_per_sec"] for r in records
                                       if r["tag"] == "train"],
                wall_s_hashing_and_evals_included=wall_k)
            cli_dir.cleanup()
    finally:
        Checkpointer.save = checkpoint_save
    print(f"cli.train --preset=full, {CLI_K_STEPS} steps at K = {K_CALL} "
          f"and 1 (records and checkpoints on dssm_tpu's steps; steps/s "
          f"between records, evals and checkpoints included; on {card}): "
          + json.dumps(k_runs))

    cli_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_adam_")
    adam_flags = ["--preset=full", f"--io.workdir={cli_dir.name}",
                  f"--data.toy_num_pairs={CLI_PAIRS}",
                  "--train.optimizer=adam", f"--train.learning_rate={ADAM_LR}"]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cli_train.main(adam_flags + [f"--train.max_steps={CLI_ADAM_STEPS}",
                                 "--train.log_every=1",
                                 "--train.eval_every=0"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts_a = _build.launch_counts()
    for name, n in dense_kernels.items():
        check(counts_a[name] == n * CLI_ADAM_STEPS, f"cli.train (adam): "
              f"kernel {name} launched {counts_a[name]} times, expected "
              f"{n * CLI_ADAM_STEPS}")
    for name in ("scatter_add_row_groups", "fused_gather_joint_lookup",
                 "joint_lookup_bwd", "embedding_bag_bwd"):
        check(counts_a[name] == 0,
              f"cli.train (adam) launched {name} (the dense step has none)")
    records = cli_records(cli_dir.name)
    adam_cli_losses = [r["loss"] for r in records if r["tag"] == "train"]
    check(len(adam_cli_losses) == CLI_ADAM_STEPS
          and all(np.isfinite(adam_cli_losses)),
          f"cli.train (adam): records {records}")
    state_a = Checkpointer(cli_dir.name).restore(device=dev)
    check(state_a.step == CLI_ADAM_STEPS
          and state_a.opt_state["count"] == CLI_ADAM_STEPS
          and state_a.opt_state["nu"]["shared"]["W0"].shape
          == state_a.params["shared"]["W0"].shape,
          "cli.train (adam): the checkpoint holds no moments over the table")
    del state_a
    final = records[-1]
    out_eval = io.StringIO()
    with contextlib.redirect_stdout(out_eval):
        cli_eval.main(adam_flags)
    reported = json.loads(out_eval.getvalue().strip().splitlines()[-1])
    check(reported["step"] == CLI_ADAM_STEPS and all(
        reported[k] == final[k] for k in ("recall@1", "ndcg@10", "mrr",
                                          "num_queries")),
        f"cli.eval after cli.train (adam) reports {reported}, the run's "
        f"final eval was {final}")
    print(f"cli.train --preset=full --train.optimizer=adam (lr {ADAM_LR}): "
          f"{CLI_ADAM_STEPS} steps in {t1 - t0:.1f} s (hashing and the final "
          f"eval and checkpoint of the table and its moments included), "
          f"losses {adam_cli_losses}; cli.eval restored step "
          f"{reported['step']} and reported the run's final eval "
          f"(recall@1 {reported['recall@1']:.4f}) on {card}")
    cli_dir.cleanup()

    # cli.train --preset=multihost --mesh.model_parallel=1: the preset's
    # corpus, remap, 65,536-row batches with their slot spaces (the epoch
    # cache, 8 pipeline threads), MH_CLI_STEPS steps, its checkpoint and
    # final eval (13,107 pairs); then cli.eval on its workdir.
    mh_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_mh_")
    mh_flags = ["--preset=multihost", "--mesh.model_parallel=1",
                f"--io.workdir={mh_dir.name}"]
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    cli_train.main(mh_flags + [f"--train.max_steps={MH_CLI_STEPS}",
                               "--train.log_every=1"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts_mh = _build.launch_counts()
    for name in mh_path:
        check(counts_mh[name] == MH_CLI_STEPS, f"cli.train (multihost): "
              f"kernel {name} launched {counts_mh[name]} times, expected "
              f"{MH_CLI_STEPS}")
    for name in ("gather_row_groups", "count_lookup", "dense_tower",
                 "rank_counts"):
        check(counts_mh[name] > 0, f"cli.train (multihost): its final eval "
              f"launched no {name}")
    records = cli_records(mh_dir.name)
    mh_cli_losses = [r["loss"] for r in records if r["tag"] == "train"]
    mh_cli_rates = [r["steps_per_sec"] for r in records
                    if r["tag"] == "train"]
    final = records[-1]
    check(len(mh_cli_losses) == MH_CLI_STEPS
          and all(np.isfinite(mh_cli_losses))
          and final["tag"] == "eval_final" and 0 < final["recall@1"] <= 1,
          f"cli.train (multihost): records {records}")
    check(Checkpointer(mh_dir.name).latest_step() == MH_CLI_STEPS,
          "cli.train (multihost) wrote no checkpoint of its last step")
    out_eval = io.StringIO()
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(out_eval):
        cli_eval.main(mh_flags)
    t3 = time.perf_counter()
    reported = json.loads(out_eval.getvalue().strip().splitlines()[-1])
    check(reported["step"] == MH_CLI_STEPS and all(
        reported[k] == final[k] for k in ("recall@1", "ndcg@10", "mrr",
                                          "num_queries")),
        f"cli.eval after cli.train (multihost) reports {reported}, the "
        f"run's final eval was {final}")
    print(f"cli.train --preset=multihost --mesh.model_parallel=1: "
          f"{MH_CLI_STEPS} steps of {cfg_mh.train.batch_size} rows in "
          f"{t1 - t0:.1f} s (hashing {dm.toy_num_pairs} pairs, the remap, "
          f"the first batch, the checkpoint and the final eval of "
          f"{final['num_queries']} pairs included), losses {mh_cli_losses}, "
          f"steps/s between records {mh_cli_rates[1:]}; cli.eval restored "
          f"step {reported['step']} in {t3 - t2:.1f} s and reported the "
          f"run's final eval (recall@1 {reported['recall@1']:.4f}) on {card}")
    mh_dir.cleanup()

    lap("7b")
    # ---- phase 7b: the tooling -------------------------------------------
    # (a) cli.train --preset=full with the profiler hook and TensorBoard,
    # TOOL_STEPS steps on CLI_PAIRS toy pairs, an eval every TOOL_EVAL
    # steps, in a process of its own: its trace of steps 5 to 10 must hold
    # the card's kernels (the fused gather + joint lookup and the loss
    # kernels once a step or more), its event files the train, eval and
    # weights tags. (b) weight_summaries on the trained `full` f32 model of
    # phase 5 (the records cli.train writes at an eval), timed, without and
    # with a histogram. (c) tools/profile_components.py: the joint step's
    # stage times on an f32 and on a bf16 table, each in a process of its
    # own (torch.profiler loses a window's device events in a number that
    # grows with the time since the process's first window).
    from dssm_tpu_torch.io.metrics import weight_summaries
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    tool_dir = tempfile.TemporaryDirectory(prefix="dssm_smoke_tool_")
    prof_dir = os.path.join(tool_dir.name, "prof")
    tool_work = os.path.join(tool_dir.name, "run")
    t0 = time.perf_counter()
    run_ = subprocess.run(
        [sys.executable, "-m", "dssm_tpu_torch.cli.train", "--preset=full",
         f"--io.workdir={tool_work}", f"--data.toy_num_pairs={CLI_PAIRS}",
         f"--train.max_steps={TOOL_STEPS}", "--train.log_every=2",
         f"--train.eval_every={TOOL_EVAL}", "--io.tensorboard=true",
         f"--io.profile_dir={prof_dir}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t0
    check(run_.returncode == 0 and f"profile written to {prof_dir}"
          in run_.stderr, f"cli.train with the profiler hook: exit "
          f"{run_.returncode}, stderr {run_.stderr[-3000:]}")
    traces = [f_ for f_ in os.listdir(prof_dir)
              if f_.startswith("rank0.") and f_.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"cli.train's profile dir holds {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        trace_events = json.load(f)["traceEvents"]
    kernel_events = [e_ for e_ in trace_events if e_.get("cat") == "kernel"]
    traced_kernels = {}
    for e_ in kernel_events:
        k_ = e_["name"].replace("(anonymous namespace)::", "")
        k_ = k_.removeprefix("void ").split("(")[0].split("<")[0]
        n_, us_ = traced_kernels.get(k_, (0, 0.0))
        traced_kernels[k_] = (n_ + 1, us_ + float(e_.get("dur", 0.0)))
    fused_n = traced_kernels.get("fused_gather_joint_kernel", (0, 0.0))[0]
    loss_n = traced_kernels.get("in_batch_loss_kernel", (0, 0.0))[0]
    check(fused_n >= 5 and loss_n >= 5,
          f"cli.train's trace holds {fused_n} fused gather + joint lookup "
          f"and {loss_n} loss kernel launches (5 steps traced): "
          f"{sorted(traced_kernels.items(), key=lambda kv: -kv[1][1])[:12]}")
    busy_us = sum(us_ for _, us_ in traced_kernels.values())
    tb_tags = {}
    for tag_ in sorted(os.listdir(os.path.join(tool_work, "tb"))):
        acc_ = EventAccumulator(os.path.join(tool_work, "tb", tag_))
        acc_.Reload()
        tb_tags[tag_] = len(acc_.Tags()["scalars"])
    check(all(tb_tags.get(t_, 0) > 0 for t_ in ("train", "eval", "weights")),
          f"cli.train's TensorBoard event files hold {tb_tags}")
    with open(os.path.join(tool_work, cfg.io.metrics_file)) as f:
        tool_records = [json.loads(line) for line in f]
    weight_steps = [r_["step"] for r_ in tool_records
                    if r_["tag"] == "weights"]
    check(weight_steps == list(range(TOOL_EVAL, TOOL_STEPS, TOOL_EVAL)),
          f"cli.train wrote weights records at steps {weight_steps}")
    print(f"cli.train --preset=full --io.profile_dir --io.tensorboard=true "
          f"--train.eval_every={TOOL_EVAL}: {TOOL_STEPS} steps in "
          f"{tool_s:.1f} s (its own process: start-up, hashing, evals and "
          f"checkpoint included); trace {traces[0]}: {len(trace_events)} "
          f"events, {len(kernel_events)} kernel launches, fused gather + "
          f"joint lookup {fused_n}, loss kernels {loss_n}, device busy "
          f"{busy_us / 1e3:.3f} ms in the window (steps 5-9 and the eval "
          f"at {TOOL_EVAL}); TensorBoard scalars a tag {tb_tags}; weights "
          f"records at steps {weight_steps} on {card}")
    top_traced = sorted(traced_kernels.items(), key=lambda kv: -kv[1][1])
    print("traced kernels of cli.train's window (launches, us): "
          + json.dumps(top_traced[:12]))
    tool_dir.cleanup()

    for bins_, reps_ in ((0, 3), (32, 1)):
        wsum_ms = []
        for _ in range(reps_):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = weight_summaries(params, bins_)
            wsum_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(v_) for v_ in summary.values()
                  if not isinstance(v_, list)),
              f"weight_summaries: {summary}")
        print(f"weights record (weight_summaries, {bins_} histogram bins) of "
              f"the trained full model ({len(summary)} keys, the f32 table "
              f"{tuple(params['shared']['W0'].shape)}): ms "
              f"{[round(x_, 2) for x_ in wsum_ms]} on {card}")

    for table_ in ("f32", "bf16"):
        t0 = time.perf_counter()
        run_ = subprocess.run(
            [sys.executable, "-m", "dssm_tpu_torch.tools.profile_components",
             table_, "--iters=20", "--traced=5"],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        check(run_.returncode == 0, f"tools/profile_components.py {table_}: "
              f"exit {run_.returncode}, stderr {run_.stderr[-3000:]}")
        stage_lines = [l_ for l_ in run_.stdout.splitlines()
                       if l_.startswith(f"[{table_}]") and "us/iter" in l_]
        check(len(stage_lines) == 12
              and all("us busy" in l_ for l_ in stage_lines),
              f"tools/profile_components.py {table_} printed:\n"
              + run_.stdout[-4000:])
        print(f"tools/profile_components.py {table_} "
              f"({time.perf_counter() - t0:.1f} s, its own process):")
        print(run_.stdout.strip())

    lap("8")
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
        row.update({k: v for k, v in r.items() if k.startswith("ms_")
                    or k.endswith("_multihost") or k == "launches_parallel"})
        kernels.append(row)
    print("phase start seconds: " + json.dumps(laps))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-steps"]:
        sys.exit(trace_steps(sys.argv[2]))
    if sys.argv[1:2] == ["--trace-evals"]:
        sys.exit(trace_evals(sys.argv[2]))
    if sys.argv[1:2] == ["--trace-parallel"]:
        sys.exit(trace_parallel(sys.argv[2]))
    sys.exit(main())
