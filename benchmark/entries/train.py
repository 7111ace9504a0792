"""Training traffic: the loader's stream (data/loader.batch_iterator with
cli.train's arguments; behind data/loader.prefetch, as cli.train wraps it,
when the traffic's `prefetch` depth is above 0) feeding the compiled step
(train/loop.make_train_step), one step a batch, the way train/loop.train
drives it, with cli.train's bound on steps in flight.

train.loop.train makes a new compiled step on every call, whose first call
captures its CUDA graph; a window of fixed length cannot call it without
capturing inside the window. So the harness makes the step once and runs
train()'s loop body: next(), add_rotation_offsets, batch_to_device, the
step (a CPU test holds the two to the same calls).

Set-up runs the first epoch, which fills the loader's epoch cache and
captures the step's graph, and the first `check_steps` steps of the
second, which the cache serves as every step of the window is served.
The reference follows the first `check_steps` steps from the same
weights: their losses, the first gradient (from the state after the
first step) and the change after them are compared. Over a whole epoch
of SGD the two trajectories part (the reference in a lower precision
parts from itself as far), so the reference follows the second epoch's
first steps from the program's state at the epoch's end, and their
losses are compared. The window then runs whole steps until --seconds have
passed, and closes on a value read of the last loss and of a table
element. train_pairs_per_s = pairs trained / the window's seconds.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict

from benchmark import gen, trace as btrace
from benchmark.core import Spans, Stretch, tower_of
from benchmark.entries import common
from benchmark.work import counts


def run(cell, cfg, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> common.Outcome:
    import torch
    from torch.profiler import record_function

    from dssm_tpu_torch.bridge import batch_to_device
    from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs, prefetch
    from dssm_tpu_torch.data.remap import apply_remap, build_freq_remap
    from dssm_tpu_torch.data.toy import ToyPairs
    from dssm_tpu_torch.kernels.gather import sublane_group
    from dssm_tpu_torch.train.loop import add_rotation_offsets, make_train_step
    from dssm_tpu_torch.train.sparse_update import uses_sparse_update
    from dssm_tpu_torch.train.state import create_run_state

    tr = cell.traffic
    tower = tower_of(cfg)
    cuda = device.type == "cuda"
    mark = common.Phases(t_start)
    mark("imports")
    queries, titles = common.train_corpus(cell, cfg, seed)
    mark("corpus")
    hashed = hash_pairs(ToyPairs(queries=queries, titles=titles), cfg.tower,
                        cfg.data)
    if cfg.data.freq_remap:
        hashed = apply_remap(hashed, build_freq_remap(
            hashed, cfg.tower.vocab_size,
            num_shards=cfg.mesh.model_parallel))
    mark("hashed")
    params = common.program_params(cfg, tower, seed, device)
    state = create_run_state(cfg, params)
    table = params["shared"]["W0"]
    b = cfg.train.batch_size
    epoch = len(hashed) // b
    n_check = tr["check_steps"]
    if epoch < n_check:
        raise ValueError(f"an epoch of {epoch} batches; the check follows "
                         f"{n_check} steps on distinct rows")
    dedup = cfg.data.dedup_lookup and uses_sparse_update(cfg)
    joint = cfg.tower.shared_weights
    loader_seed = gen.torch_seed(seed, common.LOADER) % 2**32
    stream = batch_iterator(
        hashed, b, False, seed=loader_seed,
        dedup_unique=cfg.data.max_unique if dedup else None,
        dedup_group=sublane_group(table.dtype),
        dedup_unique_rows=cfg.data.max_unique_rows,
        dedup_joint=joint,
        wire_compress=dedup,
        sort_rows=dedup and cfg.loss.mode != "rotate",
        pipeline_workers=cfg.data.pipeline_workers,
        local_sel_cap=cfg.data.max_unique_rows_local if dedup and joint else 0,
        local_sel_shards=1,
        reshuffle_each_epoch=cfg.data.reshuffle_each_epoch,
        cache_epoch_batches=cfg.data.cache_epoch_batches)
    if tr["prefetch"]:
        stream = prefetch(stream, depth=tr["prefetch"])
    step_fn = make_train_step(cfg)
    spans = Spans()
    rows = cfg.tower.vocab_size
    st = {"state": state, "aux": None, "i": 0}
    none = contextlib.nullcontext()

    def one(spanned: bool = False, labelled: bool = False) -> None:
        """One step of train()'s loop."""
        with record_function("bench.next") if labelled else none:
            with spans.span("next") if spanned else none:
                batch = next(stream)
        with record_function("bench.step") if labelled else none:
            batch = add_rotation_offsets(batch, cfg, st["i"])
            st["state"], st["aux"] = step_fn(
                st["state"], batch_to_device(batch, device, vocab_size=rows))
        st["i"] += 1

    def snapshot() -> Dict:
        return {k: v.detach().to("cpu", copy=True)
                for k, v in params["shared"].items()}

    mark("weights")
    losses, cached, snaps = [], [], {}
    for s in range(epoch + n_check):
        one()
        if s < n_check:
            losses.append(float(st["aux"]["loss"]))
        elif s >= epoch:
            cached.append(float(st["aux"]["loss"]))
        if s + 1 in (1, n_check, epoch):
            snaps[s + 1] = snapshot()

    mark("first epoch")
    common.settle()
    stretch = tobj = None
    if traced:
        units = tr["trace_epochs"] * epoch
        tobj = btrace.profile(
            lambda: [one(labelled=True) for _ in range(units)], device)
        stretch = Stretch(kind="train", units=units, busy_s=tobj.busy_s,
                          window_s=tobj.window_s)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    inflight: "collections.deque" = collections.deque()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    steps = 0
    while True:
        one(spanned=traced)
        steps += 1
        if cuda:
            inflight.append(torch.cuda.Event())
            inflight[-1].record()
            while len(inflight) > cfg.train.max_inflight_steps:
                inflight.popleft().synchronize()
        if time.perf_counter() >= deadline:
            break
    last_loss = float(st["aux"]["loss"])
    float(table[1, 0])  # the hottest remapped row, updated by the last step
    wall = time.perf_counter() - t0
    stream.close()
    peak = (int(torch.cuda.max_memory_allocated(device)) if cuda else 0)
    notes = [mark.note(),
             f"last loss {last_loss:.6f}, {steps} steps in {wall:.3f} s"]
    del state, params, table, step_fn, st, stream, hashed, inflight
    common.free(device)

    # The reference follows the same steps from the same weights.
    inputs = common.train_inputs(cfg, queries, titles, loader_seed)
    lr = cfg.train.learning_rate
    ref = common.reference_steps(cfg, tower, seed, inputs, n_check, n_check,
                                 device)
    ref_cached = common.reference_steps(
        cfg, tower, seed, inputs, n_check, 0, device, first=epoch,
        start={k: v.to(device).float() for k, v in snaps[epoch].items()})
    p0 = common.reference_params(cfg, tower, seed, device)
    prog_grad = {k: (p0[k] - snaps[1][k].to(device).float()) / lr
                 for k in p0}
    prog_change = {k: float(torch.linalg.vector_norm(
        snaps[n_check][k].to(device).float() - p0[k])) for k in p0}
    del snaps, p0
    checks, leaf_notes = common.train_checks(losses, cached, prog_grad,
                                             prog_change, ref,
                                             ref_cached.losses, tower)
    del prog_grad, ref.grad
    notes.append("losses program " + " ".join(f"{x:.6f}" for x in losses)
                 + " reference " + " ".join(f"{x:.6f}" for x in
                                            ref.losses[:n_check]))
    notes.append("second epoch's losses program " + " ".join(
        f"{x:.6f}" for x in cached) + " reference " + " ".join(
        f"{x:.6f}" for x in ref_cached.losses))
    notes.extend(leaf_notes)

    if stretch is not None:
        items = []
        for s in range(epoch):
            entries, uniq = common.live_counts(inputs.enc, inputs.rows(s))
            items.append(counts.train_step(tower, b, entries, uniq))
        stretch.work = [it for _ in range(tr["trace_epochs"])
                        for step in items for it in step]
        stretch.unit_flops = sum(counts.flops(x) for x in items) / epoch
        stretch.wall_units, stretch.wall_s = steps, wall
        stretch.spans = spans.spans
    return common.Outcome(
        metrics={"train_pairs_per_s": steps * b / wall, "setup_s": setup_s},
        attempted=steps, failed=0, memory_peak_bytes=peak, checks=checks,
        stretch=stretch, trace=tobj, notes=notes)
