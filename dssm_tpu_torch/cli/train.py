"""Training entry point, on one GPU or one process a GPU.

    python -m dssm_tpu_torch.cli.train --preset=full --io.workdir=$RUN \
        [--cpu] [--resume] [--train.max_steps=1000] [...]

The flags are dssm_tpu.cli.train's: any config field is overridable with
--section.field=value. It runs on the GPU unless --cpu is given, and fails
when there is no GPU; on the GPU every kernel of the step is the port's CUDA
kernel. It trains the mlp (tiny, full), cnn and lstm presets on the toy
corpus, or on a corpus file with --data.path=pairs.tsv (or .jsonl; its
seeded split gives the held-out pairs), with an f32, bf16 or int8 table
(--tower.table_dtype), on dedupe
batches or, with --data.dedup_lookup=False, raw-index batches; evaluates
the held-out split every train.eval_every steps and at the end (records
`eval` / `eval_final`), writes JSONL metrics
and checkpoints (io/checkpoint.py) under --io.workdir, and saves the
frequency remap there when data.freq_remap is set;
`python -m dssm_tpu_torch.cli.eval` and `cli.export` then read the same
workdir. --resume continues, with the data stream at the step it left
off, from what io/checkpoint.py::restore_run reads: the latest checkpoint
of the port, else the newest orbax checkpoint `python -m
dssm_tpu.cli.train` wrote in the workdir (its optimizer state too; the
port then saves its own checkpoints beside it and never deletes dssm_tpu's),
else the fresh init. The batches are built by the C++ host data plane
(data/native.py), on a pool of --data.pipeline_workers threads when it is
above 1; --data.reshuffle_each_epoch=False --data.cache_epoch_batches=True
replays the first epoch's batches after it.

Off the sparse path (--train.optimizer=momentum|adam with the sgd table
optimizer, or --train.sparse_embed_update=False) it trains with the
dense-table step on raw-index batches of an f32 table. With
--train.steps_per_call=K > 1 it runs blocks of K steps (stacked in a
background thread) while K steps remain, then single steps; its log, eval
and checkpoint records land on a block's last step, where step % every < K,
as dssm_tpu's do. On the GPU a step, or a block of K, is one replay of a
captured CUDA graph (train/compiled.py: the state updated in place on the
card, as dssm_tpu's jitted step donates it; on a mesh the NCCL collectives
inside the graph); with --cpu the same step body runs eagerly. At most
train.max_inflight_steps steps or blocks are queued on the card before the
loop waits for the oldest.

--io.tensorboard=true mirrors the records' scalars to TensorBoard event
files under <workdir>/tb/<tag> and writes a `weights` record
(io/metrics.py::weight_summaries of the whole parameters, with
--io.weight_histogram_bins bins) at each periodic eval.
--io.profile_dir=DIR traces steps start + 5 to start + 10 (the CPU and, on
the GPU, the card) with torch.profiler into DIR/rank<r>.<ns>.pt.trace.json,
also when the run ends inside that window.

With the variables DSSM_COORDINATOR (host:port of process 0),
DSSM_NUM_PROCS and DSSM_PROC_ID set, one process a GPU runs the same command
(parallel/dist.py: NCCL on the GPU, gloo with --cpu): the processes form a
data_parallel x model_parallel mesh (--mesh.*), each loads its data
coordinate's shard of every batch and, at model_parallel > 1, its rows of
the table, and trains with the compiled parallel step
(parallel/train_step.py), fed wire blocks as on one GPU;
process 0 saves the remap, writes the records and the checkpoints (the
table gathered whole, so cli.eval and cli.export read the workdir as a
single-device one) and runs the evals. A joint-dedupe batch gets a
per-shard slot space data.max_unique_rows_local wide when that is set (the
multihost preset; on one device too). --preset=multihost needs
model_parallel ranks: on one GPU, --mesh.model_parallel=1.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import List, Optional

from dssm_tpu_torch.cli.args import coerce_overrides, parse_argv


def main(argv: Optional[List[str]] = None) -> None:
    preset, cpu, resume, raw_overrides = parse_argv(
        sys.argv[1:] if argv is None else argv)

    import torch

    from dssm_tpu_torch.bridge import batch_to_device
    from dssm_tpu_torch.config import get_preset
    from dssm_tpu_torch.config import validate as validate_cfg
    from dssm_tpu_torch.data import (
        batch_iterator, hash_pairs, load_file_corpus, make_toy_pairs,
        prefetch, train_eval_split,
    )
    from dssm_tpu_torch.data.loader import LockedIterator
    from dssm_tpu_torch.io.checkpoint import Checkpointer, restore_run
    from dssm_tpu_torch.io.metrics import MetricsWriter, weight_summaries
    from dssm_tpu_torch.kernels.gather import sublane_group
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.parallel import dist
    from dssm_tpu_torch.parallel.mesh import make_mesh
    from dssm_tpu_torch.parallel.train_step import (
        create_sharded_state, gather_tree, make_parallel_multi_step,
        make_parallel_train_step)
    from dssm_tpu_torch.train.eval import evaluate
    from dssm_tpu_torch.train.loop import (
        add_rotation_offsets, make_multi_train_step, make_train_step,
        stack_batches)
    from dssm_tpu_torch.train.sparse_update import uses_sparse_update
    from dssm_tpu_torch.train.state import create_run_state

    joined = not torch.distributed.is_initialized()
    device = dist.initialize(cpu=cpu)
    joined = joined and torch.distributed.is_initialized()
    cfg = validate_cfg(coerce_overrides(get_preset(preset), raw_overrides))
    if cfg.io.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    multi_device = (torch.distributed.is_initialized()
                    or cfg.mesh.model_parallel > 1)
    mesh = make_mesh(cfg.mesh, device) if multi_device else None
    lead = mesh is None or mesh.rank == 0  # records, checkpoints, evals
    print(f"preset={cfg.name} device={kind} processes="
          f"{dist.process_count()} multi_device={multi_device}"
          + (f" mesh={mesh.shape} rank={mesh.rank}" if mesh else ""),
          file=sys.stderr)

    if cfg.data.path:
        hashed_train, hashed_eval, _, _ = load_file_corpus(cfg.tower,
                                                           cfg.data)
        print(f"corpus {cfg.data.path}: {len(hashed_train)} train / "
              f"{len(hashed_eval)} eval pairs", file=sys.stderr)
    else:
        pairs = make_toy_pairs(cfg.data.toy_num_pairs,
                               cfg.data.toy_vocab_words, cfg.data.seed)
        train_pairs, eval_pairs = train_eval_split(
            pairs, eval_frac=cfg.data.eval_frac, seed=cfg.data.seed)
        hashed_train = hash_pairs(train_pairs, cfg.tower, cfg.data)
        hashed_eval = hash_pairs(eval_pairs, cfg.tower, cfg.data)

    if cfg.data.freq_remap:
        # Frequency-ordered vocab remap (data/remap.py), built from the train
        # corpus and saved so cli/export applies the same permutation
        # against the trained table.
        from dssm_tpu_torch.data.remap import (
            apply_remap, build_freq_remap, save_remap)

        remap = build_freq_remap(hashed_train, cfg.tower.vocab_size,
                                 num_shards=cfg.mesh.model_parallel)
        hashed_train = apply_remap(hashed_train, remap)
        hashed_eval = apply_remap(hashed_eval, remap)
        if lead:
            save_remap(cfg.io.workdir, remap)
        print("freq_remap: vocab permutation built from the train corpus, "
              f"saved to {cfg.io.workdir}", file=sys.stderr)

    writer = MetricsWriter(
        f"{cfg.io.workdir}/{cfg.io.metrics_file}" if lead else None,
        tensorboard_dir=(f"{cfg.io.workdir}/tb"
                         if cfg.io.tensorboard and lead else None))
    ckpt = Checkpointer(cfg.io.workdir, keep=cfg.train.keep_checkpoints)
    state = None
    if resume:
        state, source = restore_run(cfg.io.workdir, cfg, device, mesh)
        if state is not None:
            print(f"resumed from step {state.host_step} ({source})",
                  file=sys.stderr)
    else:
        if lead and ckpt.all_steps():
            # A fresh run into a workdir with checkpoints: stale later-step
            # files would be what a later --resume or export picks up.
            print(f"WARNING: fresh run (no --resume): clearing the "
                  f"checkpoints under {ckpt.directory}", file=sys.stderr)
            ckpt.clear()
        # Every process waits here, whether or not it saw checkpoints, so
        # none can read the workdir before process 0 has cleared it.
        dist.barrier()
    if state is None:
        params = model_base.init_params(cfg.tower, seed=cfg.train.seed,
                                        device=device)
        state = (create_sharded_state(cfg, mesh, params) if mesh
                 else create_run_state(cfg, params))

    table = next(iter(state.params.values()))[
        model_base.TABLE_KEY[cfg.tower.arch]]
    dedup = cfg.data.dedup_lookup and uses_sparse_update(cfg)
    start_step = state.host_step
    # Every step consumes one batch, so the restored step count is the data
    # cursor (loader.batch_iterator).
    sequence = cfg.tower.is_sequence_model
    # LockedIterator: the block-stacking thread (below) and the loop's
    # single steps both pull from this stream.
    batches = LockedIterator(prefetch(batch_iterator(
        hashed_train,
        cfg.train.batch_size,
        sequence,
        seed=cfg.train.seed,
        # One process a data coordinate's shard: the mp processes of one
        # data coordinate build the same batches.
        process_index=mesh.coords["data"] if mesh else 0,
        process_count=mesh.shape["data"] if mesh else 1,
        dedup_unique=cfg.data.max_unique if dedup else None,
        dedup_group=sublane_group(table.dtype),
        dedup_unique_rows=cfg.data.max_unique_rows,
        dedup_joint=cfg.tower.shared_weights,
        # Sequence batches keep their full layout and their row order.
        wire_compress=dedup and not sequence,
        # Rotate mode keeps corpus order: its offsets address rows by
        # position.
        sort_rows=dedup and not sequence and cfg.loss.mode != "rotate",
        pipeline_workers=cfg.data.pipeline_workers,
        # The third dedupe level: one slot space for the process's shard.
        local_sel_cap=(cfg.data.max_unique_rows_local
                       if dedup and cfg.tower.shared_weights else 0),
        local_sel_shards=1,
        start_batch=start_step,
        reshuffle_each_epoch=cfg.data.reshuffle_each_epoch,
        cache_epoch_batches=cfg.data.cache_epoch_batches,
    ), depth=2))
    spc = cfg.train.steps_per_call
    # Compiled: on the GPU a replayed CUDA graph a step or a block (on a
    # mesh with its NCCL collectives inside), which copies the batch's wire
    # block into static buffers and widens it inside the graph
    # (train/compiled.py).
    if mesh:
        step_fn = make_parallel_train_step(cfg, mesh)
        multi_fn = make_parallel_multi_step(cfg, mesh) if spc > 1 else None
    else:
        step_fn = make_train_step(cfg)
        multi_fn = make_multi_train_step(cfg) if spc > 1 else None
    # The table's global rows, which a raw batch's lookups must lie in.
    rows = cfg.tower.vocab_size
    # The bounded in-flight window (train.max_inflight_steps): an event
    # after each step or block; the loop waits for the oldest while more
    # are queued. On the CPU a step is done when it returns.
    inflight: "collections.deque" = collections.deque()

    # K-step blocks are stacked in a background thread, ahead of the loop.
    # It stacks exactly the run's full blocks and stops, so the ragged
    # tail's single steps take the batches after them in order (dssm_tpu's
    # thread stacks on past the last block, and its tail takes batches
    # from further on). Rotate mode stacks inline: its offsets follow the
    # step counter.
    stacked_blocks = None
    if multi_fn is not None and cfg.loss.mode != "rotate":
        def _stacked_stream():
            for _ in range((cfg.train.max_steps - start_step) // spc):
                yield stack_batches(next(batches) for _ in range(spc))

        stacked_blocks = prefetch(_stacked_stream(), depth=2)

    def whole_params():
        """The whole parameters (the table gathered over the model group,
        which every process joins)."""
        return gather_tree(state.params, mesh) if mesh else state.params

    def run_eval(params):
        """The eval on process 0."""
        if not lead:
            return None
        return evaluate(params, cfg, hashed_eval, cfg.train.batch_size)

    # The profiler hook: a window over steps [start + 5, start + 10), as
    # dssm_tpu traces them; every rank writes its own trace.
    prof = None
    profiled = False

    def stop_profile():
        if device.type == "cuda":
            torch.cuda.synchronize()  # the window's queued kernels
        prof.stop()
        print(f"profile written to {cfg.io.profile_dir}", file=sys.stderr)

    t_last = time.perf_counter()
    step = last_log_step = start_step
    while step < cfg.train.max_steps:
        if (cfg.io.profile_dir and prof is None and not profiled
                and step >= start_step + 5):
            prof = start_profile(cfg.io.profile_dir, device,
                                 dist.process_index())
        if prof is not None and step >= start_step + 10:
            stop_profile()
            prof, profiled = None, True
        if multi_fn is not None and cfg.train.max_steps - step >= spc:
            if stacked_blocks is not None:
                stacked = next(stacked_blocks)
            else:
                stacked = stack_batches(
                    add_rotation_offsets(next(batches), cfg, step + j)
                    for j in range(spc))
            state, auxes = multi_fn(
                state, batch_to_device(stacked, device, vocab_size=rows))
            aux = {k: v[-1] for k, v in auxes.items()}
            step += spc - 1  # the records below land on the block's last step
        else:
            batch = add_rotation_offsets(next(batches), cfg, step)
            state, aux = step_fn(
                state, batch_to_device(batch, device, vocab_size=rows))
        if device.type == "cuda":
            inflight.append(torch.cuda.Event())
            inflight[-1].record()
            while len(inflight) > cfg.train.max_inflight_steps:
                inflight.popleft().synchronize()
        stride = spc if multi_fn is not None else 1
        if step % cfg.train.log_every < stride:
            metrics = {k: float(v) for k, v in aux.items()}  # waits
            now = time.perf_counter()
            metrics["steps_per_sec"] = (
                (step - last_log_step) / (now - t_last)
                if step > last_log_step else 0.0)
            metrics["pairs_per_sec"] = (
                metrics["steps_per_sec"] * cfg.train.batch_size)
            t_last, last_log_step = now, step
            writer.write("train", step, metrics)
            if lead:
                print(f"step {step}: loss={metrics['loss']:.4f} "
                      f"r@1={metrics['in_batch_recall@1']:.3f}",
                      file=sys.stderr)
        if (cfg.train.eval_every and step
                and step % cfg.train.eval_every < stride):
            # The eval corpus's prepared batches are cached on the device
            # after the first eval (train/eval.py).
            params = whole_params()
            ev = run_eval(params)
            if ev is not None:
                writer.write("eval", step, ev)
                if cfg.io.tensorboard:
                    writer.write("weights", step, weight_summaries(
                        params, cfg.io.weight_histogram_bins))
                print(f"eval@{step}: recall@1={ev['recall@1']:.3f} "
                      f"ndcg@10={ev['ndcg@10']:.3f}", file=sys.stderr)
        if (cfg.train.checkpoint_every and step
                and step % cfg.train.checkpoint_every < stride):
            ckpt.save(step, state, mesh)
        step += 1

    if prof is not None:
        # The run ended inside the window: its trace is written all the
        # same (dssm_tpu never stops its trace then).
        stop_profile()
    ckpt.save(cfg.train.max_steps, state, mesh)
    ev = run_eval(whole_params())
    if ev is not None:
        writer.write("eval_final", cfg.train.max_steps, ev)
        print(f"final eval: recall@1={ev['recall@1']:.3f} "
              f"ndcg@10={ev['ndcg@10']:.3f} mrr={ev['mrr']:.3f}",
              file=sys.stderr)
    writer.close()
    if joined:
        # The others wait for process 0's last checkpoint and eval.
        dist.barrier()
        dist.shutdown()


def start_profile(profile_dir: str, device, rank: int):
    """A started torch.profiler window over the CPU and, on the GPU, the
    card; stopping it writes <profile_dir>/rank<rank>.<ns>.pt.trace.json
    (torch.profiler.tensorboard_trace_handler, which TensorBoard's
    profiler plugin reads)."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(
                       profile_dir, worker_name=f"rank{rank}"))
    prof.start()
    return prof


if __name__ == "__main__":
    main()
