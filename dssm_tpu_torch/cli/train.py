"""Training entry point on one GPU.

    python -m dssm_tpu_torch.cli.train --preset=full --io.workdir=$RUN \
        [--cpu] [--resume] [--train.max_steps=1000] [...]

The flags are dssm_tpu.cli.train's: any config field is overridable with
--section.field=value. It runs on the GPU unless --cpu is given, and fails
when there is no GPU; on the GPU every kernel of the step is the port's CUDA
kernel. It trains on the toy corpus, writes JSONL metrics and checkpoints
(io/checkpoint.py) under --io.workdir, and saves the frequency remap there
when data.freq_remap is set; `python -m dssm_tpu_torch.cli.export` then
serves from the same workdir. --resume continues from the latest checkpoint
with the data stream at the step it left off.

Not ported yet: evaluation (train.eval_every is ignored, said once on
stderr), a file corpus (data.path) and the multi-device path.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from dssm_tpu_torch.cli.args import coerce_overrides, parse_argv


def main(argv: Optional[List[str]] = None) -> None:
    preset, cpu, resume, raw_overrides = parse_argv(
        sys.argv[1:] if argv is None else argv)

    import torch

    from dssm_tpu_torch.bridge import batch_to_torch
    from dssm_tpu_torch.config import get_preset
    from dssm_tpu_torch.config import validate as validate_cfg
    from dssm_tpu_torch.data import (
        batch_iterator, hash_pairs, make_toy_pairs, prefetch,
        train_eval_split,
    )
    from dssm_tpu_torch.device import resolve_device
    from dssm_tpu_torch.io.checkpoint import Checkpointer
    from dssm_tpu_torch.io.metrics import MetricsWriter
    from dssm_tpu_torch.kernels.gather import sublane_group
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.train.loop import add_rotation_offsets, make_train_step
    from dssm_tpu_torch.train.sparse_update import uses_sparse_update
    from dssm_tpu_torch.train.state import create_run_state

    device = resolve_device(cpu)
    cfg = validate_cfg(coerce_overrides(get_preset(preset), raw_overrides))
    if cfg.data.path:
        raise NotImplementedError(
            "training on a file corpus (data.path) is not ported yet "
            "(ROADMAP.md, Queue 1: the file corpus)")
    if cfg.mesh.model_parallel > 1:
        raise NotImplementedError(
            "the multi-device path is not ported yet (ROADMAP.md, Queue 1: "
            "multi-device)")
    if cfg.io.tensorboard or cfg.io.profile_dir:
        raise NotImplementedError(
            "TensorBoard summaries and the profiler hook (io.tensorboard, "
            "io.profile_dir) are not ported yet (ROADMAP.md, Queue 1: "
            "tooling); metrics go to " + cfg.io.metrics_file)
    if cfg.io.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    kind = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    print(f"preset={cfg.name} device={kind}", file=sys.stderr)
    print("evaluation is not ported yet (ROADMAP.md, Queue 1: eval): no "
          "eval runs during or after training", file=sys.stderr)

    pairs = make_toy_pairs(cfg.data.toy_num_pairs, cfg.data.toy_vocab_words,
                           cfg.data.seed)
    train_pairs, _eval_pairs = train_eval_split(
        pairs, eval_frac=cfg.data.eval_frac, seed=cfg.data.seed)
    hashed_train = hash_pairs(train_pairs, cfg.tower, cfg.data)

    if cfg.data.freq_remap:
        # Frequency-ordered vocab remap (data/remap.py), built from the train
        # corpus and saved so cli/export applies the same permutation
        # against the trained table.
        from dssm_tpu_torch.data.remap import (
            apply_remap, build_freq_remap, save_remap)

        remap = build_freq_remap(hashed_train, cfg.tower.vocab_size,
                                 num_shards=cfg.mesh.model_parallel)
        hashed_train = apply_remap(hashed_train, remap)
        save_remap(cfg.io.workdir, remap)
        print("freq_remap: vocab permutation built from the train corpus, "
              f"saved to {cfg.io.workdir}", file=sys.stderr)

    writer = MetricsWriter(f"{cfg.io.workdir}/{cfg.io.metrics_file}")
    ckpt = Checkpointer(cfg.io.workdir, keep=cfg.train.keep_checkpoints)
    state = None
    if resume:
        state = ckpt.restore(device=device)
        if state is not None:
            print(f"resumed from step {state.step}", file=sys.stderr)
    elif ckpt.all_steps():
        # A fresh run into a workdir with checkpoints: stale later-step
        # files would be what a later --resume or export picks up.
        print(f"WARNING: fresh run (no --resume): clearing the checkpoints "
              f"under {ckpt.directory}", file=sys.stderr)
        ckpt.clear()
    if state is None:
        params = model_base.init_params(cfg.tower, seed=cfg.train.seed,
                                        device=device)
        state = create_run_state(cfg, params)

    table = next(iter(state.params.values()))[
        model_base.TABLE_KEY[cfg.tower.arch]]
    dedup = cfg.data.dedup_lookup and uses_sparse_update(cfg)
    start_step = state.step
    # Every step consumes one batch, so the restored step count is the data
    # cursor (loader.batch_iterator).
    batches = prefetch(batch_iterator(
        hashed_train,
        cfg.train.batch_size,
        seed=cfg.train.seed,
        dedup_unique=cfg.data.max_unique if dedup else None,
        dedup_group=sublane_group(table.dtype),
        dedup_unique_rows=cfg.data.max_unique_rows,
        dedup_joint=cfg.tower.shared_weights,
        wire_compress=dedup,
        # Rotate mode keeps corpus order: its offsets address rows by
        # position.
        sort_rows=dedup and cfg.loss.mode != "rotate",
        pipeline_workers=cfg.data.pipeline_workers,
        local_sel_cap=cfg.data.max_unique_rows_local if dedup else 0,
        start_batch=start_step,
        reshuffle_each_epoch=cfg.data.reshuffle_each_epoch,
        cache_epoch_batches=cfg.data.cache_epoch_batches,
    ), depth=2)
    step_fn = make_train_step(cfg)

    t_last = time.perf_counter()
    step = last_log_step = start_step
    while step < cfg.train.max_steps:
        batch = add_rotation_offsets(next(batches), cfg, step)
        state, aux = step_fn(state, batch_to_torch(batch, device))
        if step % cfg.train.log_every == 0:
            metrics = {k: float(v) for k, v in aux.items()}  # waits
            now = time.perf_counter()
            metrics["steps_per_sec"] = (
                (step - last_log_step) / (now - t_last)
                if step > last_log_step else 0.0)
            metrics["pairs_per_sec"] = (
                metrics["steps_per_sec"] * cfg.train.batch_size)
            t_last, last_log_step = now, step
            writer.write("train", step, metrics)
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"r@1={metrics['in_batch_recall@1']:.3f}", file=sys.stderr)
        if (cfg.train.checkpoint_every and step
                and step % cfg.train.checkpoint_every == 0):
            ckpt.save(step, state)
        step += 1

    ckpt.save(cfg.train.max_steps, state)
    writer.close()


if __name__ == "__main__":
    main()
