"""Evaluation entry point on one GPU: restore a checkpoint, rank the eval
corpus, report Recall@K / NDCG@10 / MRR as one JSON line.

    python -m dssm_tpu_torch.cli.eval --preset=full --io.workdir=$RUN [--cpu]

The flags are dssm_tpu.cli.eval's: any config field is overridable with
--section.field=value (give the tower.table_dtype the run was trained with).
It runs on the GPU unless --cpu is given, and fails when there is no GPU. It
evaluates, through the vocab remap saved in --io.workdir, the weights
io/checkpoint.py::restore_run reads there: the latest checkpoint
`python -m dssm_tpu_torch.cli.train` wrote, else the newest orbax
checkpoint `python -m dssm_tpu.cli.train` wrote, else the seeded fresh init
(stderr says which; a dssm_tpu checkpoint that cannot be decoded raises).
With --data.path=pairs.tsv it evaluates the held-out split of that corpus
file, the one cli.train held out (the same data.seed and data.eval_frac).
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from dssm_tpu_torch.cli.args import coerce_overrides, parse_argv


def main(argv: Optional[List[str]] = None) -> None:
    preset, cpu, _resume, raw_overrides = parse_argv(
        sys.argv[1:] if argv is None else argv)

    from dssm_tpu_torch.config import get_preset
    from dssm_tpu_torch.config import validate as validate_cfg
    from dssm_tpu_torch.data import (
        hash_pairs, load_file_corpus, make_toy_pairs, train_eval_split)
    from dssm_tpu_torch.data.remap import apply_remap, load_remap
    from dssm_tpu_torch.device import resolve_device
    from dssm_tpu_torch.io.checkpoint import restore_run
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.train.eval import evaluate

    device = resolve_device(cpu)
    cfg = validate_cfg(coerce_overrides(get_preset(preset), raw_overrides))
    if cfg.data.path:
        _, hashed_eval, _, _ = load_file_corpus(cfg.tower, cfg.data)
        print(f"corpus {cfg.data.path}: {len(hashed_eval)} eval pairs",
              file=sys.stderr)
    else:
        pairs = make_toy_pairs(cfg.data.toy_num_pairs,
                               cfg.data.toy_vocab_words, cfg.data.seed)
        _, eval_pairs = train_eval_split(pairs, eval_frac=cfg.data.eval_frac,
                                         seed=cfg.data.seed)
        hashed_eval = hash_pairs(eval_pairs, cfg.tower, cfg.data)

    # Training may have remapped the vocab (data/remap.py): table rows live
    # at remapped positions, so eval inputs go through the same permutation.
    remap = load_remap(cfg.io.workdir)
    if remap is not None:
        hashed_eval = apply_remap(hashed_eval, remap)
        print(f"applied saved vocab remap from {cfg.io.workdir}",
              file=sys.stderr)

    restored, source = restore_run(cfg.io.workdir, cfg, device,
                                   opt_state=False)
    if restored is None:
        print(f"no checkpoint under {cfg.io.workdir}; evaluating fresh init",
              file=sys.stderr)
        params, step = model_base.init_params(
            cfg.tower, seed=cfg.train.seed, device=device), 0
    else:
        params, step = restored.params, restored.host_step
        print(f"restored step {step} from {source}", file=sys.stderr)
    table = next(iter(params.values()))[model_base.TABLE_KEY[cfg.tower.arch]]
    want = model_base.torch_dtype(cfg.tower.table_dtype_resolved)
    if table.dtype != want:
        raise SystemExit(
            f"the checkpoint's table is {table.dtype} but the config says "
            f"{want}: pass the --tower.table_dtype the run was trained with")

    # Kernels on CUDA tensors, plain versions on CPU tensors; no flag
    # changes that.
    impl = "auto"
    metrics = evaluate(params, cfg, hashed_eval, cfg.train.batch_size, impl)
    metrics["step"] = step
    metrics["impl"] = impl
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
