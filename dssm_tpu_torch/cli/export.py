"""Export + retrieval entry point (the serving path) on the GPU.

    # embed the corpus titles -> index file
    python -m dssm_tpu_torch.cli.export --preset=full --io.workdir=$RUN \
        --out=$RUN/index.npz [--cpu]

    # top-k retrieval against an index (ad-hoc query or a query file)
    python -m dssm_tpu_torch.cli.export --preset=full --io.workdir=$RUN \
        --index=$RUN/index.npz --query="best hiking boots" --k=5 [--cpu]

The flags are dssm_tpu.cli.export's. It runs on the GPU unless --cpu is
given, and fails when there is no GPU; on the GPU it always runs the CUDA
kernels (there is no use_pallas switch). With --data.path=... the corpus comes
from the TSV/JSONL file; otherwise the toy corpus. The weights are those
io/checkpoint.py::restore_run reads: the latest checkpoint
`python -m dssm_tpu_torch.cli.train` wrote under --io.workdir, else the
newest orbax checkpoint `python -m dssm_tpu.cli.train` wrote there, else
the seeded fresh init; stderr says which. A dssm_tpu checkpoint that cannot
be decoded raises, naming the file.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from dssm_tpu_torch.cli.args import coerce_overrides, parse_argv


def _split_serving_flags(argv: List[str]):
    """Pull export-specific flags out before the config parser sees them."""
    out, index, query, query_file, k = None, None, None, None, 10
    rest = []
    for arg in argv:
        if arg.startswith("--out="):
            out = arg.split("=", 1)[1]
        elif arg.startswith("--index="):
            index = arg.split("=", 1)[1]
        elif arg.startswith("--query="):
            query = arg.split("=", 1)[1]
        elif arg.startswith("--query_file="):
            query_file = arg.split("=", 1)[1]
        elif arg.startswith("--k="):
            k = int(arg.split("=", 1)[1])
        else:
            rest.append(arg)
    return out, index, query, query_file, k, rest


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out, index_path, query, query_file, k, rest = _split_serving_flags(argv)
    preset, cpu, _resume, raw_overrides = parse_argv(rest)

    from dssm_tpu_torch.config import get_preset
    from dssm_tpu_torch.config import validate as validate_cfg
    from dssm_tpu_torch.data.remap import load_remap
    from dssm_tpu_torch.device import resolve_device
    from dssm_tpu_torch.models import base as model_base
    from dssm_tpu_torch.serve import (
        build_doc_index, embed_queries, load_index, save_index, top_k,
    )

    device = resolve_device(cpu)
    cfg = validate_cfg(coerce_overrides(get_preset(preset), raw_overrides))
    # The kernels run on CUDA tensors, their plain versions on CPU tensors;
    # no preset or flag changes that.
    impl = "auto"

    from dssm_tpu_torch.io.checkpoint import restore_run

    restored, source = restore_run(cfg.io.workdir, cfg, device,
                                   opt_state=False)
    if restored is not None:
        print(f"restored step {restored.host_step} from {source}",
              file=sys.stderr)
    else:
        print(f"no checkpoint under {cfg.io.workdir}; using fresh init",
              file=sys.stderr)

    # Vocab remap persisted by training (data/remap.py): serving inputs must
    # go through the same permutation the trained table rows live in.
    remap = load_remap(cfg.io.workdir)
    if remap is not None:
        print(f"applying saved vocab remap from {cfg.io.workdir}",
              file=sys.stderr)

    if restored is not None:
        params = restored.params
    else:
        params = model_base.init_params(cfg.tower, seed=cfg.train.seed,
                                        device=device)

    if out:
        if cfg.data.path:
            from dssm_tpu_torch.data import read_pairs

            pairs = read_pairs(cfg.data.path, cfg.data.max_pairs)
        else:
            from dssm_tpu_torch.data import make_toy_pairs

            pairs = make_toy_pairs(cfg.data.toy_num_pairs,
                                   cfg.data.toy_vocab_words, cfg.data.seed)
        titles = list(dict.fromkeys(pairs.titles))  # dedupe, keep order
        emb = build_doc_index(params, cfg, titles, cfg.train.batch_size, impl,
                              remap, device)
        save_index(out, emb, titles)
        print(json.dumps({"indexed_docs": len(titles), "dim": emb.shape[1],
                          "path": out}))
        return

    if index_path:
        doc_emb, titles = load_index(index_path)
        if query is not None:
            queries = [query]
        elif query_file:
            with open(query_file) as f:
                queries = [line.strip() for line in f if line.strip()]
        else:
            raise SystemExit("--index needs --query=... or --query_file=...")
        q_emb = embed_queries(params, cfg, queries, cfg.train.batch_size,
                              impl, remap, device)
        scores, ids = top_k(q_emb, doc_emb, k=k, device=device)
        for qi, qtext in enumerate(queries):
            print(json.dumps({
                "query": qtext,
                "results": [
                    {"rank": r + 1, "doc_id": int(ids[qi, r]),
                     "title": titles[int(ids[qi, r])],
                     "score": float(scores[qi, r])}
                    for r in range(ids.shape[1])
                ],
            }))
        return

    raise SystemExit("pass --out=index.npz to build an index, or "
                     "--index=index.npz --query=... to retrieve")


if __name__ == "__main__":
    main()
