"""Write tests/fixtures/dssm_tpu_workdir: a workdir dssm_tpu trained, with
what dssm_tpu computes from it.

    JAX_PLATFORMS=cpu python tests/fixtures/make_dssm_tpu_workdir.py

It runs dssm_tpu's own command lines on the CPU (8 virtual devices, as
`--cpu` sets them up): `dssm_tpu.cli.train` trains the `full` preset for
STEPS steps and saves its orbax checkpoint; then, from that checkpoint,
`dssm_tpu.cli.eval` gives the eval line, `dssm_tpu.cli.export` the index of
the titles in titles.tsv, and `dssm_tpu.cli.train --resume` on a copy the
loss of the next step. Orbax's own restore gives the state as numpy.

The configuration is the `full` preset's: 384-wide table rows (300 used),
towers 300 -> 300 -> 128 in bf16, batch 1024, the toy corpus of 65,536
pairs over 8192 words with the frequency remap, here with a bf16 table,
adam on the dense subtree and the row-wise AdaGrad table (the sparse
path). One cut, for the repository's size: the vocabulary, 500,000 rows
cut to VOCAB. data.max_unique follows it (the preset's 2048 rows are more
than the 128 sixteen-row groups of a VOCAB-row bf16 table, which
config.validate refuses; VOCAB // 2 slots every group, so no batch
overflows it).

Written (under tests/fixtures/dssm_tpu_workdir/):
    workdir/             the run's workdir: checkpoints/<STEPS>/ (orbax),
                         vocab_remap.npy, metrics.jsonl
    titles.tsv           the fixed titles indexed (query<TAB>title)
    reference.npz        state/<path>: every leaf of the saved TrainState
                         (a bf16 leaf as its uint16 bits); index: the
                         titles' doc embeddings [N, 128] f32
    reference.json       flags, steps, bf16 leaves, the eval line, the
                         next-step loss, the titles in index order
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "dssm_tpu_workdir")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 4
VOCAB = 2048
N_TITLES = 256
FLAGS = ["--preset=full", f"--tower.vocab_size={VOCAB}",
         f"--data.max_unique={VOCAB // 2}", "--tower.table_dtype=bfloat16",
         "--train.optimizer=adam", "--train.table_optimizer=adagrad",
         "--train.learning_rate=0.01"]


def _stdout_lines(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue().strip().splitlines()


def main() -> None:
    sys.path.insert(0, REPO)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from dssm_tpu.cli import eval as jeval
    from dssm_tpu.cli import export as jexport
    from dssm_tpu.cli import train as jtrain
    from dssm_tpu.cli.train import coerce_overrides, parse_argv
    from dssm_tpu.config import get_preset, validate
    from dssm_tpu.data import make_toy_pairs, train_eval_split, write_tsv
    from dssm_tpu.data.toy import ToyPairs
    from dssm_tpu.io.checkpoint import Checkpointer
    from dssm_tpu.models import base
    from dssm_tpu.train.state import create_run_state

    shutil.rmtree(HERE, ignore_errors=True)
    work = os.path.join(HERE, "workdir")
    os.makedirs(work)
    run = ["--cpu", *FLAGS, f"--io.workdir={work}"]
    jtrain.main([*run, f"--train.max_steps={STEPS}", "--train.log_every=1"])
    eval_line = json.loads(_stdout_lines(jeval.main, run)[-1])

    preset, _, _, overrides = parse_argv(FLAGS)
    cfg = validate(coerce_overrides(get_preset(preset), overrides))
    pairs = make_toy_pairs(cfg.data.toy_num_pairs, cfg.data.toy_vocab_words,
                           cfg.data.seed)
    _, held_out = train_eval_split(pairs, eval_frac=cfg.data.eval_frac,
                                   seed=cfg.data.seed)
    titles_tsv = os.path.join(HERE, "titles.tsv")
    write_tsv(ToyPairs(queries=held_out.queries[:N_TITLES],
                       titles=held_out.titles[:N_TITLES]), titles_tsv)
    with tempfile.TemporaryDirectory() as tmp:
        index_path = os.path.join(tmp, "index.npz")
        _stdout_lines(jexport.main, [*run, f"--data.path={titles_tsv}",
                                     f"--out={index_path}"])
        with np.load(index_path, allow_pickle=True) as z:
            index, titles = z["doc_emb"], [str(t) for t in z["titles"]]
        resumed = os.path.join(tmp, "resumed")
        shutil.copytree(work, resumed)
        jtrain.main(["--cpu", *FLAGS, f"--io.workdir={resumed}", "--resume",
                     f"--train.max_steps={STEPS + 1}", "--train.log_every=1"])
        with open(os.path.join(resumed, cfg.io.metrics_file)) as f:
            records = [json.loads(line) for line in f]
    next_loss = [r["loss"] for r in records
                 if r["tag"] == "train" and r["step"] == STEPS]
    assert len(next_loss) == 1, records

    like = create_run_state(cfg, base.init_params(cfg.tower,
                                                  seed=cfg.train.seed))
    ckpt = Checkpointer(work)
    state = ckpt.restore(like, step=STEPS)
    ckpt.close()
    leaves = {}
    bf16 = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        name = "/".join(str(getattr(k, "name", getattr(k, "key", getattr(
            k, "idx", k)))) for k in path)
        leaf = np.asarray(leaf)
        if leaf.dtype.name == "bfloat16":
            bf16.append(name)
            leaf = leaf.view(np.uint16)
        leaves[f"state/{name}"] = leaf
    np.savez_compressed(os.path.join(HERE, "reference.npz"), index=index,
                        **leaves)
    with open(os.path.join(HERE, "reference.json"), "w") as f:
        json.dump({"flags": FLAGS, "steps": STEPS, "bfloat16_leaves": bf16,
                   "eval": eval_line, "next_step_loss": next_loss[0],
                   "titles": titles}, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(HERE) for n in names)
    print(f"wrote {HERE}: {total} bytes; eval {eval_line}; next-step loss "
          f"{next_loss[0]}")


if __name__ == "__main__":
    main()
