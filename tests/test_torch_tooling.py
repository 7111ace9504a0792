"""The tooling of dssm_tpu_torch against dssm_tpu on the CPU: weight
summaries, the metrics writer's JSONL and TensorBoard records, cli.train's
TensorBoard records and profiler hook, the collective model, the trigram
collision statistics and the three diagnostic tools.

Tolerances: an f32 statistic rtol 1e-5 (the same reduction in another
order); a bf16 leaf's statistics are bf16 values (jnp rounds them to the
leaf's dtype), within one bf16 step of dssm_tpu's (the f32 variance before
its rounding differs in its last bits); histograms, integer statistics,
collision counts, the collective model's payloads and the vocab tool's
text exact (the hashing is bit-equal). After a few steps of cli.train the
summaries carry the two trainings' own differences too: rtol 1e-5 with an
absolute floor of 1e-7 (the trained tables' means are sums of ~±0.04
entries that cancel to ~1e-5); histogram edges that much plus their
rounding to 6 places, and each count within 1e-5 of the leaf's size (a
value that close to an edge may fall on its other side).
"""

import json
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dssm_tpu.config import configs as jcfg
from dssm_tpu.data import toy as jtoy
from dssm_tpu.data import trigram as jtrigram
from dssm_tpu.io import metrics as jmetrics
from dssm_tpu.models import base as jbase
from dssm_tpu.parallel import comm_model as jcomm
from dssm_tpu_torch import bridge
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data import trigram as ttrigram
from dssm_tpu_torch.data.corpus import write_tsv
from dssm_tpu_torch.io import metrics as tmetrics
from dssm_tpu_torch.parallel import comm_model as tcomm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _towers(arch, shared, table_dtype):
    """dssm_tpu's and the port's TowerConfig at small widths."""
    kw = dict(arch=arch, vocab_size=4096, embed_width=40, hidden_dims=(64,),
              semantic_dim=32, conv_channels=40, lstm_hidden=32,
              shared_weights=shared, table_dtype=table_dtype)
    return jcfg.TowerConfig(**kw), tcfg.TowerConfig(**kw)


def _bf16_step(x: float) -> float:
    """The spacing of bf16 values at x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 2.0 ** -133


def _check_summaries(got, want, dtypes, tol=F32_TOL, hist_exact=True):
    """got (the port's) against want (dssm_tpu's): the same keys in the
    same order, lists equal, bf16 leaves' statistics bf16 values within
    one bf16 step, the rest within tol; dtypes: {"tower/leaf": dtype}.
    hist_exact=False (two trainings): edges within tol plus their 6-place
    rounding, each count within 1e-5 of the leaf's size, the same total."""
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        leaf, stat = k.rsplit("/", 1)
        if isinstance(w, list) and not hist_exact:
            if stat == "hist_edges":
                np.testing.assert_allclose(g, w, rtol=tol["rtol"],
                                           atol=tol["atol"] + 1e-6,
                                           err_msg=k)
            else:
                assert sum(g) == sum(w), k
                assert max(abs(a - b) for a, b in zip(g, w)) <= max(
                    1, 1e-5 * sum(w)), (k, g, w)
        elif isinstance(w, list):
            assert g == w, k
        elif dtypes[leaf] == torch.bfloat16:
            assert float(np.float32(g).astype(ml_dtypes.bfloat16)) == g, k
            assert abs(g - w) <= _bf16_step(w), (k, g, w)
        elif dtypes[leaf] == torch.int8 and stat in ("min", "max"):
            assert g == w, k
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("bins", [0, 8])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "separate"])
@pytest.mark.parametrize("arch", ["mlp", "cnn", "lstm"])
def test_weight_summaries_match_dssm_tpu(arch, shared, table_dtype, bins):
    jt, tt = _towers(arch, shared, table_dtype)
    jparams = jbase.init_params(jt, seed=3)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tt,
                                    "cpu")
    want = jmetrics.weight_summaries(jparams, bins)
    got = tmetrics.weight_summaries(params, bins)
    dtypes = {f"{t}/{k}": v.dtype for t, tp in params.items()
              for k, v in tp.items()}
    _check_summaries(got, want, dtypes)
    if bins:
        assert any(k.endswith("/hist_edges") for k in got)


def _scalars(tb_dir):
    """{tag dir: {scalar name: [(step, value)]}} read back with
    tensorboard's EventAccumulator."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    out = {}
    for tag in sorted(os.listdir(tb_dir)):
        acc = EventAccumulator(os.path.join(tb_dir, tag))
        acc.Reload()
        out[tag] = {name: [(e.step, e.value) for e in acc.Scalars(name)]
                    for name in acc.Tags()["scalars"]}
    return out


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in f]


def test_metrics_writer_matches_dssm_tpu(tmp_path):
    """The same records through both writers: the same JSONL lines but
    `time`, and the same scalars under the same tags in the TensorBoard
    event files (lists stay out of them)."""
    events = [("train", 0, {"loss": 4.25, "steps_per_sec": 0.0,
                            "count": 3}),
              ("train", 2, {"loss": 3.5, "steps_per_sec": 12.5,
                            "count": 7}),
              ("eval", 2, {"recall@1": 0.25, "num_queries": 40}),
              ("weights", 2, {"shared/W0/mean": -0.125,
                              "shared/W0/hist_counts": [1, 2, 3],
                              "shared/W0/hist_edges": [0.0, 0.5, 1.0,
                                                       1.5]}),
              ("eval_final", 4, {"recall@1": 0.5, "mrr": 0.625})]
    for name, mod in (("ref", jmetrics), ("port", tmetrics)):
        w = mod.MetricsWriter(str(tmp_path / name / "metrics.jsonl"),
                              tensorboard_dir=str(tmp_path / name / "tb"))
        for tag, step, m in events:
            w.write(tag, step, m)
        w.close()
    assert (_records(tmp_path / "port" / "metrics.jsonl")
            == _records(tmp_path / "ref" / "metrics.jsonl"))
    got, want = _scalars(tmp_path / "port" / "tb"), _scalars(
        tmp_path / "ref" / "tb")
    assert got == want
    assert sorted(got) == ["eval", "eval_final", "train", "weights"]
    assert list(got["weights"]) == ["shared/W0/mean"]
    assert got["train"]["loss"] == [(0, 4.25), (2, 3.5)]


def test_metrics_writer_raises_without_tensorboard(tmp_path):
    """Where dssm_tpu drops its summaries quietly, the port raises and
    names the package; the JSONL file alone needs no tensorboard."""
    code = (
        "import sys\n"
        "sys.modules['torch.utils.tensorboard'] = None\n"
        "from dssm_tpu_torch.io.metrics import MetricsWriter\n"
        f"w = MetricsWriter({str(tmp_path / 'm.jsonl')!r})\n"
        "w.write('train', 0, {'loss': 1.0}); w.close()\n"
        "try:\n"
        f"    MetricsWriter(None, tensorboard_dir={str(tmp_path / 'tb')!r})\n"
        "except ImportError as e:\n"
        "    print('raised:', e)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "raised: io.tensorboard needs the `tensorboard` package" in r.stdout
    assert _records(tmp_path / "m.jsonl") == [
        {"tag": "train", "step": 0, "loss": 1.0}]


SMALL = ["--preset=tiny", "--cpu", "--tower.vocab_size=4096",
         "--tower.embed_width=40", "--tower.hidden_dims=64",
         "--tower.semantic_dim=32", "--data.max_trigrams=16",
         "--data.max_trigrams_query=8", "--data.max_unique=512",
         "--data.max_unique_rows=128", "--data.toy_num_pairs=400",
         "--data.toy_vocab_words=64", "--train.batch_size=64",
         "--train.log_every=1"]


def test_train_cli_tensorboard_matches_dssm_tpu(tmp_path):
    """cli.train --io.tensorboard=true --io.weight_histogram_bins=4
    --train.eval_every=2 against dssm_tpu's CLI with the same flags: the
    same records (tag, step) in metrics.jsonl, the weights records within
    the tolerances above, and the same event-file tags and scalar names."""
    from dssm_tpu_torch.cli import train as cli_train

    flags = SMALL + ["--train.max_steps=5", "--io.tensorboard=true",
                     "--io.weight_histogram_bins=4", "--train.eval_every=2"]
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    r = subprocess.run([sys.executable, "-m", "dssm_tpu.cli.train", *flags,
                        f"--io.workdir={ref}"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    cli_train.main(flags + [f"--io.workdir={port}"])
    got = _records(os.path.join(port, "metrics.jsonl"))
    want = _records(os.path.join(ref, "metrics.jsonl"))
    assert [(g["tag"], g["step"]) for g in got] == [
        (w["tag"], w["step"]) for w in want]
    assert [r["step"] for r in got if r["tag"] == "weights"] == [2, 4]
    dtypes = {"shared/W0": torch.float32}
    dtypes.update({f"shared/{k}": torch.float32
                   for k in ("W1", "W2", "b0", "b1", "b2")})
    for g, w in zip(got, want):
        if g["tag"] == "weights":
            g = {k: v for k, v in g.items() if k not in ("tag", "step")}
            w = {k: v for k, v in w.items() if k not in ("tag", "step")}
            _check_summaries(g, w, dtypes, tol=dict(rtol=1e-5, atol=1e-7),
                             hist_exact=False)
            assert len(g["shared/W0/hist_counts"]) == 4
    got_tb, want_tb = (_scalars(os.path.join(d, "tb")) for d in (port, ref))
    assert sorted(got_tb) == sorted(want_tb) == [
        "eval", "eval_final", "train", "weights"]
    for tag in got_tb:
        assert sorted(got_tb[tag]) == sorted(want_tb[tag]), tag
        assert ([s for s, _ in got_tb[tag][next(iter(got_tb[tag]))]]
                == [s for s, _ in want_tb[tag][next(iter(want_tb[tag]))]])


def _trace_events(profile_dir):
    files = sorted(f for f in os.listdir(profile_dir)
                   if f.endswith(".pt.trace.json"))
    assert len(files) == 1 and files[0].startswith("rank0."), files
    with open(os.path.join(profile_dir, files[0])) as f:
        trace = json.load(f)
    return [e.get("name", "") for e in trace["traceEvents"]]


@pytest.mark.parametrize("steps", [12, 7])
def test_train_cli_profiler_hook_writes_its_trace(tmp_path, capsys, steps):
    """--io.profile_dir traces steps 5 to 10: one trace file of rank 0 with
    the step's operators in it, and "profile written to" on stderr; a run
    that ends inside the window (7 steps) writes its trace too."""
    from dssm_tpu_torch.cli import train as cli_train

    prof = str(tmp_path / "prof")
    cli_train.main(SMALL + [f"--train.max_steps={steps}",
                            f"--io.workdir={tmp_path / 'run'}",
                            f"--io.profile_dir={prof}"])
    assert f"profile written to {prof}" in capsys.readouterr().err
    names = _trace_events(prof)
    # The tower's products and the loss's logsumexp: the step's own ops.
    assert any(n in ("aten::mm", "aten::addmm") for n in names)
    assert "aten::logsumexp" in names


def _comm_kind(name):
    for k in ("compact gather", "doc-pool all-gather", "reduce-scatter",
              "compact-grad psum", "dense-grad psum", "pmean"):
        if k in name:
            return k
    raise AssertionError(name)


def test_comm_model_terms_and_efficiency():
    """tests/test_tools.py's assertions on dssm_tpu's model, on the
    port's."""
    cfg = tcfg.get_preset("multihost")
    terms = tcomm.step_collectives(cfg, dp=8, mp=2)
    names = [t.name for t in terms]
    assert any("compact gather" in n for n in names)
    assert any("doc-pool all-gather" in n for n in names)
    assert any("reduce-scatter" in n for n in names)
    assert any("compact-grad psum" in n for n in names)
    eff_base, exp_base, _ = tcomm.scaling_efficiency(15.0, cfg, 8, 2)
    eff_mit, exp_mit, _ = tcomm.scaling_efficiency(
        15.0, cfg, 8, 2, sel_basis_grad=True, collective_itemsize=2)
    assert exp_mit < exp_base and eff_mit > eff_base
    assert not any("(mp)" in t.name or "gather (mp" in t.name
                   for t in tcomm.step_collectives(cfg, dp=8, mp=1))
    assert tcomm.step_collectives(cfg, dp=1, mp=1) == []
    # Every collective is synchronous in the port: all exposed.
    assert all(t.exposed for t in terms)
    # The multihost step's own options: slot spaces, a bf16 wire.
    assert tcomm.step_options(cfg) == dict(sel_basis_grad=True,
                                           collective_itemsize=2)


@pytest.mark.parametrize("options", [{}, dict(sel_basis_grad=True,
                                              collective_itemsize=2)],
                         ids=["group_padded_f32", "sel_basis_bf16"])
@pytest.mark.parametrize("dp,mp", [(8, 2), (8, 1), (1, 2), (1, 1)])
def test_comm_model_payloads_match_dssm_tpu(dp, mp, options):
    """Each term both models list carries the same bytes; the port adds
    the loss's pmean (4 f32 values) and counts the dense gradients
    exactly, where dssm_tpu's model approximates them."""
    from dssm_tpu_torch.models import base as tbase

    cfg = tcfg.get_preset("multihost")
    want = {_comm_kind(t.name): t for t in jcomm.step_collectives(
        jcfg.get_preset("multihost"), dp, mp, **options)}
    got = {_comm_kind(t.name): t for t in tcomm.step_collectives(
        cfg, dp, mp, **options)}
    assert set(got) == set(want) | ({"pmean"} if dp > 1 else set())
    for k, w in want.items():
        if k != "dense-grad psum":
            assert got[k].mbytes == w.mbytes, k
    if dp > 1:
        assert got["pmean"].mbytes == 16 / 1e6
        params = tbase.init_params(
            cfg.tower.replace(vocab_size=64), device="cpu")["shared"]
        dense = sum(v.numel() * 4 for k, v in params.items() if k != "W0")
        assert got["dense-grad psum"].mbytes == dense / 1e6


def test_comm_model_links():
    """Which link an axis rides follows from the data-major rank grid:
    at dp = 8 x mp = 2 on nodes of 8 GPUs the model group stays on a node
    (NVLink), the data group spans two (InfiniBand)."""
    assert tcomm.axis_bandwidth("model", 8, 2) == tcomm.NVLINK_BW
    assert tcomm.axis_bandwidth("data", 8, 2) == tcomm.IB_BW
    assert tcomm.axis_bandwidth("data", 8, 1) == tcomm.NVLINK_BW
    assert tcomm.axis_bandwidth("data", 8, 2, gpus_per_node=16) == (
        tcomm.NVLINK_BW)
    with pytest.raises(ValueError, match="no all-gather"):
        tcomm.step_collectives(tcfg.get_preset("multihost"), 8, 2,
                               gather_allgather=True)


def _texts():
    pairs = jtoy.make_toy_pairs(300, 64, 5)
    return pairs.queries + pairs.titles + ["Ünïcode Kelvin \u212a caf\u00e9"]


@pytest.mark.parametrize("vocab", [97, 4096, 500_000])
def test_collision_stats_match_dssm_tpu(vocab):
    texts = _texts()
    assert (ttrigram.collision_stats(texts, vocab)
            == jtrigram.collision_stats(texts, vocab))


def test_dense_from_fixed_matches_dssm_tpu():
    texts = _texts()
    idx, wgt = ttrigram.hash_batch(texts, 4096, 16)
    got = ttrigram.dense_from_fixed(idx, wgt, 4096)
    np.testing.assert_array_equal(
        got, jtrigram.dense_from_fixed(idx, wgt, 4096))
    assert got[:, 0].max() == 0 and got.sum() == wgt.sum() - wgt[
        idx == 0].sum()


@pytest.mark.parametrize("corpus", ["toy", "tsv"])
def test_vocab_stats_prints_what_dssm_tpu_prints(tmp_path, capsys, corpus):
    """dssm_tpu_torch.tools.vocab_stats against the repository root's
    tools/vocab_stats.py with the same flags: the same stdout."""
    from dssm_tpu_torch.tools import vocab_stats

    flags = ["--vocab=3000,30000", "--batch=128", "--num-batches=4",
             "--max-pairs=1500"]
    if corpus == "tsv":
        path = str(tmp_path / "pairs.tsv")
        write_tsv(jtoy.make_toy_pairs(900, 128, 2), path)
        flags.append(f"--path={path}")
    r = subprocess.run([sys.executable, "tools/vocab_stats.py", *flags],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    capsys.readouterr()
    vocab_stats.main(flags)
    got = capsys.readouterr().out
    assert got == r.stdout
    assert "suggest data.max_unique_rows=" in got


PROFILE_STAGES = [
    "null (an eager iteration's floor)", "gather (union)",
    "fused gather + joint lookup", "joint lookup alone", "count lookup q + d",
    "gather + lookup fwd (2 launches)", "+ towers + loss fwd", "+ backward",
    "WHOLE STEP", "library, not the port's path: joint lookup as count "
    "matrices", "library, not the port's path: count lookup q + d as count "
    "matrices"]


def test_profile_components_runs_every_stage(capsys):
    """tools/profile_components.py --cpu --preset=tiny: every stage on an
    f32 and on a bf16 table, through the plain versions."""
    from dssm_tpu_torch.tools import profile_components

    rows = profile_components.main(["--cpu", "--preset=tiny", "--iters=2",
                                    "--warmup=1"])
    out = capsys.readouterr().out
    assert "on cpu" in out
    for tag, scatter in (("f32", "add"), ("bf16", "SR")):
        for stage in PROFILE_STAGES + [f"scatter (union, {scatter})"]:
            assert f"[{tag}] {stage} " in out, (tag, stage)
    assert len(rows) == 2 * (len(PROFILE_STAGES) + 1)
    assert all(us > 0 and busy is None for _, _, us, busy in rows)


def test_host_plane_bench_runs_every_part(capsys):
    """tools/host_plane_bench.py at a tiny size: the itemized stages, the
    pipeline widths and the epoch cache."""
    from dssm_tpu_torch.tools import host_plane_bench

    host_plane_bench.main(["--pairs=8192", "--global-batch=4096",
                           "--reps=1", "--batches=2", "--workers=0,2"])
    out = capsys.readouterr().out
    for line in ("global two-level dedupe + local slice (C++)",
                 "sort_batch_rows", "reslot_local (cap 2048 x 1 shard)",
                 "compress_wire", "TOTAL per batch (serial, itemized)",
                 "pipeline W=0:", "pipeline W=2:", "epoch cache: epoch-1"):
        assert line in out, line
    assert "8 processes of 512 rows" in out
