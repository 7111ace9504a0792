"""Time the eval path's two heaviest kernels, the count lookup forward
(csrc/count.cu) and the rank count (csrc/rank.cu), beside other builds of
them, on one NVIDIA GPU.

    python -m dssm_tpu_torch.tools.eval_kernels [--source NAME=DIR ...]

Builds count.cu and rank.cu as they stand and, for each --source, the
count.cu and rank.cu in DIR (the same C entry points, e.g. an earlier
commit's csrc/), all at once; holds every build to the plain versions and
says whether its outputs are bit-equal to this tree's build; then times each
with CUDA-graph replays (median of 11 replays of 20 calls, 5 for the rank
count; L2-warm), builds in turns, forward then backward through the list:

  - the count lookup at the `full` shapes: a 1024 x 384 compact2 (bf16 and
    f32), 1024 rows of K = 64 and of 32 lookups, about half live; and at
    narrow widths no preset has (bf16 h = 100, f32 h = 36);
  - at the cnn and lstm eval shapes: the first union-dedupe batch of the
    cnn toy corpus (16384 word rows of 8 a side) into bf16 compact2 blocks
    1024 (cnn) and 384 (lstm) wide;
  - the rank count over unit vectors of width 128 at 3276 (the smoke's eval
    pass), 6553 (`full`'s eval pairs) and 13107 (`multihost`'s).

Beside them, once a case: the plain version, and PyTorch calls as
yardsticks: the count matrix built and multiplied into compact2 (the same
function), and for the rank count `(q @ d.T > t).sum(1)` (the same
function) and cuBLAS's f32 product `q @ d.T` alone (TF32 off).

Prints the card's name and power limit, one line per case and a JSON line
last. Needs one GPU; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import get_preset, validate
from dssm_tpu_torch.data import (
    batch_iterator, hash_pairs, make_toy_pairs, train_eval_split)
from dssm_tpu_torch.kernels import _build, count, rank

SOURCES = ("count.cu", "rank.cu")


def build(dirs):
    """{name: path of its shared library}, compiled in parallel."""
    builds = {"tree": _build.CSRC}
    builds.update({n: os.path.abspath(p) for n, p in dirs})
    out = os.path.join(_build.BUILD_DIR, "eval_kernels")
    with ThreadPoolExecutor(len(builds)) as ex:
        return dict(zip(builds, ex.map(
            lambda kv: _build.compile_library(
                [os.path.join(kv[1], s) for s in SOURCES],
                os.path.join(out, kv[0], "libeval.so")),
            builds.items())))


def graph_ms(fn, reps=20, replays=11):
    """Device ms per call: `reps` calls in a CUDA graph, median replay."""
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
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def cases(dev, rng):
    """(name, kernel call, plain call, tolerance check, reps, {yardstick
    name: PyTorch call}) per case."""
    def lookup_case(name, c2, inv, wgt):
        def near(got, want):
            if c2.dtype == torch.float32:
                return bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5
                             * float(want.abs().max())).all())
            return bool(((got - want).abs() <= 1e-2 * want.norm(
                dim=-1, keepdim=True)).all())
        return (name, lambda: count.count_lookup(c2, inv, wgt, impl="kernel"),
                lambda: count.count_lookup_plain(c2, inv, wgt), near, 20,
                {"library": lambda: count.count_matrix(
                    inv, wgt, c2.shape[0]) @ c2.float()})

    out = []
    for k in (64, 32):
        inv = rng.integers(0, 1024, size=(1024, k)).astype(np.int32)
        wgt = rng.integers(1, 4, size=(1024, k)).astype(np.float32)
        wgt[np.arange(k)[None, :] >= rng.integers(0, k + 1, size=(1024, 1))] = 0
        inv, wgt = torch.from_numpy(inv).to(dev), torch.from_numpy(wgt).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            c2 = torch.from_numpy(rng.normal(size=(1024, 384)).astype(
                np.float32)).to(dev, dtype)
            out.append(lookup_case(f"count_lookup full K={k} "
                                   f"{str(dtype).split('.')[-1]}", c2, inv,
                                   wgt))
    # Narrow rows no preset has: bf16 h = 100 (no whole 16-byte vectors: one
    # column at a time) and f32 h = 36 (9 vectors a row), K = 32.
    for h, dtype in ((100, torch.bfloat16), (36, torch.float32)):
        c2 = torch.from_numpy(rng.normal(size=(1024, h)).astype(
            np.float32)).to(dev, dtype)
        out.append(lookup_case(f"count_lookup K=32 h={h} "
                               f"{str(dtype).split('.')[-1]}", c2, inv, wgt))
    sc = validate(get_preset("cnn"))
    pairs = make_toy_pairs(sc.data.toy_num_pairs, sc.data.toy_vocab_words,
                           sc.data.seed)
    train_p, _ = train_eval_split(pairs, eval_frac=sc.data.eval_frac,
                                  seed=sc.data.seed)
    tb = batch_to_torch(next(batch_iterator(
        hash_pairs(train_p, sc.tower, sc.data), sc.train.batch_size, True,
        seed=sc.train.seed, dedup_unique=sc.data.max_unique, dedup_group=8,
        dedup_unique_rows=sc.data.max_unique_rows, dedup_joint=True)), dev)
    for arch, h in (("cnn", 1024), ("lstm", 384)):
        c2 = torch.from_numpy(rng.normal(size=(tb["sel"].numel(), h)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for side in ("d", "q"):
            inv = tb[f"{side}_inv"].contiguous()
            wgt = tb[f"{side}_wgt"].contiguous()
            out.append(lookup_case(
                f"count_lookup {arch} {side} side bf16 ({int((wgt != 0).sum())}"
                " live)", c2, inv, wgt))
    for n in (3276, 6553, 13107):
        q = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
            size=(n, 128)).astype(np.float32)).to(dev), dim=1)
        d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
            size=(n, 128)).astype(np.float32)).to(dev), dim=1)
        d = torch.nn.functional.normalize(d + 0.35 * q, dim=1).contiguous()
        gap = (q @ d.T - rank.true_scores(q, d)[:, None]).abs()
        gap[torch.arange(n), torch.arange(n)] = 1.0
        ties = (gap < 1e-5).sum(dim=1).to(torch.int32)
        del gap
        t = rank.true_scores(q, d)[:, None]
        out.append((f"rank_counts {n} x {n} x 128",
                    lambda q=q, d=d: rank.rank_counts(q, d, impl="kernel"),
                    lambda q=q, d=d: rank.rank_counts_plain(q, d),
                    lambda got, want, ties=ties: bool(
                        ((got - want).abs() <= ties).all()), 5,
                    {"library": lambda q=q, d=d, t=t: (q @ d.T > t).sum(1),
                     "cublas_product_alone": lambda q=q, d=d: q @ d.T}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=DIR", help="a csrc/ with another count.cu "
                    "and rank.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eval_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build([s.split("=", 1) for s in args.source])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 yardsticks
    results = {}
    for name, kernel, plain, near, reps, calls in cases(
            dev, np.random.default_rng(0)):
        want = plain()
        row, same, ref = {}, {}, None
        order = list(libs) + list(reversed(list(libs)))
        for i, build_name in enumerate(order):
            _build.load(libs[build_name])  # the wrappers launch through it
            got = kernel()
            torch.cuda.synchronize()
            if not near(got, want):
                raise RuntimeError(f"{build_name}, {name}: differs from the "
                                   "plain version beyond its tolerance")
            ref = got if ref is None else ref
            same[build_name] = bool(torch.equal(got, ref))
            row.setdefault(build_name, []).append(
                round(graph_ms(kernel, reps=reps) * 1e3, 2))
            if i == len(libs) - 1:
                for call_name, call in {"plain": plain, **calls}.items():
                    row[call_name] = [round(graph_ms(call, reps=reps) * 1e3,
                                            2)]
        results[name] = dict(us=row, bit_equal_to_tree=same)
        print(f"{name} (us, each build twice): {json.dumps(results[name])}",
              flush=True)
    _build.load(_build.build())
    print(json.dumps({"eval_kernels_us": results,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
