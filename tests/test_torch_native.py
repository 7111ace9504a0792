"""The port's C++ host data plane (dssm_tpu_torch/native/dssm_native.cpp,
built and loaded by data/native.py) against its plain Python / numpy
versions and against dssm_tpu's, on the CPU: trigram hashing (bag and
per-word, normalized or not) and the two-level dedupe (one side and the
union of both, at the presets' caps, over either cap, and from several
threads at once), all
bit-equal. A build that fails raises; nothing falls back to Python."""

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dssm_tpu.data import native as jnative
from dssm_tpu.data import toy as jtoy
from dssm_tpu.data import trigram as jtrigram
from dssm_tpu.kernels import dedup_embed as jdedup
from dssm_tpu_torch.data import dedupe as tdedup
from dssm_tpu_torch.data import native
from dssm_tpu_torch.data import trigram as ttrigram

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 30_000
KELVIN = "Kelvin test"  # the Kelvin sign lowercases to an ASCII "k"
DOTTED_I = "İstanbul"  # "İ" lowercases to "i" and a combining dot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _texts():
    pairs = jtoy.make_toy_pairs(160, 96, 4)
    return pairs.queries + pairs.titles + [
        "", "A", "MiXeD CaSe!! it's a don't-stop 123 test", "word " * 50,
        "élève café ünïcode wörds", "x" * 300, "aaa aaa aaa bbb",
        KELVIN, DOTTED_I, "K", "ΟΔΟΣ odos", "tab\tand\nnewline",
        "a\ud800b"]


@pytest.mark.parametrize("k,normalize", [(8, False), (32, False),
                                         (64, False), (16, True)])
def test_hash_batch_bit_equal(k, normalize):
    texts = _texts()
    idx, wgt = ttrigram.hash_batch(texts, VOCAB, k, normalize)
    p_idx, p_wgt = ttrigram.hash_batch(texts, VOCAB, k, normalize,
                                       impl="plain")
    assert idx.dtype == np.int32 and wgt.dtype == np.float32
    assert idx.flags.writeable and wgt.flags.writeable
    np.testing.assert_array_equal(idx, p_idx)
    np.testing.assert_array_equal(wgt, p_wgt)
    for b, text in enumerate(texts):  # dssm_tpu's Python hashing
        j_idx, j_wgt = jtrigram.hash_text(text, VOCAB, k, normalize)
        np.testing.assert_array_equal(idx[b], j_idx)
        np.testing.assert_array_equal(wgt[b], j_wgt)


@pytest.mark.parametrize("normalize", [False, True])
def test_hash_batch_sequence_bit_equal(normalize):
    texts = _texts()
    got = ttrigram.hash_batch_sequence(texts, VOCAB, 6, 8, normalize)
    plain = ttrigram.hash_batch_sequence(texts, VOCAB, 6, 8, normalize,
                                         impl="plain")
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for b, text in enumerate(texts):
        for a, want in zip((x[b] for x in got),
                           jtrigram.hash_text_sequence(text, VOCAB, 6, 8,
                                                       normalize)):
            np.testing.assert_array_equal(a, want)


def test_unicode_lowercasing_follows_python():
    """str.lower() maps the Kelvin sign to "k" and "İ" to "i" and a
    combining dot (which ends the word, as any non-ASCII letter does): the
    port's C++ path hashes those texts as Python does. dssm_tpu's C++
    tokenizer lowers ASCII only and differs there."""
    for text, ascii_text in ((KELVIN, "kelvin test"),
                             (DOTTED_I, "i stanbul")):
        got = ttrigram.hash_batch([text], VOCAB, 16)
        np.testing.assert_array_equal(
            got[0], ttrigram.hash_batch([ascii_text], VOCAB, 16)[0])
        np.testing.assert_array_equal(
            got[0][0], jtrigram.hash_text(text, VOCAB, 16)[0])
        ref = jnative.hash_batch([text], VOCAB, 16)
        if ref is not None:  # dssm_tpu's C++ plane, where it built
            assert not np.array_equal(ref[0], got[0])
    with pytest.raises(ValueError, match="vocab_size"):
        ttrigram.hash_batch(["a"], 1, 4)
    with pytest.raises(ValueError, match="impl"):
        ttrigram.hash_batch(["a"], VOCAB, 4, impl="kernel")


def _ids(rng, shape, vocab, zipf=1.3):
    """Hashed-id-like lookups: Zipf-skewed ids in [1, vocab), a fifth 0."""
    ids = (rng.zipf(zipf, size=shape) * 7919) % (vocab - 1) + 1
    ids[rng.random(shape) < 0.2] = 0
    return ids.astype(np.int32)


def _j_joint(q, d, g_cap, u2, group):
    """dssm_tpu's numpy dedupe of the union, split as the joint call's."""
    uniq, sel, inv2, keep = jdedup.dedupe_two_level_numpy(
        np.concatenate([q.reshape(-1), d.reshape(-1)]), g_cap, u2, group)
    n = q.size
    return (uniq, sel, inv2[:n].reshape(q.shape), inv2[n:].reshape(d.shape),
            keep[:n].reshape(q.shape), keep[n:].reshape(d.shape))


def _assert_same(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# (q shape, d shape, vocab, g_cap_rows, u2_cap, group): the `full` joint
# batch at its caps (f32 and bf16 groups), the tiny preset's, the cnn
# union batch's at a few hundred rows, and both caps overflowing.
_CASES = [
    ((1024, 32), (1024, 64), 500_000, 2048, 1024, 8),
    ((1024, 32), (1024, 64), 500_000, 4096, 1024, 16),
    ((256, 64), (256, 64), 30_000, 8192, 1024, 8),
    ((128, 16, 8), (128, 16, 8), 30_000, 8192, 1024, 8),
    ((256, 32), (256, 64), 30_000, 256, 96, 8),
]


@pytest.mark.parametrize("case", _CASES)
def test_dedupe_bit_equal(case):
    q_shape, d_shape, vocab, g_cap, u2, group = case
    rng = np.random.default_rng(sum(q_shape) + g_cap)
    q, d = _ids(rng, q_shape, vocab), _ids(rng, d_shape, vocab)
    joint = tdedup.dedupe_two_level_joint(q, d, g_cap, u2, group)
    _assert_same(joint,
                 tdedup.dedupe_two_level_joint(q, d, g_cap, u2, group,
                                               impl="plain"),
                 _j_joint(q, d, g_cap, u2, group))
    one = tdedup.dedupe_two_level(d, g_cap, u2, group)
    _assert_same(one, tdedup.dedupe_two_level_plain(d, g_cap, u2, group),
                 jdedup.dedupe_two_level_numpy(d, g_cap, u2, group))
    assert one[2].flags.writeable and one[3].flags.writeable
    if case[-2:] == (96, 8):  # both caps overflow
        assert (joint[0] < tdedup.SKIP_SENTINEL_GID).all()
        assert joint[4].min() == 0 and joint[5].min() == 0


@pytest.mark.parametrize("caps", [(8192, 1024), (1024, 256)])
def test_dedupe_concurrent_bit_equal(caps):
    """cnn-sized union batches (2 x 1024 x 16 x 8 lookups), deduped by 1 and
    by 4 threads at once as the loader's pool does (the C++ call releases
    the GIL), each give numpy's bits, within and over the caps."""
    g_cap, u2 = caps
    rng = np.random.default_rng(7)
    sides = [tuple(_ids(rng, (1024, 16, 8), VOCAB) for _ in range(2))
             for _ in range(4)]
    want = [_j_joint(q, d, g_cap, u2, 8) for q, d in sides]
    for threads in (1, 4):
        with ThreadPoolExecutor(max_workers=threads) as pool:
            got = list(pool.map(
                lambda qd: tdedup.dedupe_two_level_joint(*qd, g_cap, u2, 8),
                sides))
        for g, w in zip(got, want):
            _assert_same(g, w)


def test_dedupe_refusals():
    idx = np.array([[1, 2], [3, -4]], dtype=np.int32)
    with pytest.raises(ValueError, match="negative"):
        tdedup.dedupe_two_level(idx, 64, 16, 8)
    with pytest.raises(ValueError, match="power of two"):
        tdedup.dedupe_two_level(np.abs(idx), 60, 16, 12)
    with pytest.raises(ValueError, match="impl"):
        tdedup.dedupe_two_level(np.abs(idx), 64, 16, 8, impl="numpy")


@pytest.mark.parametrize("compiler", ["missing", "false"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """A compiler that is missing or fails: the wrappers raise, with the
    command, and write no library; impl="plain" still runs."""
    build = tmp_path / "build"
    if os.path.isdir(native.BUILD_DIR):
        shutil.copytree(native.BUILD_DIR, build)
    (build / native.LIB_NAME).unlink(missing_ok=True)
    cxx = str(tmp_path / "g++") if compiler == "missing" else "false"
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="did not build"):
        ttrigram.hash_batch(["plain text ok"], VOCAB, 8)
    with pytest.raises(RuntimeError, match="did not build"):
        tdedup.dedupe_two_level(np.ones((2, 2), np.int32), 64, 16, 8)
    assert not (build / native.LIB_NAME).exists()
    assert not [p for p in os.listdir(build) if p.endswith(".tmp")]
    idx, _ = ttrigram.hash_batch(["plain text ok"], VOCAB, 8, impl="plain")
    assert idx[0, 0] > 0


def test_six_processes_build_at_once(tmp_path):
    """Six processes start the build into one empty directory together:
    each loads a whole library and hashes with it."""
    code = (
        "import sys\n"
        "from dssm_tpu_torch.data import native, trigram\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "idx, _ = trigram.hash_batch(['plain text ok'], 30000, 8)\n"
        "print(int(idx[0, 0]))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    want = str(int(ttrigram.hash_batch(["plain text ok"], VOCAB, 8)[0][0, 0]))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == want
    assert sorted(os.listdir(tmp_path)) == [native.LIB_NAME]
