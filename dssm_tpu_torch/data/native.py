"""Build, load and call the port's C++ host data plane.

native/dssm_native.cpp holds the letter-trigram hashing and the two-level
batch dedupe, bit-equal to their plain Python / numpy versions
(data/trigram.py, data/dedupe.py). On first use it is compiled with g++
into dssm_tpu_torch/build/ and loaded with ctypes; it is rebuilt when the
source is newer than the library. Nothing is built at import time.

Each build writes a file of its own and renames it into place, so processes
that build at once each load a whole library. A failed build or load raises
with the compiler's output: no switch turns the C++ path off on the main
path. ctypes releases the GIL for the length of each call, so the loader's
pool threads run these calls side by side.

Every wrapper of the plane takes impl="auto" | "plain": "auto" is the C++
path on every device (this is host code), "plain" the Python / numpy
version, which the tests and chip_smoke.py compare it with.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "dssm_native.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_NAME = "libdssm_host.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "dssm_hash_batch": [_P, _P, _I64, _I64, _INT, _INT, _P, _P],
    "dssm_hash_batch_sequence": [_P, _P, _I64, _I64, _INT, _INT, _INT, _P,
                                 _P, _P],
    "dssm_dedupe_two_level": [_P, _I64, _P, _I64, _I64, _I64, ctypes.c_int32,
                              _P, _P, _P, _P],
}
# The C entry points' error codes.
_ERRORS = {1: "bad shape or cap", 2: "a negative index"}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def resolve(impl: str, name: str) -> str:
    """"native" or "plain" for a host wrapper: "auto" is "native"."""
    if impl == "auto":
        return "native"
    if impl == "plain":
        return impl
    raise ValueError(f"{name}: unknown impl {impl!r} (use 'auto' or 'plain')")


def library_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def build(force: bool = False) -> str:
    """Compile the source into the shared library if it is missing or older
    than the source (or if force); returns its path. Raises RuntimeError,
    with the compiler's output, when the compiler fails or cannot run."""
    lib = library_path()
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(SOURCE)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{LIB_NAME}.", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        os.remove(tmp)
        raise RuntimeError(f"the C++ host data plane did not build: "
                           f"{' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"the C++ host data plane did not build: "
                           f"{' '.join(cmd)} exited {r.returncode}:\n"
                           f"{r.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        return _lib


def _call(fn: str, *args) -> None:
    rc = getattr(load(), fn)(*args)
    if rc != 0:
        raise ValueError(f"{fn}: {_ERRORS.get(rc, f'error {rc}')}")


def _text_buffer(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """The texts lowercased by str.lower(), UTF-8 encoded, end to end, and
    the [n + 1] int64 offsets of each."""
    enc = [t.lower().encode("utf-8", "surrogatepass") for t in texts]
    offsets = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    return b"".join(enc), offsets


def _check_vocab(vocab_size: int) -> None:
    if vocab_size < 2:
        raise ValueError(f"vocab_size {vocab_size}: ids hash into "
                         "[1, vocab_size), which needs at least 2")


def hash_batch(texts: Sequence[str], vocab_size: int, k: int,
               normalize: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [n, k] int32, weights [n, k] f32), as trigram.hash_batch."""
    _check_vocab(vocab_size)
    buf, offsets = _text_buffer(texts)
    n = len(offsets) - 1
    idx = np.empty((n, k), dtype=np.int32)
    wgt = np.empty((n, k), dtype=np.float32)
    _call("dssm_hash_batch", buf, offsets.ctypes.data, n, vocab_size, k,
          int(normalize), idx.ctypes.data, wgt.ctypes.data)
    return idx, wgt


def hash_batch_sequence(texts: Sequence[str], vocab_size: int, t: int,
                        kw: int, normalize: bool,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indices [n, t, kw], weights [n, t, kw], mask [n, t]), as
    trigram.hash_batch_sequence."""
    _check_vocab(vocab_size)
    buf, offsets = _text_buffer(texts)
    n = len(offsets) - 1
    idx = np.empty((n, t, kw), dtype=np.int32)
    wgt = np.empty((n, t, kw), dtype=np.float32)
    mask = np.empty((n, t), dtype=np.float32)
    _call("dssm_hash_batch_sequence", buf, offsets.ctypes.data, n,
          vocab_size, t, kw, int(normalize), idx.ctypes.data,
          wgt.ctypes.data, mask.ctypes.data)
    return idx, wgt, mask


def dedupe_two_level(a: np.ndarray, b: Optional[np.ndarray],
                     g_cap_rows: int, u2_cap: int, group: int,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """The two-level dedupe of a's lookups then b's (b None: a alone), as
    dedupe.dedupe_two_level_plain of their concatenation: (uniq_groups
    [g_cap_rows // group], row_sel [u2_cap], inv2 [na + nb] int32,
    keep [na + nb] f32). group is a power of two; indices are >= 0."""
    if group <= 0 or group & (group - 1) or g_cap_rows <= 0 or \
            g_cap_rows % group or u2_cap <= 0:
        raise ValueError(f"dedupe_two_level: group {group} must be a power "
                         f"of two dividing g_cap_rows {g_cap_rows}, and "
                         f"u2_cap {u2_cap} positive")
    a = np.ascontiguousarray(a, dtype=np.int32).reshape(-1)
    b = (np.zeros(0, dtype=np.int32) if b is None
         else np.ascontiguousarray(b, dtype=np.int32).reshape(-1))
    n = a.size + b.size
    uniq = np.empty(g_cap_rows // group, dtype=np.int32)
    sel = np.empty(u2_cap, dtype=np.int32)
    inv2 = np.empty(n, dtype=np.int32)
    keep = np.empty(n, dtype=np.float32)
    _call("dssm_dedupe_two_level", a.ctypes.data, a.size, b.ctypes.data,
          b.size, g_cap_rows, u2_cap, group, uniq.ctypes.data,
          sel.ctypes.data, inv2.ctypes.data, keep.ctypes.data)
    return uniq, sel, inv2, keep
