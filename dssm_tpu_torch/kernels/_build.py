"""Build, load and launch the port's CUDA kernels.

The sources under dssm_tpu_torch/csrc/ expose a plain C interface. On first
use they are compiled with nvcc for sm_90a (one nvcc per source, all started
together), linked into one shared library under dssm_tpu_torch/build/, and
loaded with ctypes. The library is rebuilt when a source or a header is newer
than it.
Nothing is built at import time: the CPU tests import every module without
nvcc.

Every kernel wrapper counts its launches here, so a run can show which
kernels its main path went through. A launch made while the current stream
captures a CUDA graph runs nothing: it is counted apart (captured_launches),
and whoever replays the graph adds those counts at every replay
(add_launches), so a replayed step counts what an eager one does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("gather.cu", "count.cu", "tower.cu", "joint.cu", "loss.cu",
           "scatter.cu", "scatter_sr.cu", "rank.cu", "embed.cu")
# lookup.cuh: included by joint.cu and the two below; lookup_fwd.cuh (the
# lookup forward): by count.cu and embed.cu; segsum.cuh (the lookup
# backward: sort and segmented sum): by count.cu and joint.cu; sm90.cuh: by
# tower.cu, loss.cu, rank.cu, scatter.cu and scatter_sr.cu.
HEADERS = ("lookup.cuh", "lookup_fwd.cuh", "segsum.cuh", "sm90.cuh")
LIB_NAME = "libdssm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
# C signatures of csrc/*.cu (every pointer, and the stream, as c_void_p).
_SIGNATURES = {
    "dssm_gather_row_groups": [_P, _P, _P, _I64, _I64, _I64, _P],
    "dssm_count_lookup": [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _P],
    "dssm_count_lookup_bwd": [_P, _P, _P, _P, _P, _I64, _I64, _INT, _INT,
                              _INT, _INT, _P],
    "dssm_count_lookup_bwd_workspace": [_I64, _INT, _INT, _INT],
    "dssm_dense_tower": [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                         ctypes.POINTER(_P), ctypes.POINTER(_INT), _INT, _I64,
                         _INT, _INT, _INT, ctypes.c_float, _P],
    "dssm_joint_lookup": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT,
                          _INT, _INT, _INT, _INT, _P],
    "dssm_joint_lookup_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                              _I64, _INT, _INT, _INT, _INT, _INT, _INT, _P],
    "dssm_joint_lookup_bwd_workspace": [_I64, _INT, _INT, _INT, _INT],
    "dssm_fused_gather_joint_lookup": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _I64, _INT, _INT, _INT, _INT, _INT,
                                       _I64, _INT, _INT, _P],
    "dssm_in_batch_loss_fwd": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _INT,
                               ctypes.c_float, _P],
    "dssm_in_batch_loss_dq": [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT,
                              ctypes.c_float, _P],
    "dssm_in_batch_loss_dd": [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT,
                              ctypes.c_float, _P],
    "dssm_scatter_add_row_groups": [_P, _P, _P, _I64, _I64, _I64, _P],
    "dssm_scatter_add_bf16_row_groups": [_P, _P, _P, _I64, _I64, _I64, _P],
    "dssm_scatter_sr_bf16_row_groups": [_P, _P, _P, _I64, _I64, _I64, _P,
                                        _P],
    "dssm_scatter_sr_int8_row_groups": [_P, _P, _P, _I64, _I64, _I64, _P,
                                        _P],
    "dssm_rank_counts": [_P, _P, _P, _P, _I64, _I64, _INT, _P],
    "dssm_embedding_bag": [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _P],
    "dssm_embedding_bag_dwgt": [_P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT,
                                _INT, _P],
}

# Return types other than the launchers' int (a CUDA error code).
_RESTYPES = {"dssm_joint_lookup_bwd_workspace": _I64,
             "dssm_count_lookup_bwd_workspace": _I64}

# One name per counted entry point. dense_tower_residuals is the tower's
# training call (the same C function, asked for its per-layer residuals).
KERNELS = ("gather_row_groups", "count_lookup", "dense_tower",
           "joint_lookup", "joint_lookup_bwd", "count_lookup_bwd",
           "dense_tower_residuals", "in_batch_loss", "in_batch_loss_dq",
           "in_batch_loss_dd", "scatter_add_row_groups",
           "scatter_sr_row_groups", "scatter_sr_int8_row_groups",
           "rank_counts", "embedding_bag", "embedding_bag_bwd",
           "fused_gather_joint_lookup")
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# Launches recorded into the CUDA graph being captured.
_captured: Dict[str, int] = {name: 0 for name in KERNELS}
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def captured_launches(reset: bool = False) -> Dict[str, int]:
    """The launches recorded under graph capture since the last reset (a
    graph's kernels, when reset before its capture)."""
    with _lock:
        out = dict(_captured)
        if reset:
            for name in _captured:
                _captured[name] = 0
    return out


def add_launches(counts: Dict[str, int]) -> None:
    """Count a replay's launches (a captured graph's captured_launches)."""
    with _lock:
        for name, n in counts.items():
            _launches[name] += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from dssm_tpu_torch/csrc on first use")


def _run_all(cmds: List[List[str]], logs: List[str]) -> None:
    """Run the commands in parallel; raise with the log of any that fail."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd, stdout=f,
                                           stderr=subprocess.STDOUT), log))
    failed = [log for p, log in procs if p.wait() != 0]
    if failed:
        text = ""
        for log in failed:
            with open(log) as f:
                text += f.read()
        raise RuntimeError(f"nvcc failed:\n{text}")


def library_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def compile_library(srcs: Sequence[str], lib: str) -> str:
    """Compile the CUDA sources `srcs` (one nvcc each, all started together)
    and link them into the shared library `lib`; nvcc's output goes to
    nvcc_<source>.log beside it. Returns `lib`."""
    out = os.path.dirname(lib)
    os.makedirs(out, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    names = [os.path.splitext(os.path.basename(s))[0] for s in srcs]
    objs = [os.path.join(out, f"{n}.{tag}.o") for n in names]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
              for src, obj in zip(srcs, objs)],
             [os.path.join(out, f"nvcc_{n}.log") for n in names])
    tmp = f"{lib}.{tag}.tmp"
    _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp, *objs]], [os.path.join(out, "nvcc_link.log")])
    os.replace(tmp, lib)
    for obj in objs:
        os.remove(obj)
    return lib


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into the shared library if it is missing or older
    than a source; returns its path."""
    lib = library_path()
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    newest = max(os.path.getmtime(s) for s in
                 srcs + [os.path.join(CSRC, h) for h in HEADERS])
    if not force and os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return lib
    return compile_library(srcs, lib)


def ptxas_report(sources=SOURCES) -> str:
    """The register / shared-memory / spill lines nvcc printed per kernel
    of `sources` (file names under csrc/)."""
    lines = []
    for s in sources:
        log = os.path.join(BUILD_DIR, f"nvcc_{os.path.splitext(s)[0]}.log")
        if os.path.exists(log):
            with open(log) as f:
                lines += [ln.rstrip() for ln in f
                          if "registers" in ln or "spill" in ln
                          or "Compiling entry" in ln]
    return "\n".join(lines)


def load(path: Optional[str] = None) -> ctypes.CDLL:
    """The library the wrappers launch through: the kernels built from
    csrc/ on first use, or, given `path`, the shared library there from now
    on (another build of some of the same C entry points)."""
    global _lib
    with _lock:
        if _lib is None or path is not None:
            lib = ctypes.CDLL(path or build())
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = _RESTYPES.get(fn,
                                                             ctypes.c_int)
            _lib = lib
        return _lib


def resolve_impl(impl: str, t: torch.Tensor, name: str) -> str:
    """"kernel" or "plain" for a wrapper given tensor `t`.

    "auto" launches the kernel for a CUDA tensor and takes the plain version
    for a CPU tensor; "kernel" refuses a CPU tensor; "plain" is the plain
    PyTorch version on any device.
    """
    if impl == "auto":
        return "kernel" if t.is_cuda else "plain"
    if impl == "kernel":
        if not t.is_cuda:
            raise RuntimeError(f"{name}: impl='kernel' needs CUDA tensors, "
                               f"got a tensor on {t.device}")
        return impl
    if impl == "plain":
        return impl
    raise ValueError(f"{name}: unknown impl {impl!r} "
                     "(use 'auto', 'kernel' or 'plain')")


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call C function `fn` on `device`'s current stream, raise on a CUDA
    error it reports, and count one launch of kernel `name` (among the
    captured ones while that stream captures a graph)."""
    lib = load()
    with torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        rc = getattr(lib, fn)(*args, current.cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    with _lock:
        (_captured if capturing else _launches)[name] += 1


def query(fn: str, *args) -> int:
    """Call C function `fn`, which launches nothing (a size query), and
    return its result; counts no launch."""
    return getattr(load(), fn)(*args)


def check_cuda(name: str, device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
