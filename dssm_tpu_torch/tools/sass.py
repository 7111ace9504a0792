"""Instruction counts of a built kernel, from its SASS, and the issue bound
they give.

`cuobjdump -sass` (beside nvcc in the CUDA toolkit) disassembles the shared
library the port builds. A thread of a kernel with no loop issues each
instruction of its listing at most once, so the listing's counts over the
elements a thread updates are the instructions an element costs.
`issue_bound_us` turns them into the least time the card's SMs take to
issue them, by the rates of each class of instruction on compute
capability 9.0 (CUDA C++ Programming Guide, "Arithmetic Instructions"):
128 fp32 results a clock an SM (add, multiply, fma, compare, min / max), 64
for 32-bit integer work (add, multiply-add, shift, logic, byte permute,
compare, select), 16 for the other conversions (I2F, F2I, FRND, F2F) and
the special functions, and at most four warp instructions issued a clock an
SM (128 thread instructions), whatever their class.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

# Results a clock an SM, by class (compute capability 9.0).
RATES = {"all": 128, "fp32": 128, "int": 64, "conv": 16}
_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FSET", "FSEL", "FMNMX", "FMUL32I",
         "FADD32I", "FFMA32I"}
_INT = {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT",
        "ISETP", "SEL", "LEA", "IMNMX", "IABS", "POPC", "FLO", "BMSK", "SGXT",
        "IMUL", "I2FP", "F2IP", "VIADD", "VIMNMX", "IADD32I", "IMAD32I",
        "LOP32I", "PLOP3", "P2R", "R2P", "BREV", "MOV", "MOV32I"}
_CONV = {"I2F", "F2I", "FRND", "F2F", "I2I", "MUFU"}

_INSN = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def cuobjdump() -> Optional[str]:
    """The toolkit's cuobjdump, or None."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def functions(text: str) -> Dict[str, List[str]]:
    """{mangled name: [opcode, ...]} of a `cuobjdump -sass` listing (each
    opcode without its modifiers)."""
    out: Dict[str, List[str]] = {}
    ops: List[str] = []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            ops = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and out:
            ops.append(m.group(1))
    return out


def classes(ops: List[str]) -> Dict[str, int]:
    """Instruction counts by class: all (NOPs left out), fp32, int, conv.
    Uniform-datapath instructions (U...) take an issue slot only."""
    out = dict.fromkeys(RATES, 0)
    for op in ops:
        if op == "NOP":
            continue
        out["all"] += 1
        for key, names in (("int", _INT), ("fp32", _FP32), ("conv", _CONV)):
            if op in names:
                out[key] += 1
    return out


def counts(text: str, *name_parts: str) -> Dict[str, int]:
    """Instruction counts by class of the one function whose mangled name
    holds each of `name_parts`."""
    funcs = functions(text)
    names = [n for n in funcs if all(p in n for p in name_parts)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} functions hold {name_parts}")
    return classes(funcs[names[0]])


def library_counts(lib: str, kernels: Dict[str, Tuple[str, ...]]
                   ) -> Dict[str, Dict[str, int]]:
    """{key: counts(name parts)} for each (key, name parts) of `kernels` in
    the shared library `lib`."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found (set CUDA_HOME)")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {key: counts(text, *parts) for key, parts in kernels.items()}


def issue_bound_us(per_element: Dict[str, float], elements: int, sms: int,
                   clock_hz: float) -> float:
    """Least time, in us, for `sms` SMs at `clock_hz` to issue
    `per_element` instructions (by class) for each of `elements`."""
    clocks = max(per_element.get(k, 0.0) / rate for k, rate in RATES.items())
    return clocks * elements / sms / clock_hz * 1e6
