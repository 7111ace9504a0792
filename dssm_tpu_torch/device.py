"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU; with no GPU
and no request for the CPU they raise instead of silently running on the
host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def as_device(device: DeviceLike) -> torch.device:
    """torch.device for `device`, refusing a CUDA device that is not there.

    Also turns TF32 off for CUDA matmuls, so float32 products (the top-k
    score matrix, the plain kernel versions) stay float32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --cpu (CLI) or "
                "device='cpu' (library) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_device(cpu: bool) -> torch.device:
    """The CPU when asked for, else the GPU (raising when there is none)."""
    return as_device("cpu" if cpu else "cuda")
