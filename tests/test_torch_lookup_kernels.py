"""The kernel timing script's lookup case group
(dssm_tpu_torch/tools/eval_kernels.py --cases lookup) on a machine without a
GPU: it says so and exits non-zero, building nothing; and the count
backward's bound it states counts each input and output once."""

import torch

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.tools import eval_kernels


def test_lookup_kernels_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["eval_kernels", "--cases", "lookup",
                                      "--source", "old=x"])
    monkeypatch.setattr(_build, "compile_library", None)  # never reached
    assert eval_kernels.main() == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


def test_lookup_kernels_bound_and_widths():
    # 1 MB at 3.35 TB/s against 0.5 M FMAs at 67 TFLOP/s: bytes bound it.
    assert abs(eval_kernels.bound_us(1e6, 5e5) - 1e6 / 3.35e12 * 1e6) < 1e-9
    # 2 G FMAs at 67 TFLOP/s: operations bound it.
    assert abs(eval_kernels.bound_us(0, 2e9) - 4e9 / 67e12 * 1e6) < 1e-9
    # The model tables' lane-padded widths: `full` 300 -> 384, cnn 900 -> 1024.
    assert eval_kernels.padded(300) == 384
    assert eval_kernels.padded(900) == 1024
    assert eval_kernels.padded(384) == 384
