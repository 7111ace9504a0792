"""The eval kernels' timing script (dssm_tpu_torch/tools/eval_kernels.py) on
a machine without a GPU: it says so and exits non-zero, building nothing."""

import torch

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.tools import eval_kernels


def test_eval_kernels_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["eval_kernels", "--source", "old=x"])
    monkeypatch.setattr(_build, "compile_library", None)  # never reached
    assert eval_kernels.main() == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
