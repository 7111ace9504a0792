"""The tower sweep script (dssm_tpu_torch/tools/tower_tiles.py) on a machine
without a GPU: it says so and exits non-zero, building nothing."""

import torch

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.tools import tower_tiles


def test_tower_tiles_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["tower_tiles"])
    monkeypatch.setattr(_build, "compile_library", None)  # never reached
    assert tower_tiles.main() == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
