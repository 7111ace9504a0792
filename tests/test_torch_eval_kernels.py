"""The kernel timing script (dssm_tpu_torch/tools/eval_kernels.py) on a
machine without a GPU: it says so and exits non-zero, building nothing; and
it builds this tree's sources first, then each other build's."""

import os

import torch

from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.tools import eval_kernels


def test_eval_kernels_needs_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["eval_kernels", "--source", "old=x"])
    monkeypatch.setattr(_build, "compile_library", None)  # never reached
    assert eval_kernels.main() == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


def test_eval_kernels_builds_this_tree_first(monkeypatch):
    # Every case group names sources this tree's csrc/ holds; build() always
    # compiles them first, then each --source, into a library of its own.
    calls = []
    monkeypatch.setattr(_build, "compile_library",
                        lambda srcs, out: calls.append((srcs, out)) or out)
    for group, (sources, _) in eval_kernels.GROUPS.items():
        assert all(os.path.isfile(os.path.join(_build.CSRC, s))
                   for s in sources)
        calls.clear()
        libs = eval_kernels.build([("old", "elsewhere")], sources, group)
        assert list(libs) == ["tree", "old"]
        assert sorted(srcs[0] for srcs, _ in calls) == sorted([
            os.path.join(_build.CSRC, sources[0]),
            os.path.join(os.path.abspath("elsewhere"), sources[0])])
        assert len({out for _, out in calls}) == 2
        assert all(os.sep + group + os.sep in out for _, out in calls)
