"""The kernel timing script (dssm_tpu_torch/tools/eval_kernels.py) on a
machine without a GPU: it says so and exits non-zero, building nothing; and
it builds this tree's sources first, then each other build's; and its
scatter bound counts each real group once."""

import os

import pytest
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


def test_scatter_add_bound_counts_each_real_group_once():
    # 107 real f32 groups of 8 x 384 rows among 256 slots: each real group
    # read and written once and its vals read once (12 bytes an element),
    # and every slot's id (4 bytes); a skip slot moves nothing else.
    hbm = eval_kernels.HBM_BYTES_PER_S
    assert eval_kernels.add_bound_us(107, 256, 8 * 384, 4) == pytest.approx(
        (107 * 8 * 384 * 12 + 256 * 4) / hbm * 1e6)
    # bf16 table and vals: 6 bytes an element.
    assert eval_kernels.add_bound_us(54, 256, 16 * 384, 2) == pytest.approx(
        (54 * 16 * 384 * 6 + 256 * 4) / hbm * 1e6)
    assert eval_kernels.add_bound_us(0, 1024, 8 * 1024, 4) == pytest.approx(
        1024 * 4 / hbm * 1e6)
    # The stochastic-rounding scatters read f32 vals whatever the table.
    assert eval_kernels.scatter_bytes(27, 256, 32 * 384, 1, 4) == (
        27 * 32 * 384 * 6 + 256 * 4)
