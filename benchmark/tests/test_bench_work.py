"""The work counts against values worked out by hand."""

from __future__ import annotations

import pytest

from benchmark.work import counts

FULL = {"embed_width": 300, "hidden_dims": [300], "semantic_dim": 128}
TINY = {"embed_width": 40, "hidden_dims": [48], "semantic_dim": 32}


def test_peaks():
    assert counts.PEAKS["matmul_flops_per_s"] == 989e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_full_step():
    items = {i.name: i for i in counts.train_step(FULL, 1024, 60000, 800)}
    # towers: 2048 rows, 300x300 + 300x128, forward and two backward
    assert items["towers"].flops == 3 * 2 * 2048 * (90000 + 38400)
    # the B^2 loss: logits, dq, dd
    assert items["loss"].flops == 3 * 2 * 1024 * 1024 * 128
    assert items["lookup"].flops == 2 * 60000 * 300
    assert items["lookup"].bytes == 8 * 60000 + 4 * 300 * 800 \
        + 4 * 300 * 2048
    assert items["table_update"].bytes == 2 * 4 * 300 * 800
    total = counts.flops(items.values())
    assert total == pytest.approx(2.4e9, rel=0.05)


def test_tiny_step_and_bound():
    items = counts.train_step(TINY, 64, 1000, 300)
    towers = [i for i in items if i.name == "towers"][0]
    assert towers.flops == 3 * 2 * 128 * (40 * 48 + 48 * 32)
    loss = [i for i in items if i.name == "loss"][0]
    # at 64 rows the loss is bound by reading q, d and writing both
    # gradients, not by its 3 * 2 * 64^2 * 32 FLOPs
    assert loss.flops == 3 * 2 * 64 * 64 * 32
    assert loss.least_s() == 4 * 4 * 64 * 32 / 3.35e12
    full_loss = [i for i in counts.train_step(FULL, 65536, 1, 1)
                 if i.name == "loss"][0]
    assert full_loss.least_s() == full_loss.flops / 989e12
    table = [i for i in items if i.name == "table_update"][0]
    assert table.least_s() == 2 * 4 * 40 * 300 / 3.35e12


def test_eval_and_serve():
    ev = {i.name: i for i in counts.eval_pass(FULL, 65536, 5e6, [800] * 64)}
    assert ev["rank"].flops == 2 * 65536 ** 2 * 128
    assert ev["lookup"].bytes == 8 * 5e6 + 4 * 300 * 800 * 64 \
        + 4 * 300 * 2 * 65536
    sv = {i.name: i for i in counts.serve_request(FULL, 256, 5000, 400,
                                                  1 << 20, 10)}
    assert sv["score_topk"].flops == 2 * 256 * (1 << 20) * 128
    # reading the index bounds the score: 512 MiB at 3.35 TB/s
    assert sv["score_topk"].least_s() == pytest.approx(
        (4 * (1 << 20) * 128 + 4 * 256 * 128 + 12 * 256 * 10) / 3.35e12)
