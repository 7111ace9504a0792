"""The training cells time their own copy of train/loop.train's loop body
(train() makes and captures a new compiled step on every call). This
holds the copy to the program: both make the same calls, in the same
order and with the same arguments, step by step."""

from __future__ import annotations

import torch

from benchmark.tests.tiny import make_root, measure

STEPS = 3


def _recorder(monkeypatch, log, made):
    """Log the calls of train()'s loop body: the stream's next(),
    add_rotation_offsets, batch_to_device and the step; `made` keeps the
    loader's arguments so that the program can be fed the same stream."""
    from dssm_tpu_torch import bridge
    from dssm_tpu_torch.data import loader
    from dssm_tpu_torch.train import loop

    real_iter, real_rot = loader.batch_iterator, loop.add_rotation_offsets
    real_b2d, real_make = bridge.batch_to_device, loop.make_train_step

    def logged(it):
        for b in it:
            log.append(("next",))
            yield b

    def batch_iterator(*a, **kw):
        made.setdefault("args", (a, kw))
        return logged(real_iter(*a, **kw))

    def add_rotation_offsets(batch, cfg, step):
        log.append(("add_rotation_offsets", step))
        return real_rot(batch, cfg, step)

    def batch_to_device(batch, dev, **kw):
        log.append(("batch_to_device", str(dev), sorted(kw.items())))
        return real_b2d(batch, dev, **kw)

    def make_train_step(cfg, *a, **kw):
        log.append(("make_train_step", a, sorted(kw.items())))
        step = real_make(cfg, *a, **kw)

        def logged_step(state, batch):
            log.append(("step",))
            return step(state, batch)
        return logged_step

    monkeypatch.setattr(loader, "batch_iterator", batch_iterator)
    monkeypatch.setattr(loop, "add_rotation_offsets", add_rotation_offsets)
    monkeypatch.setattr(bridge, "batch_to_device", batch_to_device)
    monkeypatch.setattr(loop, "batch_to_device", batch_to_device)
    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    return real_iter


def test_harness_loop_matches_train(monkeypatch, tmp_path):
    from benchmark import core
    from benchmark.entries import common
    from dssm_tpu_torch.train import loop
    from dssm_tpu_torch.train.state import create_run_state

    root = make_root(str(tmp_path))
    harness, made = [], {}
    real_iter = _recorder(monkeypatch, harness, made)
    res, checks, _ = measure(root, "tiny.train", seed=5)
    assert res["correct"], checks

    program = []
    _recorder(monkeypatch, program, {})
    cfg = core.run_config(core.load_cell(root, "tiny.train"))
    params = common.program_params(cfg, core.tower_of(cfg), 5,
                                   torch.device("cpu"))
    a, kw = made["args"]
    stream = real_iter(*a, **kw)

    def logged():
        for b in stream:
            program.append(("next",))
            yield b

    loop.train(cfg, create_run_state(cfg, params), logged(), STEPS)
    assert len(program) == 1 + 4 * STEPS
    assert harness[:len(program)] == program
