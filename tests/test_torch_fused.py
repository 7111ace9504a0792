"""The fused gather + joint lookup of dssm_tpu_torch against dssm_tpu on the
CPU, and the joint-dedupe training step that runs it.

The port's fused_gather_joint_lookup takes the plain version here (CPU
tensors): the row-group gather, then the joint lookup. dssm_tpu's
fused_gather_joint_lookup runs its Pallas kernel in interpret mode.

Tolerances. q_out and d_out: rtol 1e-5 / atol 1e-5 on an f32 table (f32 sums
in another order). On a bf16 table the reference rounds each count (the sum
of a row's weights on one compact row) to bf16 before its product; with
integer weights, as the loader makes them, the counts are exact and the
tolerance stays rtol 1e-5. With real-valued weights each count may move by
half a bf16 ulp (2^-9 of itself), so an output moves by up to 2^-9 of
sum_j |cnt_j| |row_j|: held to 2^-8 of that sum. The compact block's real
rows are copies (bit-equal) and its empty slots' rows zero. The backward:
the port's joint_lookup_bwd against the reference's from the reference fused
lookup's own count residuals, rtol 1e-4 / atol 1e-4 (as the reference's own
test holds it to autodiff). The step: three joint steps through the fused
route against the split route (gather, then the joint lookup differentiated
at the compact block), composed here by hand from the same functions the
step called before: the forwards are the same plain functions, the gradient
sums the same products in the same order, so losses and tables are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.kernels.pallas_count import (
    fused_gather_joint_lookup as j_fused, joint_lookup_bwd as j_bwd)
from dssm_tpu.kernels.pallas_gather import force_interpret
from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import configs as tcfg
from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.kernels.count import count_matrix
from dssm_tpu_torch.kernels.dedup_embed import (
    dequant_compact, gather_compact, joint_lookup_from_compact)
from dssm_tpu_torch.kernels.gather import sublane_group
from dssm_tpu_torch.kernels.joint import (
    fused_gather_joint_lookup, joint_lookup_bwd, select_rows_plain)
from dssm_tpu_torch.loss.cosine_softmax import in_batch_loss
from dssm_tpu_torch.models import base as tbase
from dssm_tpu_torch.train import sparse_update as tsparse
from dssm_tpu_torch.train.state import (
    TrainState, apply_updates, create_run_state, optimizer_update)
from dssm_tpu_torch.train.loop import make_train_step

V, H, SLOTS, REAL, U2, ROWS, KQ, KD = 4096, 128, 64, 40, 128, 256, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(dtype, int_weights, seed=14):
    """The reference test's shapes (tests/test_pallas_kernels.py): 64 slots
    of which 40 real and 24 sentinels, 100 live sel slots padded with 0."""
    rng = np.random.default_rng(seed)
    group = sublane_group(dtype)
    table = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(
        dtype)
    uniq = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    uniq[:REAL] = np.sort(rng.choice(V // group, size=REAL, replace=False))
    sel = np.zeros((U2,), np.int32)
    sel[:100] = np.sort(rng.choice(REAL * group, size=100, replace=False))
    q_inv = rng.integers(0, U2, (ROWS, KQ)).astype(np.int32)
    d_inv = rng.integers(0, U2, (ROWS, KD)).astype(np.int32)
    if int_weights:
        q_wgt = rng.integers(0, 3, (ROWS, KQ)).astype(np.float32)
        d_wgt = rng.integers(0, 3, (ROWS, KD)).astype(np.float32)
    else:
        q_wgt = rng.uniform(0, 2, (ROWS, KQ)).astype(np.float32)
        d_wgt = rng.uniform(0, 2, (ROWS, KD)).astype(np.float32)
    return table, group, [uniq, sel, q_inv, q_wgt, d_inv, d_wgt]


def _reference(table, group, arrays):
    jt = jnp.asarray(table.float().numpy()).astype(
        jnp.bfloat16 if table.dtype == torch.bfloat16 else jnp.float32)
    with force_interpret():
        out = j_fused(jt, *(jnp.asarray(a) for a in arrays), group)
    assert out is not None
    return out


@pytest.mark.parametrize("dtype,int_weights", [
    (torch.float32, False), (torch.bfloat16, True), (torch.bfloat16, False)],
    ids=["f32", "bf16-integer-weights", "bf16-real-weights"])
def test_fused_lookup_matches_dssm_tpu(dtype, int_weights):
    table, group, arrays = _inputs(dtype, int_weights)
    qo, do, _, _, compact = _reference(table, group, arrays)
    uniq, sel, q_inv, q_wgt, d_inv, d_wgt = (torch.from_numpy(a)
                                             for a in arrays)
    lq, ld, c = fused_gather_joint_lookup(table, uniq, sel, q_inv, q_wgt,
                                          d_inv, d_wgt, group)
    assert c.dtype == dtype and c.shape == (SLOTS * group, H)
    assert lq.dtype == ld.dtype == torch.float32
    assert lq.shape == (ROWS, H) and ld.shape == (ROWS, H)
    real = REAL * group
    want_c = np.asarray(compact.astype(jnp.float32))
    assert np.array_equal(c[:real].float().numpy(), want_c[:real])
    assert not c[real:].any()
    for got, want, inv, wgt in ((lq, qo, q_inv, q_wgt),
                                (ld, do, d_inv, d_wgt)):
        want = np.array(want)
        if int_weights or dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        else:
            rows = select_rows_plain(c.float(), sel).abs()
            bound = 2.0 ** -8 * (count_matrix(inv, wgt, U2).abs() @ rows)
            assert bool(((got - torch.from_numpy(want)).abs()
                         <= bound + 1e-5).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_joint_lookup_bwd_matches_dssm_tpu(dtype):
    """The port's backward needs only sel, inv and wgt; the reference's
    reads the count residuals of its fused lookup."""
    table, group, arrays = _inputs(dtype, True)
    _, _, cnt_q, cnt_d, _ = _reference(table, group, arrays)
    rng = np.random.default_rng(15)
    gq = rng.normal(size=(ROWS, H)).astype(np.float32)
    gd = rng.normal(size=(ROWS, H)).astype(np.float32)
    gr = SLOTS * group
    with force_interpret():
        want = j_bwd(jnp.asarray(arrays[1]), cnt_q, cnt_d, jnp.asarray(gq),
                     jnp.asarray(gd), gr, H, jnp.float32)
    _, sel, q_inv, q_wgt, d_inv, d_wgt = (torch.from_numpy(a) for a in arrays)
    got = joint_lookup_bwd(sel, q_inv, q_wgt, d_inv, d_wgt,
                           torch.from_numpy(gq), torch.from_numpy(gd), gr)
    assert got.dtype == torch.float32 and got.shape == (gr, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fused_lookup_refusals():
    table, group, arrays = _inputs(torch.float32, True)
    args = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="f32 or bf16"):
        fused_gather_joint_lookup(table.to(torch.int8), *args, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_gather_joint_lookup(table, *args, group, impl="kernel")
    # Not differentiable: the caller differentiates at the outputs.
    outs = fused_gather_joint_lookup(table.requires_grad_(True), *args, group)
    assert not any(o.requires_grad for o in outs)


def _cfg(table_dtype):
    """The `full` preset's shape (mlp, shared towers, bf16 compute, union
    dedupe, Kq < Kd) at narrow widths."""
    c = tcfg.get_preset("full")
    return tcfg.validate(c.replace(
        tower=c.tower.replace(vocab_size=V, embed_width=100,
                              hidden_dims=(64,), semantic_dim=32,
                              table_dtype=table_dtype),
        data=c.data.replace(max_trigrams=16, max_trigrams_query=8,
                            max_unique=1024, max_unique_rows=128,
                            freq_remap=False),
        train=c.train.replace(batch_size=128)))


def _batches(cfg, n):
    hashed = hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data)
    it = batch_iterator(hashed, 128, seed=3,
                        dedup_unique=cfg.data.max_unique,
                        dedup_group=sublane_group(
                            tbase.torch_dtype(cfg.tower.table_dtype)),
                        dedup_unique_rows=cfg.data.max_unique_rows,
                        dedup_joint=True, wire_compress=True, sort_rows=True)
    return [batch_to_torch(next(it), "cpu") for _ in range(n)]


def _split_step(cfg, state, batch):
    """The joint step as it ran before the fused route, on the same
    functions: the gather outside autograd (dequantized for an int8 table),
    then the joint lookup, the stacked tower and the loss differentiated at
    the compact block."""
    compute = tbase.torch_dtype(cfg.tower.compute_dtype)
    table = state.params["shared"]["W0"]
    scale = state.params["shared"].get("W0_scale")
    group = sublane_group(table.dtype)
    dense = {"shared": {k: v.detach().requires_grad_(True)
                        for k, v in state.params["shared"].items()
                        if k not in ("W0", "W0_scale")}}
    c = gather_compact(table, batch["uniq"], group)
    if scale is not None:
        c = dequant_compact(c, scale, batch["uniq"], group)
    c.requires_grad_(True)
    lq, ld = joint_lookup_from_compact(
        c, batch["sel"], batch["q_inv"], batch["q_wgt"], batch["d_inv"],
        batch["d_wgt"], compute)
    qd = tbase.embed_from_lookup(dense, cfg.tower, "q", batch,
                                 torch.cat([lq, ld], dim=0))
    loss, aux = in_batch_loss(qd[:lq.shape[0]], qd[lq.shape[0]:],
                              cfg.loss.gamma)
    leaves = list(dense["shared"].values())
    g_c, *g_leaves = torch.autograd.grad(loss, [c] + leaves)
    with torch.no_grad():
        g_dense = {"shared": dict(zip(dense["shared"], g_leaves))}
        updates, opt = optimizer_update(cfg.train, g_dense, state.opt_state)
        params = apply_updates(dense, updates)
        vals = tsparse.table_update_vals(cfg, g_c, c.detach())
        tsparse.apply_table_update(table, batch["uniq"], vals,
                                   state.step * 4, scale,
                                   cfg.train.table_stochastic_round)
    params["shared"]["W0"] = table
    if scale is not None:
        params["shared"]["W0_scale"] = scale
    return TrainState(step=state.step + 1, params=params,
                      opt_state=opt), aux


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_fused_joint_step_matches_split_step(table_dtype, monkeypatch):
    cfg = _cfg(table_dtype)
    batches = _batches(cfg, 3)
    calls = []
    fused = tsparse.fused_gather_joint_lookup

    def counted(*args, **kw):
        calls.append(1)
        return fused(*args, **kw)

    monkeypatch.setattr(tsparse, "fused_gather_joint_lookup", counted)
    init = tbase.init_params(cfg.tower, seed=0, device="cpu")
    states = [create_run_state(cfg, {"shared": {
        k: v.clone() for k, v in init["shared"].items()}}) for _ in range(2)]
    step = make_train_step(cfg)
    for batch in batches:
        states[0], aux_f = step(states[0], batch)
        states[1], aux_s = _split_step(cfg, states[1], batch)
        assert float(aux_f["loss"]) == float(aux_s["loss"])
    assert len(calls) == 3
    for k, want in states[1].params["shared"].items():
        assert torch.equal(states[0].params["shared"][k], want), k
    assert not torch.equal(states[0].params["shared"]["W0"],
                           init["shared"]["W0"])


def test_int8_joint_step_keeps_the_split_route(monkeypatch):
    """An int8 table's step gathers and dequantizes its compact block, so
    it never reaches the fused lookup; differentiated at the lookups, its
    three steps equal the route differentiated at the compact block."""
    cfg = _cfg("int8")
    batches = _batches(cfg, 3)

    def refused(*args, **kw):
        raise AssertionError("an int8 step reached the fused lookup")

    monkeypatch.setattr(tsparse, "fused_gather_joint_lookup", refused)
    init = tbase.init_params(cfg.tower, seed=0, device="cpu")
    states = [create_run_state(cfg, {"shared": {
        k: v.clone() for k, v in init["shared"].items()}}) for _ in range(2)]
    step = make_train_step(cfg)
    for batch in batches:
        states[0], aux = step(states[0], batch)
        states[1], aux_s = _split_step(cfg, states[1], batch)
        assert np.isfinite(float(aux["loss"]))
        assert float(aux["loss"]) == float(aux_s["loss"])
    assert states[0].step == 3
    for k, want in states[1].params["shared"].items():
        assert torch.equal(states[0].params["shared"][k], want), k
    assert not torch.equal(states[0].params["shared"]["W0"],
                           init["shared"]["W0"])
