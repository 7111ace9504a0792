"""Each kernel module of dssm_tpu_torch against dssm_tpu's Pallas kernel in
interpret mode: the plain PyTorch versions on the CPU (the CUDA kernels are
held to those plain versions on a GPU by tests/test_torch_cuda.py).

Tolerances: the gather and the scatter move or add the same values
(exact); the count and joint lookups, the loss and the tower only sum in
another order (f32: rtol 1e-5 of the largest value; bf16 tower: 2e-2, one
bf16 rounding of an intermediate apart; its bf16 weight gradients 2e-2 of
their largest value, one bf16 rounding). Gradients are those of
sum(output * g) for a seeded g, taken by jax.grad through the Pallas kernel's
custom VJP and by autograd through the plain version.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dssm_tpu.kernels import dedup_embed as jdedup
from dssm_tpu.kernels.pallas_count import (
    count_lookup_pallas, joint_lookup_pallas)
from dssm_tpu.kernels.pallas_gather import (
    force_interpret, gather_row_groups, scatter_add_row_groups)
from dssm_tpu.kernels.pallas_loss import in_batch_loss_pallas
from dssm_tpu.kernels.pallas_tower import dense_tower_pallas
from dssm_tpu.loss.cosine_softmax import in_batch_loss_xla
from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID, dedupe_two_level_joint
from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.kernels import dedup_embed as tdedup
from dssm_tpu_torch.kernels.count import (
    count_lookup, count_lookup_bwd, count_lookup_bwd_plain, count_lookup_plain)
from dssm_tpu_torch.kernels.gather import (
    gather_row_groups as t_gather, gather_row_groups_plain,
    scatter_add_row_groups as t_scatter)
from dssm_tpu_torch.kernels.joint import joint_lookup, joint_lookup_bwd
from dssm_tpu_torch.kernels.loss import (
    in_batch_loss_dd, in_batch_loss_dq, in_batch_loss_grads_plain,
    in_batch_nll, in_batch_nll_plain)
from dssm_tpu_torch.kernels.tower import dense_tower, dense_tower_plain
from dssm_tpu_torch.loss.cosine_softmax import (
    in_batch_loss, in_batch_loss_composed)

V, H, GROUP, SLOTS = 4096, 128, 8, 64


# 64 slots in steps of 8 (the Pallas kernel's unit): two all-real steps, one
# mixed, the rest sentinel; f32 and bf16 tables.
@pytest.mark.parametrize("dtype,group", [("float32", 8), ("bfloat16", 16)])
def test_gather_plain_matches_pallas(dtype, group):
    rng = np.random.default_rng(group)
    table = rng.normal(size=(V, H)).astype(np.float32)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:19] = np.sort(rng.choice(V // group, 19, replace=False))
    jt = jnp.asarray(table).astype(dtype)
    want = np.asarray(gather_row_groups(jt, jnp.asarray(gids), group,
                                        interpret=True, groups_per_step=8)
                      .astype(jnp.float32))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = gather_row_groups_plain(tt, torch.from_numpy(gids), group)
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[19 * group:].any()  # sentinel slots are zero rows


def _ragged(rng, rows, k, u2):
    inv = rng.integers(0, u2, size=(rows, k)).astype(np.int32)
    wgt = rng.integers(1, 4, size=(rows, k)).astype(np.float32)
    nnz = rng.integers(0, k + 1, size=(rows,))
    wgt[np.arange(k)[None, :] >= nnz[:, None]] = 0.0  # ragged prefixes
    inv[np.arange(k)[None, :] >= nnz[:, None]] = u2 - 1  # junk past them
    wgt[5, 2] = 0.0  # an interior zero (a dropped lookup)
    wgt[17] = 0.0  # a fully dropped row
    return inv, wgt


# (rows, k, u2, h): the small preset, K-chunk skip over ragged rows, and the
# multihost caps, where the Pallas kernel runs u2-blocked.
@pytest.mark.parametrize("shape", [(64, 16, 128, 128), (256, 32, 128, 128),
                                   (256, 8, 8192, 384)])
def test_count_plain_matches_pallas(shape):
    rows, k, u2, h = shape
    rng = np.random.default_rng(rows + k)
    compact2 = rng.normal(size=(u2, h)).astype(np.float32)
    inv, wgt = _ragged(rng, rows, k, u2)
    want = np.asarray(count_lookup_pallas(
        jnp.asarray(compact2), jnp.asarray(inv), jnp.asarray(wgt),
        interpret=True))
    got = count_lookup_plain(torch.from_numpy(compact2), torch.from_numpy(inv),
                             torch.from_numpy(wgt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_count_plain_bf16_matches_pallas():
    rng = np.random.default_rng(3)
    c32 = rng.normal(size=(128, 128)).astype(np.float32)
    c16 = c32.astype(ml_dtypes.bfloat16)
    inv, wgt = _ragged(rng, 64, 16, 128)
    want = np.asarray(count_lookup_pallas(
        jnp.asarray(c16), jnp.asarray(inv), jnp.asarray(wgt), interpret=True))
    got = count_lookup_plain(
        torch.from_numpy(c16.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(inv), torch.from_numpy(wgt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _tower_inputs(rng, dtype):
    dims = (40, 64, 32)
    x = rng.uniform(-1, 1, size=(64, dims[0])).astype(np.float32)
    layers = [(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32) * 0.2,
               rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1)
              for i in range(len(dims) - 1)]
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        layers = [(w.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16))
                  for w, b in layers]
    return x, layers


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("normalize", [True, False])
def test_tower_plain_matches_pallas(dtype, tol, activation, normalize):
    rng = np.random.default_rng(5)
    x, layers = _tower_inputs(rng, dtype)
    with force_interpret():
        want = np.asarray(dense_tower_pallas(
            jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b))
                             for w, b in layers], activation, normalize))
    got = dense_tower_plain(_t(x), [(_t(w), _t(b)) for w, b in layers],
                            activation, normalize)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _joint_batch(rng):
    q = rng.integers(1, V, size=(64, 8)).astype(np.int32)
    d = rng.integers(1, V, size=(64, 16)).astype(np.int32)
    d[:, 12:] = 0
    uniq, sel, q_inv, d_inv, q_keep, d_keep = dedupe_two_level_joint(
        q, d, 16 * GROUP, 128, GROUP)  # 16 slots: overflows both caps
    q_wgt = rng.integers(1, 3, size=q.shape).astype(np.float32) * q_keep
    d_wgt = (d != 0).astype(np.float32) * d_keep
    return uniq, sel, q_inv, q_wgt, d_inv, d_wgt


def _dedup_bag_pair(table, uniq, inv, wgt, row_sel, compute_dtype, jax_impl):
    with force_interpret():
        want = np.asarray(jdedup.dedup_embedding_bag(
            jnp.asarray(table), jnp.asarray(uniq), jnp.asarray(inv),
            jnp.asarray(wgt), jnp.dtype(compute_dtype), GROUP, impl=jax_impl,
            row_sel=None if row_sel is None else jnp.asarray(row_sel)))
    got = tdedup.dedup_embedding_bag(
        torch.from_numpy(table), torch.from_numpy(uniq), torch.from_numpy(inv),
        torch.from_numpy(wgt), getattr(torch, compute_dtype), GROUP,
        impl="auto",
        row_sel=None if row_sel is None else torch.from_numpy(row_sel))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dedup_embedding_bag_matches_dssm_tpu(compute_dtype):
    """Both sides of a joint batch, and a lookup without row selection."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(V, H)).astype(np.float32)
    uniq, sel, q_inv, q_wgt, d_inv, d_wgt = _joint_batch(rng)
    for inv, wgt, row_sel in ((q_inv, q_wgt, sel), (d_inv, d_wgt, sel),
                              (d_inv, d_wgt, None)):
        _dedup_bag_pair(table, uniq, inv, wgt, row_sel, compute_dtype, "xla")


def test_dedup_embedding_bag_matches_dssm_tpu_pallas():
    """dssm_tpu's Pallas gather + count kernels (interpret mode)."""
    rng = np.random.default_rng(10)
    table = rng.normal(size=(V, H)).astype(np.float32)
    uniq, sel, _, _, d_inv, d_wgt = _joint_batch(rng)
    _dedup_bag_pair(table, uniq, d_inv, d_wgt, sel, "float32", "pallas")


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_count_backward_plain_matches_pallas(dtype):
    rows, k, u2, h = 64, 16, 128, 128
    rng = np.random.default_rng(31)
    c2 = rng.normal(size=(u2, h)).astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    inv, wgt = _ragged(rng, rows, k, u2)
    g = rng.normal(size=(rows, h)).astype(np.float32)

    def jloss(c):
        out = count_lookup_pallas(c, jnp.asarray(inv), jnp.asarray(wgt),
                                  interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(c2)).astype(jnp.float32))
    tc2 = _t(c2).requires_grad_(True)
    out = count_lookup(tc2, torch.from_numpy(inv), torch.from_numpy(wgt))
    (out * torch.from_numpy(g)).sum().backward()
    assert tc2.grad.dtype == tc2.dtype
    # bf16: the gradient is rounded to compact2's dtype, one ulp apart.
    _close(tc2.grad.float().numpy(), want,
           1e-5 if dtype == "float32" else 1e-2)
    direct = count_lookup_bwd_plain(torch.from_numpy(inv),
                                    torch.from_numpy(wgt),
                                    torch.from_numpy(g), u2)
    _close(direct.numpy(), want, 1e-5 if dtype == "float32" else 1e-2)


def _joint_inputs(rng, rows=64, kq=8, kd=16, u2=128, gr=128, h=128, used=90):
    """A row selection whose padding (zeros) aliases compact row 0, which a
    real slot (slot 0) also selects."""
    sel = np.zeros((u2,), np.int32)
    sel[:used] = np.sort(rng.choice(gr, used, replace=False))
    sel[0] = 0
    q_inv, q_wgt = _ragged(rng, rows, kq, used)
    d_inv, d_wgt = _ragged(rng, rows, kd, used)
    q_inv[0, 0], q_wgt[0, 0] = 0, 2.0  # slot 0 -> compact row 0 is live
    compact = rng.normal(size=(gr, h)).astype(np.float32)
    g_q = rng.normal(size=(rows, h)).astype(np.float32)
    g_d = rng.normal(size=(rows, h)).astype(np.float32)
    return compact, sel, q_inv, q_wgt, d_inv, d_wgt, g_q, g_d


def test_joint_lookup_plain_matches_pallas_forward_and_backward():
    rng = np.random.default_rng(32)
    compact, sel, q_inv, q_wgt, d_inv, d_wgt, g_q, g_d = _joint_inputs(rng)
    j = [jnp.asarray(a) for a in (sel, q_inv, q_wgt, d_inv, d_wgt)]

    def jloss(c):
        lq, ld = joint_lookup_pallas(c, *j, interpret=True)
        return jnp.sum(lq * jnp.asarray(g_q)) + jnp.sum(ld * jnp.asarray(g_d))

    want_q, want_d = joint_lookup_pallas(jnp.asarray(compact), *j,
                                         interpret=True)
    want_dc = np.asarray(jax.grad(jloss)(jnp.asarray(compact)))
    t = [torch.from_numpy(a) for a in (sel, q_inv, q_wgt, d_inv, d_wgt)]
    tc = torch.from_numpy(compact).requires_grad_(True)
    lq, ld = joint_lookup(tc, *t)
    _close(lq.detach().numpy(), want_q)
    _close(ld.detach().numpy(), want_d)
    ((lq * torch.from_numpy(g_q)).sum()
     + (ld * torch.from_numpy(g_d)).sum()).backward()
    _close(tc.grad.numpy(), want_dc)
    # Row 0 is selected by slot 0 and by every padding slot: its gradient is
    # the live lookups' sum, not overwritten by the padding's zeros.
    assert np.abs(want_dc[0]).max() > 0
    direct = joint_lookup_bwd(*t, torch.from_numpy(g_q),
                              torch.from_numpy(g_d), compact.shape[0])
    _close(direct.numpy(), want_dc)
    assert not direct[np.setdiff1d(np.arange(128), sel)].any()


def test_joint_lookup_bf16_outputs_follow_the_pallas_kernel():
    """f32 compact under bf16 compute: rows and weights meet in f32 and only
    the outputs are cast (dssm_tpu's XLA fallback rounds compact first)."""
    rng = np.random.default_rng(33)
    compact, sel, q_inv, q_wgt, d_inv, d_wgt, _, _ = _joint_inputs(rng)
    args = (compact, sel, q_inv, q_wgt, d_inv, d_wgt)
    with force_interpret():
        want = jdedup.joint_lookup_from_compact(
            *[jnp.asarray(a) for a in args], jnp.bfloat16, impl="pallas")
        xla = jdedup.joint_lookup_from_compact(
            *[jnp.asarray(a) for a in args], jnp.bfloat16, impl="xla")
    got = tdedup.joint_lookup_from_compact(
        *[torch.from_numpy(a) for a in args], torch.bfloat16)
    for g, w, x in zip(got, want, xla):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        # Equal to the Pallas kernel up to the f32 sum order before the cast
        # (one bf16 ulp, 2^-8 relative); the XLA path is a bf16 rounding of
        # every compact row apart.
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2 ** -7,
                                   atol=1e-3)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(x.astype(jnp.float32)),
                                   rtol=0, atol=2e-2 * np.abs(w).max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("normalize", [True, False])
def test_tower_backward_plain_matches_pallas(dtype, tol, activation,
                                             normalize):
    rng = np.random.default_rng(34)
    x, layers = _tower_inputs(rng, dtype)
    gy = rng.normal(size=(64, 32)).astype(np.float32)

    def jloss(xx, ll):
        return jnp.sum(dense_tower_pallas(xx, ll, activation, normalize)
                       * jnp.asarray(gy))

    with force_interpret():
        jdx, jdl = jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b))
                             for w, b in layers])
    tx = _t(x).requires_grad_(True)
    tl = [(_t(w).requires_grad_(True), _t(b).requires_grad_(True))
          for w, b in layers]
    y = dense_tower(tx, tl, activation, normalize)
    (y * torch.from_numpy(gy)).sum().backward()
    pairs = [(tx.grad, jdx)] + [(t.grad, j) for tp, jp in zip(tl, jdl)
                                for t, j in zip(tp, jp)]
    for got, want in pairs:
        assert got.dtype == getattr(torch, dtype)
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


def _loss_inputs(rng, b, bg, dim=32):
    q = rng.normal(size=(b, dim)).astype(np.float32)
    d = rng.normal(size=(bg, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return q, d


# The in-batch case (diagonal labels) and a local block of a larger pool
# with offset labels, as the multi-device loss will pass them.
@pytest.mark.parametrize("b,bg,offset", [(128, 128, 0), (128, 256, 128)])
def test_loss_plain_matches_pallas_forward_and_backward(b, bg, offset):
    rng = np.random.default_rng(35 + offset)
    q, d = _loss_inputs(rng, b, bg)
    labels = (offset + np.arange(b)).astype(np.int32)
    gamma = 20.0
    with force_interpret():
        (jl, jaux), (jdq, jdd) = jax.value_and_grad(
            lambda qq, dd: in_batch_loss_pallas(qq, dd, gamma,
                                                jnp.asarray(labels)),
            argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(d))
    tq = torch.from_numpy(q).requires_grad_(True)
    td = torch.from_numpy(d).requires_grad_(True)
    loss, aux = in_batch_loss(tq, td, gamma, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss", "in_batch_recall@1", "pos_cos"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6)
    _close(tq.grad.numpy(), jdq)
    _close(td.grad.numpy(), jdd)
    # The explicit plain backward (what the dq / dd kernels are held to).
    with torch.no_grad():
        _, lse, _, _ = in_batch_nll_plain(tq, td, torch.from_numpy(labels),
                                          gamma)
        g = torch.full((b,), 1.0 / b)
        dq, dd = in_batch_loss_grads_plain(tq, td, torch.from_numpy(labels),
                                           gamma, lse, g)
        _close(dq.numpy(), jdq)
        _close(dd.numpy(), jdd)
        _close(in_batch_loss_dq(tq, td, torch.from_numpy(labels), gamma, lse,
                                g).numpy(), jdq)
        _close(in_batch_loss_dd(tq, td, torch.from_numpy(labels), gamma, lse,
                                g).numpy(), jdd)


def test_loss_hit_counts_an_exact_tie():
    """Docs 3 and 7 are bit-identical: query 7's positive ties with doc 3.
    The fused loss counts the tie as a hit (as the Pallas kernel), the
    composed one (argmax, as dssm_tpu's XLA loss) does not."""
    rng = np.random.default_rng(36)
    q, d = _loss_inputs(rng, 128, 128)
    d[7] = d[3]
    q[7] = d[7]
    q[3] = d[3]
    with force_interpret():
        _, jaux = in_batch_loss_pallas(jnp.asarray(q), jnp.asarray(d), 20.0)
    _, xaux = in_batch_loss_xla(jnp.asarray(q), jnp.asarray(d), 20.0)
    tq, td = torch.from_numpy(q), torch.from_numpy(d)
    _, aux = in_batch_loss(tq, td, 20.0)
    _, caux = in_batch_loss_composed(tq, td, 20.0)
    _, _, hit = in_batch_nll(tq, td, torch.arange(128, dtype=torch.int32),
                             20.0)
    assert hit[3] == 1 and hit[7] == 1
    assert float(aux["in_batch_recall@1"]) == float(jaux["in_batch_recall@1"])
    assert float(caux["in_batch_recall@1"]) == float(xaux["in_batch_recall@1"])
    assert float(aux["in_batch_recall@1"]) > float(caux["in_batch_recall@1"])
    np.testing.assert_allclose(float(caux["loss"]), float(xaux["loss"]),
                               rtol=1e-5)


def test_scatter_plain_matches_pallas_in_place():
    rng = np.random.default_rng(37)
    table = rng.normal(size=(V, H)).astype(np.float32)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:19] = np.sort(rng.choice(V // GROUP, 19, replace=False))
    vals = rng.normal(size=(SLOTS * GROUP, H)).astype(np.float32)
    want = np.asarray(scatter_add_row_groups(
        jnp.asarray(table), jnp.asarray(gids), jnp.asarray(vals), GROUP,
        interpret=True, groups_per_step=8))
    tt = torch.from_numpy(table.copy())
    got = t_scatter(tt, torch.from_numpy(gids), torch.from_numpy(vals), GROUP)
    assert got is tt  # in place on the table tensor
    np.testing.assert_array_equal(tt.numpy(), want)
    touched = (gids[:19, None] * GROUP + np.arange(GROUP)).reshape(-1)
    rest = np.setdiff1d(np.arange(V), touched)
    np.testing.assert_array_equal(tt.numpy()[rest], table[rest])
    assert np.abs(tt.numpy()[touched] - table[touched]).min() > 0


def _kernel_calls(dev):
    table = torch.zeros((V, H), device=dev)
    gids = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    c2 = torch.zeros((128, H), device=dev)
    sel = torch.zeros((128,), dtype=torch.int32, device=dev)
    inv = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    wgt = torch.ones((64, 8), device=dev)
    g = torch.zeros((64, H), device=dev)
    x = torch.zeros((64, 40), device=dev)
    layers = [(torch.zeros((40, 32), device=dev), torch.zeros(32, device=dev))]
    q = torch.zeros((64, 32), device=dev)
    lab = torch.arange(64, dtype=torch.int32, device=dev)
    row = torch.zeros((64,), device=dev)
    vals = torch.zeros((SLOTS * GROUP, H), device=dev)
    return {
        "gather_row_groups": lambda impl: t_gather(table, gids, GROUP,
                                                   impl=impl),
        "count_lookup": lambda impl: count_lookup(c2, inv, wgt, impl=impl),
        "dense_tower": lambda impl: dense_tower(x, layers, impl=impl),
        "joint_lookup": lambda impl: joint_lookup(c2, sel, inv, wgt, inv, wgt,
                                                  impl=impl),
        "joint_lookup_bwd": lambda impl: joint_lookup_bwd(
            sel, inv, wgt, inv, wgt, g, g, 128, impl=impl),
        "count_lookup_bwd": lambda impl: count_lookup_bwd(inv, wgt, g, 128,
                                                          impl=impl),
        "dense_tower_residuals": lambda impl: dense_tower(
            x.clone().requires_grad_(True), layers, impl=impl),
        "in_batch_loss": lambda impl: in_batch_nll(q, q, lab, 20.0,
                                                   impl=impl),
        "in_batch_loss_dq": lambda impl: in_batch_loss_dq(
            q, q, lab, 20.0, row, row, impl=impl),
        "in_batch_loss_dd": lambda impl: in_batch_loss_dd(
            q, q, lab, 20.0, row, row, impl=impl),
        "scatter_add_row_groups": lambda impl: t_scatter(
            table, gids, vals, GROUP, impl=impl),
    }


@pytest.mark.parametrize("name", _build.KERNELS)
def test_wrappers_on_cpu_tensors(name):
    """auto takes the plain version for a CPU tensor without launching;
    kernel refuses a CPU tensor; an unknown impl is an error."""
    call = _kernel_calls("cpu")[name]
    before = _build.launch_counts()
    call("auto")
    assert _build.launch_counts() == before
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        call("kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        call("xla")
