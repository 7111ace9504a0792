"""dssm_tpu_torch's CUDA kernels against their plain PyTorch versions on the
GPU, each alone and through the served model. Marked `cuda`; each test skips
without a card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather and the scatter move or add the same values (exact);
the lookups, their backward kernels (the count backward with f32 atomics, the
joint backward in a fixed order, so two calls give the same bits) and the f32
tower only sum in another order (rtol 1e-5 of the largest value); the bf16
tower may round one intermediate to the neighbouring bf16 value (2e-2).
The loss kernels are held to 1e-4 of the largest value: their logits are
exact f32 products summed in k order (the plain matmul sums in another
order), scaled by gamma = 20, and their exp and the merges of the online
softmax across threads and cluster ranks differ from the library's in the
last bits; a TF32 product (~1e-3 on such a logit) would fail it. Rows 3 and
7 hold an exact tie, which must count as a hit; near-ties may flip one row's
hit. The loss kernels add no atomics, so two calls give the same bits.
The stochastic-rounding scatters draw the same Philox stream in the kernel
and in the plain version and do the same f32 arithmetic (bit-equal); the
rank count is an integer, equal wherever no score lies within an f32
rounding of the true score. The raw-index embedding bag and its weight
gradient sum in another order than their plain versions (rtol 1e-5; on a
bf16 table the same bf16 values are summed in f32, so the same tolerance).
The fused gather + joint lookup sums the same terms in the same order as the
joint lookup kernel after the gather kernel (bit-equal to the two), and in
another order than its plain version (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

from dssm_tpu_torch.bridge import batch_to_torch
from dssm_tpu_torch.config import (
    DataConfig, LossConfig, RunConfig, TowerConfig, TrainConfig)
from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
from dssm_tpu_torch.data.loader import batch_iterator, hash_pairs
from dssm_tpu_torch.data.toy import make_toy_pairs
from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.kernels.embed import (
    embedding_bag, embedding_bag_dwgt, embedding_bag_dwgt_plain,
    embedding_bag_plain)
from dssm_tpu_torch.kernels.count import (
    count_lookup, count_lookup_bwd, count_lookup_bwd_plain, count_lookup_plain)
from dssm_tpu_torch.kernels.gather import (
    gather_row_groups, gather_row_groups_plain, scatter_add_row_groups,
    scatter_add_row_groups_plain)
from dssm_tpu_torch.kernels.joint import (
    fused_gather_joint_lookup, fused_gather_joint_lookup_plain, joint_lookup,
    joint_lookup_bwd, joint_lookup_bwd_plain, joint_lookup_plain)
from dssm_tpu_torch.kernels.loss import (
    in_batch_loss_dd, in_batch_loss_dq, in_batch_loss_grads_plain,
    in_batch_nll, in_batch_nll_kernel, in_batch_nll_plain)
from dssm_tpu_torch.kernels.rank import (
    rank_counts, rank_counts_plain, true_scores)
from dssm_tpu_torch.kernels.scatter_sr import (
    scatter_sr_int8_row_groups, scatter_sr_int8_row_groups_plain,
    scatter_sr_row_groups, scatter_sr_row_groups_plain)
from dssm_tpu_torch.kernels.tower import (
    dense_tower, dense_tower_residuals, dense_tower_residuals_plain)
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.serve import build_doc_index
from dssm_tpu_torch.train.eval import evaluate
from dssm_tpu_torch.train.loop import make_train_step
from dssm_tpu_torch.train.state import create_run_state

V, H, GROUP, SLOTS = 4096, 128, 8, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels run only there)")
    return torch.device("cuda")


def _ragged(rng, rows, k, u2):
    inv = rng.integers(0, u2, size=(rows, k)).astype(np.int32)
    wgt = rng.integers(1, 4, size=(rows, k)).astype(np.float32)
    nnz = rng.integers(0, k + 1, size=(rows,))
    wgt[np.arange(k)[None, :] >= nnz[:, None]] = 0.0
    inv[np.arange(k)[None, :] >= nnz[:, None]] = -1  # out of range: no-op
    return inv, wgt


@pytest.mark.cuda
def test_gather_kernel_matches_plain(dev):
    rng = np.random.default_rng(21)
    table = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:23] = np.sort(rng.choice(V // GROUP, 23, replace=False))
    gids = torch.from_numpy(gids).to(dev)
    # bf16 rows come in groups of 16: ids past V // 16 read as out of range.
    for tbl, group in ((table, GROUP), (table.to(torch.bfloat16), 16)):
        assert torch.equal(gather_row_groups(tbl, gids, group, impl="kernel"),
                           gather_row_groups_plain(tbl, gids, group))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(22)
    c2 = torch.from_numpy(rng.normal(size=(128, 384)).astype(np.float32))
    c2 = c2.to(dev, dtype)
    for rows, k in ((256, 32), (100, 70)):
        inv, wgt = _ragged(rng, rows, k, 128)
        inv, wgt = torch.from_numpy(inv).to(dev), torch.from_numpy(wgt).to(dev)
        got = count_lookup(c2, inv, wgt, impl="kernel")
        want = count_lookup_plain(c2, inv, wgt)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


# (widths, rows): small ragged widths; the `full` widths at row counts that
# leave ragged 16- and 32-row tiles; one layer (its row norms summed across
# the cluster with no barrier between layers); a layer wider than one
# 320-column pass and inputs of several weight chunks, so the ring wraps
# many times; layer inputs wider than the shared-memory tile (f32 2048, f32
# and bf16 7264, the old kernel's widest), read back from the residuals.
TOWER_SHAPES = [((40, 64, 30, 32), 70)] + [
    ((300, 300, 128), rows)
    for rows in (1, 15, 17, 64, 500, 1000, 2048, 3000)
] + [((300, 128), 256), ((300, 128), 1024), ((520, 1024, 96), 100),
     ((300, 2048, 128), 300), ((7264, 96, 64), 40)]


def _tower_case(rng, dims, rows, dtype, dev):
    """x uniform in [-1, 1); W normal x 0.2 at the small widths, normal /
    sqrt(fan-in) from width 300 (pre-activations stay O(1)); b normal x
    0.1."""
    x = torch.from_numpy(rng.uniform(-1, 1, size=(rows, dims[0])).astype(
        np.float32)).to(dev, dtype)
    scale = [0.2 if max(dims) <= 64 else 1 / np.sqrt(d) for d in dims]
    layers = [(torch.from_numpy((rng.normal(size=(dims[i], dims[i + 1]))
                                 * scale[i]).astype(np.float32))
               .to(dev, dtype),
               torch.from_numpy(rng.normal(size=(dims[i + 1],))
                                .astype(np.float32) * 0.1).to(dev, dtype))
              for i in range(len(dims) - 1)]
    return x, layers


@pytest.mark.cuda
@pytest.mark.parametrize("dims,rows", TOWER_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_tower_kernel_matches_plain(dev, dtype, tol, dims, rows):
    """y, and with residuals every layer's f32 activation, against the
    plain version; one counted launch a call."""
    x, layers = _tower_case(np.random.default_rng(23), dims, rows, dtype, dev)
    for act in ("tanh", "relu"):
        for norm in (True, False):
            before = _build.launch_counts()
            got = dense_tower(x, layers, act, norm, impl="kernel")
            y, hs = dense_tower_residuals(x, layers, act, norm,
                                          impl="kernel")
            after = _build.launch_counts()
            assert (after["dense_tower"] - before["dense_tower"],
                    after["dense_tower_residuals"]
                    - before["dense_tower_residuals"]) == (1, 1)
            want, want_hs = dense_tower_residuals_plain(x, layers, act, norm)
            torch.testing.assert_close(got, want, rtol=0, atol=tol)
            torch.testing.assert_close(y, want, rtol=0, atol=tol)
            assert len(hs) == len(want_hs)
            for h, w in zip(hs, want_hs):
                torch.testing.assert_close(h, w, rtol=0, atol=tol)


@pytest.mark.cuda
def test_served_index_kernels_match_plain(dev):
    cfg = RunConfig(
        tower=TowerConfig(vocab_size=V, embed_width=40, hidden_dims=(64,),
                          semantic_dim=32, compute_dtype="bfloat16"),
        data=DataConfig(max_trigrams=16, max_trigrams_query=8,
                        max_unique=512, max_unique_rows=128),
        train=TrainConfig(batch_size=64))
    params = model_base.init_params(cfg.tower, seed=0, device=dev)
    titles = make_toy_pairs(150, 64, 5).titles
    _build.reset_launch_counts()
    got = build_doc_index(params, cfg, titles, 64, impl="auto", device=dev)
    counts = _build.launch_counts()  # 3 batches through the serving kernels
    assert all(counts[k] == 3 for k in ("gather_row_groups", "count_lookup",
                                        "dense_tower")), counts
    want = build_doc_index(params, cfg, titles, 64, impl="plain", device=dev)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def _close(got, want, rtol=1e-5):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_count_backward_kernel_matches_plain(dev, g_dtype):
    rng = np.random.default_rng(24)
    for rows, k, h in ((256, 32, 384), (100, 70, 100)):
        inv, wgt = _ragged(rng, rows, k, 128)
        inv, wgt = torch.from_numpy(inv).to(dev), torch.from_numpy(wgt).to(dev)
        g = torch.from_numpy(rng.normal(size=(rows, h)).astype(
            np.float32)).to(dev, g_dtype)
        _close(count_lookup_bwd(inv, wgt, g, 128, impl="kernel"),
               count_lookup_bwd_plain(inv, wgt, g, 128))
    # Through autograd: the gradient comes back in compact2's dtype.
    c2 = torch.zeros((128, h), device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    count_lookup(c2, inv, wgt, impl="kernel").backward(g.float())
    assert c2.grad.dtype == torch.bfloat16
    _close(c2.grad.float(), count_lookup_bwd_plain(inv, wgt, g, 128), 1e-2)


def _joint_case(rng, dev, rows, kq, kd, u2, gr, h, used, every=None,
                name_padding=False, dead_rows=0):
    """sel, q_inv, q_wgt, d_inv, d_wgt: `used` sorted compact rows, sel's
    padding aliasing compact row 0 and one slot past the block (dead);
    ragged rows. every: the one slot every lookup of both sides names (one
    segment far longer than a piece); name_padding: lookups also name the
    padding slots (they add into row 0); dead_rows: the first rows of each
    side have no live lookup."""
    sel = np.zeros((u2,), np.int32)  # padding aliases compact row 0
    sel[:used] = np.sort(rng.choice(gr, used, replace=False))
    sel[0] = 0
    sel[used - 1] = gr + 5  # a slot that points past the block: dead
    named = u2 if name_padding else used
    q_inv, q_wgt = _ragged(rng, rows, kq, named)
    d_inv, d_wgt = _ragged(rng, rows, kd, named)
    if every is not None:
        for inv, wgt in ((q_inv, q_wgt), (d_inv, d_wgt)):
            inv[:] = every
            wgt[:] = rng.integers(1, 4, size=wgt.shape)
    q_inv[0, 0], q_wgt[0, 0] = 0, 2.0
    for wgt in (q_wgt, d_wgt):
        wgt[1:1 + dead_rows] = 0.0
    return [torch.from_numpy(a).to(dev)
            for a in (sel, q_inv, q_wgt, d_inv, d_wgt)]


# (rows, kq, kd, u2, gr, h, extra): small ragged shapes, h = 100 (not a
# whole number of 16-byte bf16 vectors), the `full` widths, a cnn-width
# compact block with 3-D rows of 16 x 8, one segment named by every lookup
# of both sides (~1500 pieces), lookups that name sel's padding (row 0).
JOINT_CASES = [
    (128, 8, 16, 128, 256, 384, {}),
    (50, 5, 70, 96, 200, 100, {"dead_rows": 3}),
    (1024, 32, 64, 1024, 2048, 384, {"dead_rows": 5}),
    (256 * 16, 8, 8, 2048, 8192, 1024, {"dead_rows": 40}),
    (1024, 32, 64, 1024, 2048, 384, {"every": 7, "dead_rows": 2}),
    (300, 12, 20, 256, 1024, 96, {"name_padding": True}),
]


def _touched(fields, gr):
    """Compact rows some live lookup names (a bool mask over [0, gr))."""
    sel, q_inv, q_wgt, d_inv, d_wgt = fields
    hit = torch.zeros(gr, dtype=torch.bool, device=sel.device)
    for inv, wgt in ((q_inv, q_wgt), (d_inv, d_wgt)):
        live = (wgt != 0) & (inv >= 0) & (inv < sel.shape[0])
        j = sel.long()[inv[live].long()]
        hit[j[(j >= 0) & (j < gr)]] = True
    return hit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_lookup_kernels_match_plain(dev, dtype):
    """Forward (compact of `dtype`) and backward (g of f32 and bf16) against
    their plain versions; the backward through autograd too."""
    rng = np.random.default_rng(25)
    for rows, kq, kd, u2, gr, h, extra in JOINT_CASES:
        fields = _joint_case(rng, dev, rows, kq, kd, u2, gr, h, u2 - 6,
                             **extra)
        if rows == 256 * 16:  # the cnn's 3-D rows: batch x words x trigrams
            fields = [fields[0]] + [f.reshape(256, 16, -1)
                                    for f in fields[1:]]
        compact = torch.from_numpy(rng.normal(size=(gr, h)).astype(
            np.float32)).to(dev, dtype)
        got = joint_lookup(compact, *fields, impl="kernel")
        want = joint_lookup_plain(compact, *fields)
        for a, b in zip(got, want):
            _close(a, b)
        for g_dtype in (torch.float32, torch.bfloat16):
            g_q, g_d = (torch.from_numpy(rng.normal(
                size=(*fields[1].shape[:-1], h)).astype(np.float32)).to(
                    dev, g_dtype) for _ in range(2))
            dc = joint_lookup_bwd(*fields, g_q, g_d, gr, impl="kernel")
            _close(dc, joint_lookup_bwd_plain(*fields, g_q, g_d, gr))
            assert dc[0].abs().max() > 0  # row 0: added through sel, not set
        # Through autograd against autograd through the plain version.
        ck = compact.clone().requires_grad_(True)
        cp = compact.clone().requires_grad_(True)
        for c, impl in ((ck, "kernel"), (cp, "plain")):
            lq, ld = joint_lookup(c, *fields, impl=impl)
            ((lq * g_q.float()).sum() + (ld * g_d.float()).sum()).backward()
        _close(ck.grad.float(), cp.grad.float(),
               1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_joint_lookup_bwd_bit_reproducible_and_writes_every_row(dev, g_dtype):
    """No float atomics: two calls give the same bits. Every row of d_compact
    is written, exactly 0 where no live lookup names it, though the memory
    the caching allocator hands out was left full of NaN bits (and the
    scratch's counters of -1) by a freed tensor. One counted launch a
    call."""
    rng = np.random.default_rng(29)
    for rows, kq, kd, u2, gr, h, extra in JOINT_CASES:
        fields = _joint_case(rng, dev, rows, kq, kd, u2, gr, h, u2 - 6,
                             **extra)
        g_q, g_d = (torch.from_numpy(rng.normal(size=(rows, h)).astype(
            np.float32)).to(dev, g_dtype) for _ in range(2))
        runs = []
        for _ in range(2):
            junk = torch.full((64 << 20,), 255, dtype=torch.uint8, device=dev)
            del junk
            before = _build.launch_counts()["joint_lookup_bwd"]
            runs.append(joint_lookup_bwd(*fields, g_q, g_d, gr,
                                         impl="kernel"))
            assert _build.launch_counts()["joint_lookup_bwd"] == before + 1
        assert torch.equal(runs[0], runs[1])
        hit = _touched(fields, gr)
        assert bool((runs[0][~hit] == 0).all())
        assert bool(torch.isfinite(runs[0]).all())
        _close(runs[0], joint_lookup_bwd_plain(*fields, g_q, g_d, gr))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_gather_joint_lookup_matches_plain_and_split(dev, dtype):
    """Bit-equal to the gather kernel followed by the joint lookup kernel,
    and within rtol 1e-5 of the plain version; empty slots (the sentinel,
    -1, an id past the table) among the real ones, slot 0 empty in the
    second case (sel's padding then names a zero row), the `full` widths,
    a cnn-width table (h = 1024, K = 8), h = 100 (a bf16 row is no whole
    number of 16-byte vectors), one row named by every lookup, rows with no
    live lookup, and the sequence towers' 3-D lookup rows."""
    rng = np.random.default_rng(27)
    group = 8 if dtype == torch.float32 else 16
    cases = [(64, 23, 128, 8, 16, 128, 384, {}),
             (40, 30, 64, 5, 70, 96, 384, {"dead_rows": 2}),
             (256, 107, 1024, 32, 64, 1024, 384, {"dead_rows": 5}),
             (128, 90, 2048, 8, 8, 1024, 1024, {"dead_rows": 30}),
             (64, 23, 128, 8, 16, 128, 100, {}),
             (64, 23, 512, 32, 64, 128, 384, {"every": 9})]
    for slots, real, rows, kq, kd, u2, h, extra in cases:
        table = torch.from_numpy(rng.normal(size=(V, h)).astype(
            np.float32)).to(dev, dtype)
        uniq = np.full((slots,), SKIP_SENTINEL_GID, np.int32)
        uniq[:real] = np.sort(rng.choice(V // group, real, replace=False))
        if slots == 40:
            uniq[[0, 7, 31]] = (SKIP_SENTINEL_GID, -1, V // group + 3)
        uniq = torch.from_numpy(uniq).to(dev)
        fields = _joint_case(rng, dev, rows, kq, kd, u2, slots * group, h,
                             u2 - 6, **extra)
        _build.reset_launch_counts()
        q, d, c = fused_gather_joint_lookup(table, uniq, *fields, group,
                                            impl="kernel")
        assert _build.launch_counts()["fused_gather_joint_lookup"] == 1
        c_split = gather_row_groups(table, uniq, group, impl="kernel")
        q_split, d_split = joint_lookup(c_split, *fields, impl="kernel")
        assert torch.equal(c, c_split)
        assert torch.equal(q, q_split) and torch.equal(d, d_split)
        q_p, d_p, c_p = fused_gather_joint_lookup_plain(table, uniq, *fields,
                                                        group)
        assert torch.equal(c, c_p)
        _close(q, q_p)
        _close(d, d_p)
        if extra.get("dead_rows"):
            assert bool((q[1:1 + extra["dead_rows"]] == 0).all())
        fields3 = [fields[0]] + [f.reshape(rows // 4, 4, -1)
                                 for f in fields[1:]]
        q3, d3, _ = fused_gather_joint_lookup(table, uniq, *fields3, group,
                                              impl="kernel")
        assert q3.shape == (rows // 4, 4, h)
        assert torch.equal(q3.reshape(rows, -1), q)
        assert torch.equal(d3.reshape(rows, -1), d)


def _tower_grads_from(x, layers, y, hs, gy, act, norm):
    """[dx, dW1, db1, ...] by the reference's backward (pallas_tower.py's
    _tower_bwd), in f64 from the residuals given."""
    g = gy.double()
    h = [t.double() for t in hs]
    if norm:
        yy = y.double()
        g = (g - (g * yy).sum(-1, keepdim=True) * yy) / h[-1].norm(
            dim=-1, keepdim=True).clamp_min(1e-12)
    grads = []
    for l in reversed(range(len(layers))):
        dz = g * (1 - h[l] ** 2 if act == "tanh" else (h[l] > 0).double())
        prev = x.double() if l == 0 else h[l - 1]
        grads[:0] = [prev.T @ dz, dz.sum(0)]
        g = dz @ layers[l][0].double().T
    return [g] + grads


@pytest.mark.cuda
@pytest.mark.parametrize("dims,rows", [((40, 64, 30, 32), 70),
                                       ((300, 300, 128), 2048),
                                       ((520, 1024, 96), 100),
                                       ((300, 2048, 128), 300)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_tower_residual_kernel_backward_matches_plain(dev, dtype, tol, dims,
                                                      rows):
    rng = np.random.default_rng(26)
    x, layers = _tower_case(rng, dims, rows, dtype, dev)
    gy = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev)
    for act in ("tanh", "relu"):
        for norm in (True, False):
            grads = {}
            for impl in ("kernel", "plain"):
                leaves = [x.clone().requires_grad_(True)] + [
                    t.clone().requires_grad_(True) for l in layers for t in l]
                ll = list(zip(leaves[1::2], leaves[2::2]))
                before = _build.launch_counts()["dense_tower_residuals"]
                y = dense_tower(leaves[0], ll, act, norm, impl=impl)
                assert (_build.launch_counts()["dense_tower_residuals"]
                        - before) == (impl == "kernel")
                (y * gy).sum().backward()
                grads[impl] = [t.grad.float() for t in leaves]
            want = grads["plain"]
            if act == "relu":
                # relu's derivative steps at 0, and a pre-activation within
                # rounding of 0 may fall on either side in the kernel's and
                # the plain forward's residuals: hold relu's gradients to
                # the backward at the kernel's own residuals (which
                # test_tower_kernel_matches_plain holds to the plain ones).
                y, hs = dense_tower_residuals(x, layers, act, norm,
                                              impl="kernel")
                want = [t.float() for t in _tower_grads_from(
                    x, layers, y, hs, gy, act, norm)]
            for a, b in zip(grads["kernel"], want):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=tol * max(1.0, float(b.abs().max())))


def _loss_inputs(dev, b, bg, dim, offset, bad_labels=False):
    rng = np.random.default_rng(27)
    q = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(b, dim)).astype(np.float32)), dim=1).to(dev)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(bg, dim)).astype(np.float32)), dim=1).to(dev)
    d[offset + 7] = d[offset + 3]  # an exact tie for rows 3 and 7
    q[7] = d[offset + 7]
    q[3] = d[offset + 3]
    labels = (offset + torch.arange(b, dtype=torch.int32)).to(dev)
    if bad_labels:  # outside [0, B'): pos 0, no one-hot
        labels[-1] = -1
        labels[-2] = bg
    return rng, q, d, labels


# (B, B', D, label offset, two labels outside [0, B')): the `full` shape; a
# large pool with offset labels (each of the 8 ranks walks 4 tiles of 128
# rows); B' below one tile (70: ranks 1-7 have no tile); D % 4 != 0 (4-byte
# copies); the widest D (6 passes of 128 output columns in dq / dd).
LOSS_SHAPES = [(128, 128, 128, 0, False), (100, 203, 37, 50, False),
               (70, 70, 200, 0, False), (1024, 1024, 128, 0, False),
               (64, 4096, 128, 1000, True), (48, 70, 128, 0, True),
               (33, 203, 37, 50, True), (16, 40, 680, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,bg,dim,offset,bad_labels", LOSS_SHAPES)
def test_loss_kernels_match_plain(dev, b, bg, dim, offset, bad_labels):
    rng, q, d, labels = _loss_inputs(dev, b, bg, dim, offset, bad_labels)
    want = in_batch_nll_plain(q, d, labels, 20.0)
    nll, pos, hit = in_batch_nll(q, d, labels, 20.0, impl="kernel")
    _close(nll, want[0], 1e-4)
    _close(pos, want[2], 1e-4)
    assert hit[7] == 1 and hit[3] == 1
    assert float((hit != want[3]).sum()) <= 1  # a near-tie may flip one row
    g = torch.from_numpy(rng.uniform(0.5, 1.5, size=(b,)).astype(
        np.float32)).to(dev) / b
    lse = want[1]
    dq_p, dd_p = in_batch_loss_grads_plain(q, d, labels, 20.0, lse, g)
    _close(in_batch_loss_dq(q, d, labels, 20.0, lse, g, impl="kernel"),
           dq_p, 1e-4)
    _close(in_batch_loss_dd(q, d, labels, 20.0, lse, g, impl="kernel"),
           dd_p, 1e-4)
    # Through autograd against autograd through the plain version.
    grads = {}
    for impl in ("kernel", "plain"):
        qq, dd = q.clone().requires_grad_(True), d.clone().requires_grad_(True)
        (in_batch_nll(qq, dd, labels, 20.0, impl=impl)[0] * g).sum().backward()
        grads[impl] = (qq.grad, dd.grad)
    for a, bb in zip(grads["kernel"], grads["plain"]):
        _close(a, bb, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,bg,dim,offset", [(1024, 1024, 128, 0),
                                             (33, 203, 37, 50)])
def test_loss_kernels_bit_reproducible(dev, b, bg, dim, offset):
    # No atomics: the same inputs give the same bits, call after call.
    rng, q, d, labels = _loss_inputs(dev, b, bg, dim, offset, True)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, size=(b,)).astype(
        np.float32)).to(dev) / b
    fwd = [in_batch_nll_kernel(q, d, labels, 20.0) for _ in range(2)]
    for a, bb in zip(*fwd):
        assert torch.equal(a, bb)
    lse = fwd[0][1]
    for fn in (in_batch_loss_dq, in_batch_loss_dd):
        runs = [fn(q, d, labels, 20.0, lse, g, impl="kernel")
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_in_place(dev):
    rng = np.random.default_rng(28)
    table = torch.from_numpy(rng.normal(size=(V, 384)).astype(np.float32)).to(dev)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:23] = np.sort(rng.choice(V // GROUP, 23, replace=False))
    gids[30] = -1
    gids = torch.from_numpy(gids).to(dev)
    vals = torch.from_numpy(rng.normal(size=(SLOTS * GROUP, 384)).astype(
        np.float32)).to(dev)
    want = scatter_add_row_groups_plain(table.clone(), gids, vals, GROUP)
    before = table.clone()
    got = scatter_add_row_groups(table, gids, vals, GROUP, impl="kernel")
    assert got is table and got.data_ptr() == table.data_ptr()
    assert torch.equal(table, want)
    assert not torch.equal(table, before)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_train_steps_kernels_match_plain(dev, shared):
    """3 steps of the sparse train step through the kernels and through the
    plain versions from the same state: the joint branch (shared weights)
    and the per-side branch."""
    cfg = RunConfig(
        tower=TowerConfig(vocab_size=V, embed_width=100, hidden_dims=(64,),
                          semantic_dim=32, compute_dtype="bfloat16",
                          shared_weights=shared),
        data=DataConfig(max_trigrams=16, max_trigrams_query=8,
                        max_unique=1024, max_unique_rows=128),
        loss=LossConfig(), train=TrainConfig(batch_size=128))
    hashed = hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data)
    it = batch_iterator(hashed, 128, seed=3, dedup_unique=1024,
                        dedup_unique_rows=128, dedup_joint=shared,
                        wire_compress=True, sort_rows=True)
    batches = [batch_to_torch(next(it), dev) for _ in range(3)]
    states = {impl: create_run_state(cfg, model_base.init_params(
        cfg.tower, seed=0, device=dev)) for impl in ("auto", "plain")}
    losses = {}
    _build.reset_launch_counts()
    for impl in states:
        step = make_train_step(cfg, impl)
        losses[impl] = []
        for batch in batches:
            states[impl], aux = step(states[impl], batch)
            losses[impl].append(float(aux["loss"]))
    counts = _build.launch_counts()
    if shared:
        per_step = ("fused_gather_joint_lookup", "joint_lookup_bwd",
                    "dense_tower_residuals", "in_batch_loss",
                    "in_batch_loss_dq", "in_batch_loss_dd",
                    "scatter_add_row_groups")
        assert all(counts[k] == 3 for k in per_step), counts
        assert counts["gather_row_groups"] == counts["joint_lookup"] == 0
    else:
        assert counts["count_lookup"] == counts["count_lookup_bwd"] == 6
        assert counts["gather_row_groups"] == 6
        assert counts["scatter_add_row_groups"] == 6
        assert counts["dense_tower_residuals"] == 6
    np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=0,
                               atol=1e-2)
    for tower, tp in states["plain"].params.items():
        for k, want in tp.items():
            torch.testing.assert_close(states["auto"].params[tower][k], want,
                                       rtol=0, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_scatter_sr_kernels_bit_equal_to_plain(dev, kind):
    rng = np.random.default_rng(29)
    if kind == "bf16":
        group, fn, plain = 16, scatter_sr_row_groups, scatter_sr_row_groups_plain
        table = torch.from_numpy((rng.normal(size=(V, 384)) * 0.05).astype(
            np.float32)).to(dev, torch.bfloat16)
        vals = (rng.normal(size=(SLOTS * group, 384)) * 1e-4).astype(np.float32)
    else:
        group, fn, plain = (32, scatter_sr_int8_row_groups,
                            scatter_sr_int8_row_groups_plain)
        table = torch.from_numpy(rng.integers(
            -127, 128, size=(V, 384)).astype(np.int8)).to(dev)
        vals = rng.uniform(-3, 3, size=(SLOTS * group, 384)).astype(np.float32)
    vals = torch.from_numpy(vals).to(dev)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:23] = np.sort(rng.choice(V // group, 23, replace=False))
    gids[30] = -1
    gids = torch.from_numpy(gids).to(dev)
    for seed in (0, 12345, -7):
        want = plain(table.clone(), gids, vals, group, seed)
        got = table.clone()
        out = fn(got, gids, vals, group, seed, impl="kernel")
        assert out is got and torch.equal(got, want)
        assert not torch.equal(got, table)
    same = fn(table.clone(), gids, torch.zeros_like(vals), group, 3,
              impl="kernel")
    assert torch.equal(same, table)  # a zero update moves nothing
    a = fn(table.clone(), gids, vals, group, 1, impl="kernel")
    b = fn(table.clone(), gids, vals, group, 2, impl="kernel")
    assert not torch.equal(a, b)     # the seed is the stream's key


@pytest.mark.cuda
def test_scatter_add_bf16_kernel_matches_plain(dev):
    rng = np.random.default_rng(30)
    table = torch.from_numpy((rng.normal(size=(V, 384)) * 0.05).astype(
        np.float32)).to(dev, torch.bfloat16)
    gids = np.full((SLOTS,), SKIP_SENTINEL_GID, np.int32)
    gids[:23] = np.sort(rng.choice(V // 16, 23, replace=False))
    gids = torch.from_numpy(gids).to(dev)
    vals = torch.from_numpy((rng.normal(size=(SLOTS * 16, 384)) * 1e-3).astype(
        np.float32)).to(dev, torch.bfloat16)
    want = scatter_add_row_groups_plain(table.clone(), gids, vals, 16)
    got = scatter_add_row_groups(table.clone(), gids, vals, 16, impl="kernel")
    assert torch.equal(got, want) and not torch.equal(got, table)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nd,dim", [(600, 600, 128), (70, 203, 36),
                                      (1000, 1777, 128)])
def test_rank_kernel_matches_plain(dev, n, nd, dim):
    rng = np.random.default_rng(31)
    q = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, dim)).astype(np.float32)), dim=1).to(dev)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(nd, dim)).astype(np.float32)), dim=1).to(dev)
    d[:n] = torch.nn.functional.normalize(d[:n] + 0.4 * q, dim=1)
    got = rank_counts(q, d, impl="kernel")
    want = rank_counts_plain(q, d)
    gap = (q @ d.T - true_scores(q, d)[:, None]).abs()
    gap[torch.arange(n), torch.arange(n)] = 1.0
    near = (gap < 1e-5).sum(dim=1).to(torch.int32)
    assert got.dtype == torch.int32 and int(got.min()) >= 1
    assert bool(((got - want).abs() <= near).all())
    assert int(near.sum()) > 0 or torch.equal(got, want)
    # exact ties do not count: one-hot embeddings, a duplicate of a true doc
    q1 = torch.eye(8, 16, device=dev)
    d1 = torch.cat([torch.eye(8, 16, device=dev), torch.eye(8, 16, device=dev)[3:4]])
    assert rank_counts(q1, d1, impl="kernel").tolist() == [1] * 8


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_low_precision_train_and_eval_kernels_match_plain(dev, table_dtype):
    """3 steps on a bf16 / int8 table through the kernels and through the
    plain versions (same Philox stream), then evaluate both ways."""
    cfg = RunConfig(
        tower=TowerConfig(vocab_size=V, embed_width=100, hidden_dims=(64,),
                          semantic_dim=32, compute_dtype="bfloat16",
                          table_dtype=table_dtype),
        data=DataConfig(max_trigrams=16, max_trigrams_query=8,
                        max_unique=1024, max_unique_rows=128),
        loss=LossConfig(), train=TrainConfig(batch_size=128))
    group = {"bfloat16": 16, "int8": 32}[table_dtype]
    hashed = hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data)
    it = batch_iterator(hashed, 128, seed=3, dedup_unique=1024,
                        dedup_group=group, dedup_unique_rows=128,
                        dedup_joint=True, wire_compress=True, sort_rows=True)
    batches = [batch_to_torch(next(it), dev) for _ in range(3)]
    states = {impl: create_run_state(cfg, model_base.init_params(
        cfg.tower, seed=0, device=dev)) for impl in ("auto", "plain")}
    losses = {}
    _build.reset_launch_counts()
    for impl in states:
        step = make_train_step(cfg, impl)
        losses[impl] = []
        for batch in batches:
            states[impl], aux = step(states[impl], batch)
            losses[impl].append(float(aux["loss"]))
    counts = _build.launch_counts()
    name = ("scatter_sr_row_groups" if table_dtype == "bfloat16"
            else "scatter_sr_int8_row_groups")
    assert counts[name] == 3 and counts["scatter_add_row_groups"] == 0
    assert counts["joint_lookup_bwd"] == 3
    # A bf16 table's step is one fused lookup; an int8 table keeps the
    # gather, the dequantization and the joint lookup.
    split = 3 if table_dtype == "int8" else 0
    assert counts["gather_row_groups"] == counts["joint_lookup"] == split
    assert counts["fused_gather_joint_lookup"] == 3 - split
    np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=0,
                               atol=1e-2)
    ta = states["auto"].params["shared"]["W0"]
    tp = states["plain"].params["shared"]["W0"]
    assert ta.dtype == tp.dtype == model_base.torch_dtype(table_dtype)
    # The same stream on accumulators that differ in their last bits (the
    # backward's atomics, a bf16 activation of the tower): after 3 steps few
    # elements differ at all, next to none by more than a grid step (an
    # update that nearly cancels a weight leaves a finer grid behind), and
    # none by more than the f32 test's 2e-3.
    diff = (ta.float() - tp.float()).abs()
    far = diff > (1.0 if table_dtype == "int8"
                  else 2.0 ** -7 * tp.float().abs() + 1e-30)
    assert float(far.float().mean()) < 1e-3
    assert float((ta != tp).float().mean()) < 0.01
    scale = states["plain"].params["shared"].get("W0_scale", 1.0)
    assert float((diff * scale).max()) <= 2e-3
    metrics = {impl: evaluate(states[impl].params, cfg, hashed, 128, impl,
                              cache=False) for impl in ("auto", "plain")}
    assert _build.launch_counts()["rank_counts"] == 1
    for k, v in metrics["plain"].items():
        assert abs(metrics["auto"][k] - v) <= 2e-2, (k, metrics)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 32), (16, 4, 8), (7, 70)])
def test_embedding_bag_kernels_match_plain(dev, dtype, shape):
    """The forward and the weight gradient, ragged rows (dead lookups carry
    junk indices, some outside the table) and a zero row."""
    rng = np.random.default_rng(31)
    table = torch.from_numpy(rng.normal(size=(V, 256)).astype(
        np.float32)).to(dev, dtype)
    k = shape[-1]
    idx = rng.integers(0, V, size=shape).astype(np.int32)
    wgt = rng.integers(1, 4, size=shape).astype(np.float32)
    nnz = rng.integers(0, k + 1, size=shape[:-1])
    dead = np.arange(k) >= nnz[..., None]
    wgt[dead] = 0.0
    idx[dead & (rng.random(shape) < 0.5)] = V + 7
    idx, wgt = torch.from_numpy(idx).to(dev), torch.from_numpy(wgt).to(dev)
    got = embedding_bag(table, idx, wgt, impl="kernel")
    want = embedding_bag_plain(table, idx, wgt)
    assert got.dtype == torch.float32 and got.shape == (*shape[:-1], 256)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    for g_dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(rng.normal(size=(*shape[:-1], 256)).astype(
            np.float32)).to(dev, g_dtype)
        dw = embedding_bag_dwgt(table, idx, g, impl="kernel")
        dw_p = embedding_bag_dwgt_plain(table, idx, g)
        torch.testing.assert_close(dw, dw_p, rtol=1e-5,
                                   atol=1e-5 * float(dw_p.abs().max()))
    # A live lookup outside the table is an error, not a clamp.
    idx_bad, wgt_bad = idx.clone(), wgt.clone()
    idx_bad.view(-1)[0], wgt_bad.view(-1)[0] = V + 7, 1.0
    with pytest.raises(IndexError):
        embedding_bag(table, idx_bad, wgt_bad, impl="kernel")


@pytest.mark.cuda
def test_embedding_bag_autograd_matches_plain(dev):
    """d_table (the plain segment sum) and d_wgt (the kernel) through the
    autograd Function against autograd of the plain version; the d_wgt
    kernel is launched only when the weights need a gradient."""
    rng = np.random.default_rng(32)
    table0 = torch.from_numpy(rng.normal(size=(V, 128)).astype(
        np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, V, size=(32, 6, 8)).astype(
        np.int32)).to(dev)
    wgt0 = torch.from_numpy(rng.integers(0, 3, size=(32, 6, 8)).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(32, 6, 128)).astype(
        np.float32)).to(dev)
    grads = {}
    for impl in ("kernel", "plain"):
        table = table0.clone().requires_grad_(True)
        wgt = wgt0.clone().requires_grad_(True)
        (embedding_bag(table, idx, wgt, impl=impl) * g).sum().backward()
        grads[impl] = (table.grad, wgt.grad)
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    _build.reset_launch_counts()
    table = table0.clone().requires_grad_(True)
    (embedding_bag(table, idx, wgt0, impl="kernel") * g).sum().backward()
    counts = _build.launch_counts()
    assert counts["embedding_bag"] == 1 and counts["embedding_bag_bwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dedup", [("cnn", True), ("cnn", False),
                                        ("lstm", True), ("lstm", False),
                                        ("mlp", False)])
def test_sequence_and_raw_train_steps_kernels_match_plain(dev, arch, dedup):
    """3 steps of the cnn / lstm towers (union-dedupe or raw-index batches)
    and of the mlp on raw batches through the kernels and through the plain
    versions from the same state, then both evaluated."""
    cfg = RunConfig(
        tower=TowerConfig(arch=arch, vocab_size=V, embed_width=100,
                          hidden_dims=(64,), conv_channels=40, lstm_hidden=32,
                          semantic_dim=32, compute_dtype="bfloat16"),
        data=DataConfig(max_trigrams=16, max_words=6,
                        max_trigrams_per_word=8, max_unique=2048,
                        max_unique_rows=256, dedup_lookup=dedup),
        loss=LossConfig(), train=TrainConfig(batch_size=128))
    seq = cfg.tower.is_sequence_model
    hashed = hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data)
    it = batch_iterator(hashed, 128, seq, seed=3,
                        dedup_unique=2048 if dedup else None,
                        dedup_unique_rows=256, dedup_joint=True)
    batches = [batch_to_torch(next(it), dev) for _ in range(3)]
    states = {impl: create_run_state(cfg, model_base.init_params(
        cfg.tower, seed=0, device=dev)) for impl in ("auto", "plain")}
    losses = {}
    _build.reset_launch_counts()
    for impl in states:
        step = make_train_step(cfg, impl)
        losses[impl] = []
        for batch in batches:
            states[impl], aux = step(states[impl], batch)
            losses[impl].append(float(aux["loss"]))
    counts = _build.launch_counts()
    if dedup:
        assert counts["fused_gather_joint_lookup"] == 3
        assert counts["joint_lookup_bwd"] == 3
        assert counts["gather_row_groups"] == counts["joint_lookup"] == 0
        assert counts["embedding_bag"] == 0
    else:
        assert counts["embedding_bag"] == 6 and counts["gather_row_groups"] == 0
    assert counts["embedding_bag_bwd"] == 0
    np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=0,
                               atol=1e-2)
    for tower, tp in states["plain"].params.items():
        for k, want in tp.items():
            torch.testing.assert_close(states["auto"].params[tower][k], want,
                                       rtol=0, atol=2e-3)
    metrics = {impl: evaluate(states[impl].params, cfg, hashed, 128, impl,
                              cache=False) for impl in ("auto", "plain")}
    for k, v in metrics["plain"].items():
        assert abs(metrics["auto"][k] - v) <= 2e-2, (k, metrics)
