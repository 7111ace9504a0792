"""dssm_tpu_torch's CUDA kernels against their plain PyTorch versions on the
GPU, each alone and through the served model. Marked `cuda`; each test skips
without a card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather and the scatter move or add the same values (exact);
the lookups, their backward kernels (f32 atomics), the loss kernels and the
f32 tower only sum in another order (rtol 1e-5 of the largest value; the loss
kernels 1e-4, their exp differs from the library's in the last bits); the
bf16 tower may round one intermediate to the neighbouring bf16 value (2e-2).
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
from dssm_tpu_torch.kernels.count import (
    count_lookup, count_lookup_bwd, count_lookup_bwd_plain, count_lookup_plain)
from dssm_tpu_torch.kernels.gather import (
    gather_row_groups, gather_row_groups_plain, scatter_add_row_groups,
    scatter_add_row_groups_plain)
from dssm_tpu_torch.kernels.joint import (
    joint_lookup, joint_lookup_bwd, joint_lookup_bwd_plain, joint_lookup_plain)
from dssm_tpu_torch.kernels.loss import (
    in_batch_loss_dd, in_batch_loss_dq, in_batch_loss_grads_plain,
    in_batch_nll, in_batch_nll_plain)
from dssm_tpu_torch.kernels.tower import dense_tower, dense_tower_plain
from dssm_tpu_torch.models import base as model_base
from dssm_tpu_torch.serve import build_doc_index
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_tower_kernel_matches_plain(dev, dtype, tol):
    rng = np.random.default_rng(23)
    dims = (40, 64, 30, 32)  # three layers, widths not multiples of 16
    x = torch.from_numpy(rng.uniform(-1, 1, size=(70, dims[0])).astype(
        np.float32)).to(dev, dtype)
    layers = [(torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1]))
                                .astype(np.float32) * 0.2).to(dev, dtype),
               torch.from_numpy(rng.normal(size=(dims[i + 1],))
                                .astype(np.float32) * 0.1).to(dev, dtype))
              for i in range(len(dims) - 1)]
    for act in ("tanh", "relu"):
        for norm in (True, False):
            got = dense_tower(x, layers, act, norm, impl="kernel")
            want = dense_tower_plain(x, layers, act, norm)
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


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


def _joint_case(rng, dev, rows, kq, kd, u2, gr, h, used):
    sel = np.zeros((u2,), np.int32)  # padding aliases compact row 0
    sel[:used] = np.sort(rng.choice(gr, used, replace=False))
    sel[0] = 0
    sel[used - 1] = gr + 5  # a slot that points past the block: dead
    q_inv, q_wgt = _ragged(rng, rows, kq, used)
    d_inv, d_wgt = _ragged(rng, rows, kd, used)
    q_inv[0, 0], q_wgt[0, 0] = 0, 2.0
    return [torch.from_numpy(a).to(dev)
            for a in (sel, q_inv, q_wgt, d_inv, d_wgt)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_lookup_kernels_match_plain(dev, dtype):
    rng = np.random.default_rng(25)
    for rows, kq, kd, u2, gr, h in ((128, 8, 16, 128, 256, 384),
                                    (50, 5, 70, 96, 200, 100)):
        fields = _joint_case(rng, dev, rows, kq, kd, u2, gr, h, u2 - 6)
        compact = torch.from_numpy(rng.normal(size=(gr, h)).astype(
            np.float32)).to(dev, dtype)
        got = joint_lookup(compact, *fields, impl="kernel")
        want = joint_lookup_plain(compact, *fields)
        for a, b in zip(got, want):
            _close(a, b)
        g_q, g_d = (torch.from_numpy(rng.normal(size=(rows, h)).astype(
            np.float32)).to(dev, dtype) for _ in range(2))
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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_tower_residual_kernel_backward_matches_plain(dev, dtype, tol):
    rng = np.random.default_rng(26)
    dims = (40, 64, 30, 32)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(70, dims[0])).astype(
        np.float32)).to(dev, dtype)
    layers = [(torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1]))
                                .astype(np.float32) * 0.2).to(dev, dtype),
               torch.from_numpy(rng.normal(size=(dims[i + 1],))
                                .astype(np.float32) * 0.1).to(dev, dtype))
              for i in range(len(dims) - 1)]
    gy = torch.from_numpy(rng.normal(size=(70, 32)).astype(np.float32)).to(dev)
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
            for a, b in zip(grads["kernel"], grads["plain"]):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=tol * max(1.0, float(b.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("b,bg,dim,offset", [(128, 128, 128, 0),
                                             (100, 203, 37, 50),
                                             (70, 70, 200, 0)])
def test_loss_kernels_match_plain(dev, b, bg, dim, offset):
    rng = np.random.default_rng(27)
    q = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(b, dim)).astype(np.float32)), dim=1).to(dev)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(bg, dim)).astype(np.float32)), dim=1).to(dev)
    d[offset + 7] = d[offset + 3]  # an exact tie for rows 3 and 7
    q[7] = d[offset + 7]
    q[3] = d[offset + 3]
    labels = (offset + torch.arange(b, dtype=torch.int32)).to(dev)
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
        per_step = ("gather_row_groups", "joint_lookup", "joint_lookup_bwd",
                    "dense_tower_residuals", "in_batch_loss",
                    "in_batch_loss_dq", "in_batch_loss_dd",
                    "scatter_add_row_groups")
        assert all(counts[k] == 3 for k in per_step), counts
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
