"""dssm_tpu_torch's CUDA kernels against their plain PyTorch versions on the
GPU, each alone and through the served model. Marked `cuda`; each test skips
without a card. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather and the scatter move or add the same values (exact);
the lookups, their backward kernels (the count and joint backward sum each
row in a fixed order, with no float atomics, so two calls give the same
bits) and the f32 tower only sum in another order (rtol 1e-5 of the largest
value); the bf16
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
bf16 table the same bf16 values are summed in f32, so the same tolerance);
the bag's forward is the count lookup's kernel body, so the two give the
same bits on the same inputs.
The fused gather + joint lookup sums the same terms in the same order as the
joint lookup kernel after the gather kernel (bit-equal to the two), and in
another order than its plain version (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

from dssm_tpu_torch.bridge import (
    batch_to_device, batch_to_torch, check_raw_rows)
from dssm_tpu_torch.config import (
    DataConfig, LossConfig, RunConfig, TowerConfig, TrainConfig, validate)
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
from dssm_tpu_torch.train.compiled import CompiledStep, state_tensors
from dssm_tpu_torch.train.loop import (
    add_rotation_offsets, make_eager_train_step, make_multi_train_step,
    make_train_step, stack_batches)
from dssm_tpu_torch.train.sparse_update import (
    logical_table_width, uses_sparse_update)
from dssm_tpu_torch.train.state import create_run_state

V, H, GROUP, SLOTS = 4096, 128, 8, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels run only there)")
    return torch.device("cuda")


def _step(cfg, impl):
    """The step a kernels-against-plain test runs: through the kernels the
    compiled step (a replayed CUDA graph); through the plain versions the
    body run eagerly (they read values back, which a capture refuses)."""
    if impl == "plain":
        return make_eager_train_step(cfg, impl)
    return make_train_step(cfg, impl)


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


def _gather_ids(rng, slots, num_groups, pattern):
    """Group ids of `slots` slots: real ids (repeats allowed) mixed with the
    dedupe's sentinel, negative ids and the largest int32; or all sentinel,
    or all real."""
    gids = rng.integers(0, num_groups, size=slots).astype(np.int64)
    if pattern == "all_sentinel":
        gids[:] = SKIP_SENTINEL_GID
    elif pattern == "mixed":
        tail = rng.random(slots) < 0.4
        gids[tail] = SKIP_SENTINEL_GID
        gids[::7] = -1
        gids[3::11] = -(1 << 31)
        gids[5::13] = (1 << 31) - 1
        gids[-1] = num_groups  # one past the last group
    return torch.from_numpy(gids.astype(np.int32))


# (dtype, rows a group, width): groups of 12 KB at width 384 (the `full`
# preset's) and 32 KB at 1024 (cnn's), whole numbers of 16 KB copy stages
# or not; and 8 x 520 f32 (16,640 bytes, a stage and a part).
GATHER_SHAPES = [(torch.float32, 8, 384), (torch.float32, 8, 1024),
                 (torch.bfloat16, 16, 384), (torch.bfloat16, 16, 1024),
                 (torch.int8, 32, 384), (torch.int8, 32, 1024),
                 (torch.float32, 8, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,group,width", GATHER_SHAPES)
def test_gather_kernel_bit_equal_at_every_shape(dev, dtype, group, width):
    """Bit-equal to the plain version for 1 to 2048 slots (more slots than
    one pass of the persistent grid), with empty slots of every kind: the
    sentinel 1 << 25, negative ids, ids past the last group."""
    rng = np.random.default_rng(24)
    v = 1 << 15
    if dtype == torch.int8:
        table = torch.from_numpy(rng.integers(-127, 128, size=(v, width),
                                              dtype=np.int8))
    else:
        table = torch.from_numpy(rng.normal(size=(v, width)).astype(
            np.float32)).to(dtype)
    table = table.to(dev)
    for slots in (1, 5, 256, 1024, 2048):
        for pattern in ("mixed", "all_sentinel", "all_real"):
            gids = _gather_ids(rng, slots, v // group, pattern).to(dev)
            _build.reset_launch_counts()
            got = gather_row_groups(table, gids, group, impl="kernel")
            assert _build.launch_counts()["gather_row_groups"] == 1
            want = gather_row_groups_plain(table, gids, group)
            assert got.shape == (slots * group, width)
            assert torch.equal(got, want), (slots, pattern)


# (u2, h, rows, k): small ragged rows; the `full` eval lookups (K = 64 and
# 32 over a 1024 x 384 block); the cnn eval lookups (16,384 word rows of 8
# over h = 1024); widths that are no whole number of 16-byte vectors.
COUNT_CASES = [(128, 384, 256, 32), (128, 384, 100, 70), (1024, 384, 1024, 64),
               (1024, 384, 1024, 32), (1024, 1024, (1024, 16), 8),
               (128, 100, 300, 20), (128, 36, 300, 20)]


def _count_case(rng, u2, rows, k, dev):
    """inv, wgt [*rows, k]: ragged rows, and some live weights on slots
    outside [0, u2) (past it, and negative), which add nothing."""
    shape = rows if isinstance(rows, tuple) else (rows,)
    inv, wgt = _ragged(rng, int(np.prod(shape)), k, u2)
    inv[::7, 0], wgt[::7, 0] = u2 + 3, 2.0
    inv[3::11, k - 1], wgt[3::11, k - 1] = -5, 1.5
    return [torch.from_numpy(a.reshape(*shape, k)).to(dev)
            for a in (inv, wgt)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(22)
    for u2, h, rows, k in COUNT_CASES:
        c2 = torch.from_numpy(rng.normal(size=(u2, h)).astype(np.float32))
        c2 = c2.to(dev, dtype)
        inv, wgt = _count_case(rng, u2, rows, k, dev)
        got = count_lookup(c2, inv, wgt, impl="kernel")
        want = count_lookup_plain(c2, inv, wgt)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_kernel_bit_equal_to_joint_lookup(dev, dtype):
    """The count lookup sums each column over the live pairs in k order from
    0, as the joint lookup kernel does: through sel = arange(u2) the two
    give the same bits, on both sides of a joint batch."""
    rng = np.random.default_rng(23)
    for u2, h, rows, kq, kd in ((1024, 384, 1024, 32, 64),
                                (1024, 1024, (1024, 16), 8, 8),
                                (128, 100, 300, 12, 20), (128, 36, 50, 5, 70)):
        c2 = torch.from_numpy(rng.normal(size=(u2, h)).astype(np.float32))
        c2 = c2.to(dev, dtype)
        q_inv, q_wgt = _count_case(rng, u2, rows, kq, dev)
        d_inv, d_wgt = _count_case(rng, u2, rows, kd, dev)
        sel = torch.arange(u2, dtype=torch.int32, device=dev)
        lq, ld = joint_lookup(c2, sel, q_inv, q_wgt, d_inv, d_wgt,
                              impl="kernel")
        assert torch.equal(count_lookup(c2, q_inv, q_wgt, impl="kernel"), lq)
        assert torch.equal(count_lookup(c2, d_inv, d_wgt, impl="kernel"), ld)


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


# (rows, k, u2, h, extra) of the count lookup's backward: small ragged rows;
# the per-side `full` step's d and q sides (1024 rows of K = 64 and 32 into
# 1024 compact rows of 384); the sequence towers' 3-D rows at h = 100 (no
# whole number of 16-byte bf16 vectors); K > 128; one compact row named by
# every lookup (a segment of ~1000 pieces). Every case has dead lookups
# (weight 0 on a slot in range, live weights on slots past u2 and negative)
# and rows with no live lookup.
COUNT_BWD_CASES = [
    (256, 32, 128, 384, {}),
    (1024, 64, 1024, 384, {}),
    (1024, 32, 1024, 384, {}),
    ((64, 16), 8, 512, 100, {}),
    (300, 200, 96, 36, {}),
    (512, 64, 64, 384, {"every": 7}),
]


def _count_bwd_case(rng, dev, rows, k, u2, h, g_dtype, every=None):
    """inv, wgt [*rows, k] as _count_case, with weight 0 on some slots in
    range, the first 3 rows with no live lookup, the last 5 slots named by
    no lookup and, with `every`, every live lookup on slot `every`; g
    [*rows, h] normal."""
    shape = rows if isinstance(rows, tuple) else (rows,)
    inv, wgt = (t.cpu().numpy().reshape(-1, k)
                for t in _count_case(rng, u2, rows, k, dev))
    inv[(inv >= u2 - 5) & (inv < u2)] = 0
    if every is not None:
        inv[:] = every
        wgt[:] = rng.integers(1, 4, size=wgt.shape)
    live = (wgt != 0) & (inv >= 0) & (inv < u2)
    wgt[live & (rng.random(live.shape) < 0.1)] = 0.0  # dead, slot in range
    wgt[:3] = 0.0
    g = torch.from_numpy(rng.normal(size=(*shape, h)).astype(
        np.float32)).to(dev, g_dtype)
    return [torch.from_numpy(a.reshape(*shape, k)).to(dev)
            for a in (inv, wgt)] + [g]


def _named(inv, wgt, u2):
    """Compact rows some live lookup names (a bool mask over [0, u2))."""
    live = (wgt != 0) & (inv >= 0) & (inv < u2)
    hit = torch.zeros(u2, dtype=torch.bool, device=inv.device)
    hit[inv[live].long()] = True
    return hit


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_count_backward_kernel_matches_plain(dev, g_dtype):
    rng = np.random.default_rng(24)
    for rows, k, u2, h, extra in COUNT_BWD_CASES:
        inv, wgt, g = _count_bwd_case(rng, dev, rows, k, u2, h, g_dtype,
                                      **extra)
        _close(count_lookup_bwd(inv, wgt, g, u2, impl="kernel"),
               count_lookup_bwd_plain(inv, wgt, g, u2))
    # Through autograd: the gradient comes back in compact2's dtype.
    inv, wgt, g = _count_bwd_case(rng, dev, 100, 70, 128, 100, g_dtype)
    c2 = torch.zeros((128, 100), device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    count_lookup(c2, inv, wgt, impl="kernel").backward(g.float())
    assert c2.grad.dtype == torch.bfloat16
    _close(c2.grad.float(), count_lookup_bwd_plain(inv, wgt, g, 128), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_count_lookup_bwd_bit_reproducible_and_writes_every_row(dev,
                                                                g_dtype):
    """No float atomics: two calls give the same bits. Every row of
    d_compact2 is written by the kernel, exactly 0 where no live lookup
    names it, though the memory the caching allocator hands out was left
    full of NaN bits (and the scratch's counters of -1) by a freed tensor.
    One counted launch a call."""
    rng = np.random.default_rng(30)
    for rows, k, u2, h, extra in COUNT_BWD_CASES:
        inv, wgt, g = _count_bwd_case(rng, dev, rows, k, u2, h, g_dtype,
                                      **extra)
        runs = []
        for _ in range(2):
            junk = torch.full((64 << 20,), 255, dtype=torch.uint8, device=dev)
            del junk
            before = _build.launch_counts()["count_lookup_bwd"]
            runs.append(count_lookup_bwd(inv, wgt, g, u2, impl="kernel"))
            assert _build.launch_counts()["count_lookup_bwd"] == before + 1
        assert torch.equal(runs[0], runs[1])
        hit = _named(inv, wgt, u2)
        assert not bool(hit.all())
        assert bool((runs[0][~hit] == 0).all())
        assert bool(torch.isfinite(runs[0]).all())
        _close(runs[0], count_lookup_bwd_plain(inv, wgt, g, u2))


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
# of both sides (~1500 pieces), lookups that name sel's padding (row 0),
# and the int8 step's dequantized block (256 slots of 32 rows).
JOINT_CASES = [
    (128, 8, 16, 128, 256, 384, {}),
    (50, 5, 70, 96, 200, 100, {"dead_rows": 3}),
    (1024, 32, 64, 1024, 2048, 384, {"dead_rows": 5}),
    (256 * 16, 8, 8, 2048, 8192, 1024, {"dead_rows": 40}),
    (1024, 32, 64, 1024, 2048, 384, {"every": 7, "dead_rows": 2}),
    (300, 12, 20, 256, 1024, 96, {"name_padding": True}),
    (1024, 32, 64, 1024, 8192, 384, {"dead_rows": 5}),  # the int8 step's
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


def _slot_ids(rng, slots, layout, num_groups):
    """Group ids of a scatter call: every slot real ("real": distinct, the
    table's last group among them), one skip slot ("skip"), or a third of
    the slots real among skip ids of every kind ("mixed": the sentinel,
    negative, one past the table) at any position, the last group among
    them."""
    if layout == "real":
        gids = rng.choice(num_groups - 1, slots, replace=False)
        gids[rng.integers(slots)] = num_groups - 1
    elif layout == "skip":
        gids = np.array([num_groups])
    else:
        gids = rng.choice([SKIP_SENTINEL_GID, -1, -(1 << 30), num_groups],
                          size=slots)
        real = rng.choice(slots, slots // 3, replace=False)
        gids[real] = rng.choice(num_groups - 1, real.size, replace=False)
        gids[real[0]] = num_groups - 1
    return gids.astype(np.int32)


# The scatter-adds at 1, 64, 256 and 1024 slots (the cnn dedupe batch's
# count), laid out as _slot_ids says, at widths 100, 384 and 1024 (a group
# is a whole number of 16-byte vectors at each: 8 f32 or 16 bf16 rows).
SCATTER_ADD_SLOTS = [(1, "real"), (1, "skip"), (64, "real"), (64, "mixed"),
                     (256, "real"), (256, "mixed"), (1024, "real"),
                     (1024, "mixed")]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [100, 384, 1024])
@pytest.mark.parametrize("slots,layout", SCATTER_ADD_SLOTS)
def test_scatter_kernel_matches_plain_in_place(dev, slots, layout, width):
    rng = np.random.default_rng(28)
    rows = GROUP * 2200
    table = torch.from_numpy(rng.normal(size=(rows, width)).astype(
        np.float32)).to(dev)
    gids = torch.from_numpy(_slot_ids(rng, slots, layout,
                                      rows // GROUP)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(slots * GROUP, width)).astype(
        np.float32)).to(dev)
    want = scatter_add_row_groups_plain(table.clone(), gids, vals, GROUP)
    got = table.clone()
    out = scatter_add_row_groups(got, gids, vals, GROUP, impl="kernel")
    assert out is got and out.data_ptr() == got.data_ptr()
    assert torch.equal(got, want)
    assert torch.equal(got, table) == (layout == "skip")


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
        step = _step(cfg, impl)
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


# 1, 64 and 256 slots, every slot real or real ones among skip ids of every
# kind (the sentinel, negative, one past the table) at any position, the
# table's last group always among them; widths 100 (no whole 16-byte vector
# a row), 384 and 1024.
@pytest.mark.cuda
@pytest.mark.parametrize("width", [100, 384, 1024])
@pytest.mark.parametrize("slots,layout", [(1, "real"), (1, "skip"),
                                          (64, "real"), (64, "mixed"),
                                          (256, "real"), (256, "mixed")])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_scatter_sr_kernels_bit_equal_to_plain(dev, kind, slots, layout,
                                               width):
    rng = np.random.default_rng(29)
    rows = 32 * 320  # 640 bf16 groups, 320 int8 groups
    if kind == "bf16":
        group, fn, plain = 16, scatter_sr_row_groups, scatter_sr_row_groups_plain
        table = torch.from_numpy((rng.normal(size=(rows, width)) * 0.05).astype(
            np.float32)).to(dev, torch.bfloat16)
        vals = (rng.normal(size=(slots * group, width)) * 1e-4).astype(
            np.float32)
    else:
        group, fn, plain = (32, scatter_sr_int8_row_groups,
                            scatter_sr_int8_row_groups_plain)
        table = torch.from_numpy(rng.integers(
            -127, 128, size=(rows, width)).astype(np.int8)).to(dev)
        vals = rng.uniform(-3, 3, size=(slots * group, width)).astype(
            np.float32)
    vals = torch.from_numpy(vals).to(dev)
    gids = torch.from_numpy(_slot_ids(rng, slots, layout,
                                      rows // group)).to(dev)
    moves = layout != "skip"
    for seed in (0, -7, 2 ** 31 - 1):
        want = plain(table.clone(), gids, vals, group, seed)
        got = table.clone()
        out = fn(got, gids, vals, group, seed, impl="kernel")
        assert out is got and torch.equal(got, want)
        assert torch.equal(got, table) != moves
    same = fn(table.clone(), gids, torch.zeros_like(vals), group, 3,
              impl="kernel")
    assert torch.equal(same, table)  # a zero update moves nothing
    a = fn(table.clone(), gids, vals, group, 1, impl="kernel")
    b = fn(table.clone(), gids, vals, group, 2, impl="kernel")
    assert torch.equal(a, b) != moves  # the seed is the stream's key


@pytest.mark.cuda
@pytest.mark.parametrize("width", [100, 384, 1024])
@pytest.mark.parametrize("slots,layout", SCATTER_ADD_SLOTS)
def test_scatter_add_bf16_kernel_matches_plain(dev, slots, layout, width):
    rng = np.random.default_rng(30)
    rows = 16 * 1100
    table = torch.from_numpy((rng.normal(size=(rows, width)) * 0.05).astype(
        np.float32)).to(dev, torch.bfloat16)
    gids = torch.from_numpy(_slot_ids(rng, slots, layout, rows // 16)).to(dev)
    vals = torch.from_numpy((rng.normal(size=(slots * 16, width)) * 1e-3)
                            .astype(np.float32)).to(dev, torch.bfloat16)
    want = scatter_add_row_groups_plain(table.clone(), gids, vals, 16)
    got = table.clone()
    out = scatter_add_row_groups(got, gids, vals, 16, impl="kernel")
    assert out is got and torch.equal(got, want)
    assert torch.equal(got, table) == (layout == "skip")


# The eval passes of `full` (6553 pairs) and `multihost` (13107); ragged
# edges; one q tile against many doc tiles; one query; D = 36, and D = 260
# and 680, deeper than one (320) and than two passes of q.
@pytest.mark.cuda
@pytest.mark.parametrize("n,nd,dim", [(600, 600, 128), (70, 203, 36),
                                      (1000, 1777, 128), (6553, 6553, 128),
                                      (13107, 13107, 128), (129, 4000, 128),
                                      (1, 300, 128), (300, 700, 260),
                                      (200, 517, 680)])
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


def _low_precision_tables_close(ta, tp, scale=1.0, before=None, cap=2e-3):
    """A bf16 or int8 table after 3 steps through the kernels (ta) and
    through the plain versions (tp). The same stream on accumulators that
    differ in their last bits (the backward's sum order, a bf16 activation
    of the tower): few elements differ at all, next to none by more than a
    grid step (an update that nearly cancels a weight leaves a finer grid
    behind), and none by more than `cap` in the weights' units (the f32
    test's 2e-3; an int8 row's scale, its one grid step, may be above
    that: a rounding tipped once moves an element by it). Given the table
    `before` the steps (the row-wise AdaGrad table), a bf16 grid step is
    the ulp of the largest of the old and the two new values, and next to
    none lie more than two apart (AdaGrad's first steps move a weight by
    several times its size, so a sum lands in a far finer binade than it
    was formed in, as tests/test_torch_lowprec.py counts it; it rescales
    each row by its gradient's norm, so the accumulators' last bits tip
    more roundings than an sgd update's)."""
    diff = (ta.float() - tp.float()).abs()
    if ta.dtype == torch.int8:
        far = diff > 1.0
    elif before is None:
        far = diff > 2.0 ** -7 * tp.float().abs() + 1e-30
    else:
        big = torch.maximum(torch.maximum(ta.float().abs(), tp.float().abs()),
                            before.float().abs())
        expo = (big.view(torch.int32) >> 23) & 0xFF
        ulp = ((expo - 7).clamp(min=1) << 23).view(torch.float32)
        far = diff > 2 * ulp
    assert float(far.float().mean()) < 1e-3
    if before is None:
        assert float((ta != tp).float().mean()) < 0.01
    assert bool((diff * scale <= cap).all())


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
        step = _step(cfg, impl)
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
    _low_precision_tables_close(
        ta, tp, states["plain"].params["shared"].get("W0_scale", 1.0))
    metrics = {impl: evaluate(states[impl].params, cfg, hashed, 128, impl,
                              cache=False) for impl in ("auto", "plain")}
    assert _build.launch_counts()["rank_counts"] == 1
    for k, v in metrics["plain"].items():
        assert abs(metrics["auto"][k] - v) <= 2e-2, (k, metrics)


def _train_config(arch="mlp", shared=True, table_dtype="float32",
                  optimizer="sgd", table_optimizer="sgd", loss_mode="in_batch",
                  dedup=True, n=3):
    """A small config and n numpy batches of its stream, as cli.train
    feeds them. The mlp: a 4096 x 128 table (100 columns real), 100 -> 64
    -> 32; cnn / lstm: conv 3 x 40, LSTM 32, 6 words of 8 trigrams; batch
    128, bf16 compute. Dedupe at the table dtype's group (an int8 table's
    32-row groups take half the f32 slots, all 128 groups of the table),
    joint with shared weights, per-side without; raw-index batches without
    dedupe (the dense-table step's, under momentum); rotate batches keep
    their row order and carry rot_offsets. lr 0.01 under the AdaGrad table
    (the dssm_tpu fixture's, with adam), 0.1 otherwise."""
    seq = arch != "mlp"
    if seq:
        uniq = 1024 if table_dtype == "int8" else 2048
        data = DataConfig(max_trigrams=16, max_words=6,
                          max_trigrams_per_word=8, max_unique=uniq,
                          max_unique_rows=256, dedup_lookup=dedup)
    else:
        data = DataConfig(max_trigrams=16, max_trigrams_query=8,
                          max_unique=1024, max_unique_rows=128,
                          dedup_lookup=dedup)
    cfg = validate(RunConfig(
        tower=TowerConfig(arch=arch, vocab_size=V, embed_width=100,
                          hidden_dims=(64,), conv_channels=40, lstm_hidden=32,
                          semantic_dim=32, compute_dtype="bfloat16",
                          shared_weights=shared, table_dtype=table_dtype),
        data=data, loss=LossConfig(mode=loss_mode),
        train=TrainConfig(batch_size=128, optimizer=optimizer,
                          table_optimizer=table_optimizer,
                          learning_rate=(0.01 if table_optimizer == "adagrad"
                                         else 0.1))))
    hashed = hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data)
    flat = dedup and not seq
    it = batch_iterator(hashed, 128, seq, seed=3,
                        dedup_unique=data.max_unique if dedup else None,
                        dedup_group={"int8": 32, "bfloat16": 16}.get(
                            table_dtype, 8),
                        dedup_unique_rows=data.max_unique_rows,
                        dedup_joint=shared, wire_compress=flat,
                        sort_rows=flat and loss_mode != "rotate")
    return cfg, hashed, [add_rotation_offsets(next(it), cfg, i)
                         for i in range(n)]


# branch: (arch, shared weights, table dtype)
REPRO_BRANCHES = {
    "per_side": ("mlp", False, "float32"), "int8_joint": ("mlp", True, "int8"),
    "f32_joint": ("mlp", True, "float32"),
    "bf16_joint": ("mlp", True, "bfloat16"),
    "cnn_f32_joint": ("cnn", True, "float32"),
    "cnn_bf16_joint": ("cnn", True, "bfloat16"),
    "lstm_f32_joint": ("lstm", True, "float32"),
    "lstm_bf16_joint": ("lstm", True, "bfloat16"),
    "cnn_per_side": ("cnn", False, "float32")}


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(REPRO_BRANCHES))
def test_train_steps_bit_reproducible(dev, branch):
    """Three steps run twice from one state give bit-equal tables and dense
    parameters: the per-side branch on an f32 table (two count lookup
    backward calls a step), the joint branch on an int8 table (the gather,
    the dequantization and the joint lookup) and on an f32 and a bf16
    table (the fused gather + joint lookup), each with the joint backward,
    the low-precision tables with their stochastic-rounding scatter; the
    cnn and lstm towers on the joint branch (f32 and bf16 tables) and the
    cnn on the per-side branch. No kernel on these paths adds floats with
    atomics (the raw branch's index_add_ does: not here)."""
    arch, shared, table_dtype = REPRO_BRANCHES[branch]
    int8 = table_dtype == "int8"
    cfg, _, batches_np = _train_config(arch, shared, table_dtype)
    batches = [batch_to_torch(b, dev) for b in batches_np]
    runs = []
    for _ in range(2):
        state = create_run_state(cfg, model_base.init_params(
            cfg.tower, seed=0, device=dev))
        step = make_train_step(cfg, "auto")
        _build.reset_launch_counts()
        for batch in batches:
            state, _ = step(state, batch)
        counts = _build.launch_counts()
        if int8:
            assert counts["joint_lookup"] == counts["joint_lookup_bwd"] == 3
            assert counts["scatter_sr_int8_row_groups"] == 3
        elif shared:
            sr = counts["scatter_sr_row_groups"]
            assert sr == (3 if table_dtype == "bfloat16" else 0)
            assert counts["fused_gather_joint_lookup"] == 3
            assert counts["joint_lookup_bwd"] == 3
        else:
            assert counts["count_lookup_bwd"] == 6
        runs.append(state.params)
    for tower, tp in runs[0].items():
        for k, v in tp.items():
            assert torch.equal(v, runs[1][tower][k]), (tower, k)


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
    # A live lookup outside the table is refused on the host, where the
    # entry points check the numpy batch (bridge.check_raw_rows); the
    # kernel reads nothing back, and a lookup outside the table that
    # reaches it reads nothing and adds nothing, as in the plain version.
    idx_bad, wgt_bad = idx.clone(), wgt.clone()
    idx_bad.view(-1)[0], wgt_bad.view(-1)[0] = V + 7, 1.0
    with pytest.raises(IndexError):
        check_raw_rows({"q_idx": idx_bad.cpu().numpy(),
                        "q_wgt": wgt_bad.cpu().numpy()}, V)
    got = embedding_bag(table, idx_bad, wgt_bad, impl="kernel")
    wgt_dead = wgt_bad.clone()
    wgt_dead.view(-1)[0] = 0.0
    assert torch.equal(got, embedding_bag(table, idx_bad, wgt_dead,
                                          impl="kernel"))
    want = embedding_bag_plain(table, idx_bad, wgt_bad)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# (rows shape + K, width): the `full` raw batch's q and d sides, the cnn and
# lstm raw batches' word rows.
BAG_SHAPES = {"full_q": ((1024, 32), 384), "full_d": ((1024, 64), 384),
              "cnn": ((1024, 16, 8), 1024), "lstm": ((1024, 16, 8), 384)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BAG_SHAPES))
def test_embedding_bag_bit_equal_to_count_lookup(dev, dtype, case):
    """The bag forward and the count lookup run one kernel body: on the same
    inputs (compact2 = the table) they give the same bits, and two calls
    too; within 1e-5 of the plain version. Rows with no live lookup come
    back 0; a row whose every lookup names one table row sums it K times;
    dead lookups whose index lies outside the table read nothing."""
    shape, width = BAG_SHAPES[case]
    rng = np.random.default_rng(33)
    v = 100_000
    table = torch.from_numpy(rng.normal(size=(v, width)).astype(
        np.float32)).to(dev, dtype)
    k = shape[-1]
    idx = rng.integers(0, v, size=shape).astype(np.int32)
    wgt = rng.integers(1, 4, size=shape).astype(np.float32)
    nnz = rng.integers(0, k + 1, size=shape[:-1])
    dead = np.arange(k) >= nnz[..., None]
    wgt[dead] = 0.0
    idx[dead & (rng.random(shape) < 0.3)] = v + 7
    idx[dead & (rng.random(shape) < 0.3)] = -3
    flat_i, flat_w = idx.reshape(-1, k), wgt.reshape(-1, k)
    flat_w[::9] = 0.0          # rows with no live lookup
    flat_i[1::9] = v + 1       # ... whose indices lie outside the table
    flat_w[1::9] = 0.0
    flat_i[4], flat_w[4] = 12345, 2.0  # every lookup names one row
    idx, wgt = torch.from_numpy(idx).to(dev), torch.from_numpy(wgt).to(dev)
    _build.reset_launch_counts()
    got = embedding_bag(table, idx, wgt, impl="kernel")
    again = embedding_bag(table, idx, wgt, impl="kernel")
    via_count = count_lookup(table, idx, wgt, impl="kernel")
    counts = _build.launch_counts()
    assert counts["embedding_bag"] == 2 and counts["count_lookup"] == 1
    want = embedding_bag_plain(table, idx, wgt)
    assert got.dtype == torch.float32 and got.shape == (*shape[:-1], width)
    assert torch.equal(got, again) and torch.equal(got, via_count)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    rows = got.reshape(-1, width)
    assert not bool(rows[::9].any()) and not bool(rows[1::9].any())
    torch.testing.assert_close(rows[4], k * 2.0 * table[12345].float(),
                               rtol=1e-5, atol=0)


# d_wgt at BAG_SHAPES and at K = 1, 7, 70 (9 chunks of 8, the last one
# ragged) and 129, widths 36 (f32 tables only: 36 bf16 columns are not
# whole 16-byte vectors), 520 and 1024; f32 and bf16 tables and gradients.
DWGT_SHAPES = {**BAG_SHAPES, "k1": ((512, 1), 1024), "k7": ((300, 7), 36),
               "k70": ((96, 70), 520), "k129": ((64, 129), 1024)}
DWGT_CASES = [(case, dtype, g_dtype) for case in sorted(DWGT_SHAPES)
              for dtype in ("float32", "bfloat16")
              for g_dtype in ("float32", "bfloat16")
              if dtype == "float32" or DWGT_SHAPES[case][1] % 8 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,g_dtype", DWGT_CASES)
def test_embedding_bag_dwgt_at_every_shape(dev, case, dtype, g_dtype):
    """The weight gradient within 1e-5 x max |d_wgt| of the plain version,
    and two calls bit-equal. Lookups outside the table (past it and
    negative) get 0; a row of all padding (index 0) is computed, the same
    dot product at every k."""
    shape, width = DWGT_SHAPES[case]
    rng = np.random.default_rng(34)
    v = 100_000
    table = torch.from_numpy(rng.normal(size=(v, width)).astype(
        np.float32)).to(dev, getattr(torch, dtype))
    k = shape[-1]
    idx = rng.integers(0, v, size=shape).astype(np.int32)
    idx[rng.random(shape) < 0.1] = v + 7
    idx[rng.random(shape) < 0.1] = -3
    idx.reshape(-1, k)[::7] = 0  # rows of all padding
    idx = torch.from_numpy(idx).to(dev)
    g = torch.from_numpy(rng.normal(size=(*shape[:-1], width)).astype(
        np.float32)).to(dev, getattr(torch, g_dtype))
    _build.reset_launch_counts()
    got = embedding_bag_dwgt(table, idx, g, impl="kernel")
    again = embedding_bag_dwgt(table, idx, g, impl="kernel")
    assert _build.launch_counts()["embedding_bag_bwd"] == 2
    want = embedding_bag_dwgt_plain(table, idx, g)
    assert got.dtype == torch.float32 and got.shape == shape
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert not bool(got[(idx < 0) | (idx >= v)].any())
    pad = got.reshape(-1, k)[::7]
    assert bool(pad.any()) and torch.equal(pad, pad[:, :1].expand_as(pad))


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
        step = _step(cfg, impl)
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


# A configuration no earlier GPU test ran, as _train_config's arguments:
# per-side sequence towers; sequence towers on bf16 and int8 tables; the
# row-wise AdaGrad table with adam on the dense parameters (the dssm_tpu
# fixture's optimizers); momentum (with the sgd table optimizer: the
# dense-table step, on raw-index batches); the rotate loss.
TRAIN_CONFIGS = {
    "cnn-per_side": dict(arch="cnn", shared=False),
    "lstm-per_side": dict(arch="lstm", shared=False),
    "cnn-bf16": dict(arch="cnn", table_dtype="bfloat16"),
    "cnn-int8": dict(arch="cnn", table_dtype="int8"),
    "lstm-bf16": dict(arch="lstm", table_dtype="bfloat16"),
    "lstm-int8": dict(arch="lstm", table_dtype="int8"),
    "mlp-adagrad-f32": dict(optimizer="adam", table_optimizer="adagrad"),
    "mlp-adagrad-bf16": dict(table_dtype="bfloat16", optimizer="adam",
                             table_optimizer="adagrad"),
    "cnn-adagrad-f32": dict(arch="cnn", optimizer="adam",
                            table_optimizer="adagrad"),
    "mlp-momentum": dict(optimizer="momentum", dedup=False),
    "mlp-rotate-f32": dict(loss_mode="rotate"),
    "mlp-rotate-bf16": dict(table_dtype="bfloat16", loss_mode="rotate"),
    "cnn-rotate": dict(arch="cnn", loss_mode="rotate"),
}


def _launches_per_step(cfg):
    """{kernel: launches} of one step of cfg, as the steps' code makes
    them (train/sparse_update.py, train/loop.py)."""
    t = cfg.tower
    out = ({} if cfg.loss.mode == "rotate" else
           {"in_batch_loss": 1, "in_batch_loss_dq": 1, "in_batch_loss_dd": 1})
    if not uses_sparse_update(cfg):  # the dense-table step: a side a call
        return {"embedding_bag": 2, "dense_tower_residuals": 2, **out}
    sides = 1 if t.shared_weights else 2  # the shared mlp stacks its sides
    if t.arch == "mlp":
        out["dense_tower_residuals"] = sides
    if not cfg.data.dedup_lookup:  # the raw branch: index_add_ updates
        return {"embedding_bag": 2, **out}
    out[{"float32": "scatter_add_row_groups",
         "bfloat16": "scatter_sr_row_groups",
         "int8": "scatter_sr_int8_row_groups"}[t.table_dtype_resolved]] = sides
    if not t.shared_weights:
        return {"gather_row_groups": 2, "count_lookup": 2,
                "count_lookup_bwd": 2, **out}
    if t.table_dtype_resolved == "int8":
        out.update(gather_row_groups=1, joint_lookup=1)
    else:
        out["fused_gather_joint_lookup"] = 1
    return {"joint_lookup_bwd": 1, **out}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRAIN_CONFIGS))
def test_train_configs_kernels_match_plain(dev, name):
    """3 steps through the kernels and through the plain versions from one
    state, every kernel's launches a step counted; then both evaluated.
    Losses 1e-2 and f32 tensors 2e-3, as the sequence towers' test (an f32
    AdaGrad table: next to none beyond 2e-3, see below); a bf16 or int8
    table as the low-precision test (_low_precision_tables_close; AdaGrad's
    bf16 table in ulps of the largest of the old and the two new values;
    an int8 element at most one level apart: the 4096 x 128 tables here
    have row scales of 2.4e-3, above the bf16 tables' 2e-3 cap, and the
    lstm's step tipped one rounding in 3 steps on an H100). Under adam the
    dense parameters' first moments (the gradients' running mean) lie
    within 0.1 of their norm: adam's update is the sign of a gradient that
    is f32 noise, +-lr in either run. The AdaGrad accumulator (the table's
    last column) moved on gathered rows only, and the dead padding columns
    before it stay 0."""
    cfg, hashed, batches_np = _train_config(**TRAIN_CONFIGS[name])
    batches = [batch_to_torch(b, dev, vocab_size=V) for b in batches_np]
    init = model_base.init_params(cfg.tower, seed=0, device=dev)
    states, losses = {}, {}
    for impl in ("auto", "plain"):
        state = create_run_state(cfg, {tw: {k: v.clone() for k, v in
                                            tp.items()}
                                       for tw, tp in init.items()})
        step = _step(cfg, impl)
        _build.reset_launch_counts()
        losses[impl] = []
        for batch in batches:
            state, aux = step(state, batch)
            losses[impl].append(float(aux["loss"]))
        if impl == "auto":
            counts = {k: v for k, v in _build.launch_counts().items() if v}
        states[impl] = state
    assert counts == {k: 3 * n for k, n in _launches_per_step(cfg).items()}, (
        counts)
    np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=0,
                               atol=1e-2)
    key = model_base.TABLE_KEY[cfg.tower.arch]
    adagrad = cfg.train.table_optimizer == "adagrad"
    adam = cfg.train.optimizer == "adam"
    for tower, tp in states["plain"].params.items():
        for k, want in tp.items():
            got = states["auto"].params[tower][k]
            if k == f"{key}_scale":
                assert torch.equal(got, init[tower][k])
            elif k == key and want.dtype != torch.float32:
                # An int8 element at most one level (its row's scale) from
                # the plain run's.
                scale = tp.get(f"{key}_scale", 1.0)
                _low_precision_tables_close(
                    got, want, scale, init[tower][k] if adagrad else None,
                    scale if want.dtype == torch.int8 else 2e-3)
            elif k == key and adagrad:
                # An f32 AdaGrad table: next to none beyond 2e-3, the
                # update within 0.1 of itself (chip_smoke.py's measure).
                # AdaGrad scales each row's step to ~lr whatever its
                # gradient's size, so where a cnn channel's max-pool tips to
                # another word under bf16 (a near-tie, as against
                # dssm_tpu) the words' rows move by ~lr, not by lr x |g|:
                # 69 of 524,288 elements, up to 0.014, on an H100; 1.1e-7
                # under f32 compute.
                diff = (got - want).abs()
                assert float((diff > 2e-3).float().mean()) < 1e-3
                assert float(torch.linalg.vector_norm(got - want)) <= 0.1 * (
                    float(torch.linalg.vector_norm(want - init[tower][k])))
            elif k == key or not adam:
                torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    if adam:
        for tower, tp in states["plain"].opt_state["mu"].items():
            for k, want in tp.items():
                got = states["auto"].opt_state["mu"][tower][k]
                assert float(torch.linalg.vector_norm(got - want)) <= (
                    0.1 * float(torch.linalg.vector_norm(want))), (tower, k)
    if adagrad:
        table, before = (p["shared"][key] for p in
                         (states["auto"].params, init))
        group = {"bfloat16": 16}.get(cfg.tower.table_dtype_resolved, 8)
        gids = np.concatenate([b["uniq"] for b in batches_np])
        gids = torch.from_numpy(gids[gids < V // group].astype(np.int64))
        touched = torch.zeros((V,), dtype=torch.bool, device=dev)
        touched[(gids[:, None] * group
                 + torch.arange(group)).reshape(-1).to(dev)] = True
        acc_moved = table[:, -1] != before[:, -1]
        assert bool(acc_moved[touched].any())
        assert not bool(acc_moved[~touched].any())
        assert not bool(table[:, logical_table_width(cfg):-1].float().any())
    metrics = {impl: evaluate(states[impl].params, cfg, hashed, 128, impl,
                              cache=False) for impl in ("auto", "plain")}
    for k, v in metrics["plain"].items():
        assert abs(metrics["auto"][k] - v) <= 2e-2, (k, metrics)


def _step_case(dev, kind, n, table_dtype="float32"):
    """A small config of one step kind and n numpy batches of its stream:
    "dense" (the dense-table step with sgd, sparse_embed_update=False, raw
    batches), "dense_adam" (adam with the sgd table optimizer: the dense
    step too), "raw" (the sparse raw branch) or "joint" (the sparse joint
    branch on dedupe batches)."""
    raw = kind != "joint"
    adam = kind == "dense_adam"
    cfg = RunConfig(
        tower=TowerConfig(vocab_size=V, embed_width=100, hidden_dims=(64,),
                          semantic_dim=32, compute_dtype="bfloat16",
                          table_dtype=table_dtype),
        data=DataConfig(max_trigrams=16, max_trigrams_query=8,
                        max_unique=1024, max_unique_rows=128,
                        dedup_lookup=not raw),
        loss=LossConfig(),
        train=TrainConfig(batch_size=128, learning_rate=0.01 if adam else 0.1,
                          optimizer="adam" if adam else "sgd",
                          sparse_embed_update=kind != "dense"))
    hashed = hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data)
    group = {"int8": 32, "bfloat16": 16}.get(table_dtype, 8)
    it = batch_iterator(hashed, 128, seed=3,
                        dedup_unique=None if raw else 1024,
                        dedup_group=group, dedup_unique_rows=128,
                        dedup_joint=True, wire_compress=not raw,
                        sort_rows=not raw)
    return cfg, [next(it) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "dense_adam", "raw", "joint"])
def test_train_step_reads_nothing_back(dev, kind):
    """A step and the move of its batch (pinned, queued behind the steps
    before it) under torch.cuda.set_sync_debug_mode("error"): a
    synchronising call raises. The range check of a raw batch runs on the
    host, on the numpy batch, so the dense and the raw sparse step wait for
    the card nowhere; so does the joint step. Both the compiled step's
    replay (its batch as a wire block, and as widened fields packed into
    one) and the body run eagerly."""
    cfg, batches = _step_case(dev, kind, 3)
    init = model_base.init_params(cfg.tower, seed=0, device=dev)
    for step in (make_train_step(cfg, "auto"),
                 make_eager_train_step(cfg, "auto")):
        state = create_run_state(cfg, {t: {k: v.clone() for k, v in
                                           tp.items()}
                                       for t, tp in init.items()})
        # The first call warms (the kernel library, cuBLAS handles) and,
        # compiled, captures.
        state, _ = step(state, batch_to_device(batches[0], dev,
                                               vocab_size=V))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, aux = step(state, batch_to_device(batches[1], dev,
                                                     vocab_size=V))
            state, aux = step(state, batch_to_torch(batches[2], dev,
                                                    vocab_size=V))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert np.isfinite(float(aux["loss"])) and state.step == 3
        assert state.host_step == 3


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_multi_step_bit_equal_to_single_steps(dev, table_dtype):
    """K = 3 steps a call against 3 single steps from one state, on the
    joint branch: the same kernels in the same order on views of the
    stacked batch (a bf16 table's stochastic-rounding seeds from each
    step's own state.step), so the tables and dense parameters are
    bit-equal."""
    cfg, batches = _step_case(dev, "joint", 3, table_dtype)
    runs = {}
    for k in (1, 3):
        state = create_run_state(cfg, model_base.init_params(
            cfg.tower, seed=0, device=dev))
        _build.reset_launch_counts()
        if k == 1:
            step = make_train_step(cfg, "auto")
            for b in batches:
                state, _ = step(state, batch_to_torch(b, dev))
        else:
            state, auxes = make_multi_train_step(cfg, "auto")(
                state, batch_to_torch(stack_batches(batches), dev))
            assert auxes["loss"].shape == (3,)
        assert _build.launch_counts()["fused_gather_joint_lookup"] == 3
        runs[k] = state
    assert runs[3].step == runs[1].step == 3
    for tower, tp in runs[1].params.items():
        for key, v in tp.items():
            assert torch.equal(v, runs[3].params[tower][key]), (tower, key)


@pytest.mark.cuda
def test_dense_step_kernels_match_plain(dev):
    """3 dense-table sgd steps through the kernels and through the plain
    versions from one state: the bag forward twice a step (q and d), the
    tower with residuals once a side, the three loss kernels; no scatter
    (the optimizer updates the table). The plain table gradient is
    autograd's, the kernel path's the bag's d_table (an index_add_, with
    atomics): parameters to 2e-3 as the sparse steps' test, losses 1e-2."""
    cfg, batches = _step_case(dev, "dense", 3)
    batches = [batch_to_torch(b, dev, vocab_size=V) for b in batches]
    states = {impl: create_run_state(cfg, model_base.init_params(
        cfg.tower, seed=0, device=dev)) for impl in ("auto", "plain")}
    losses = {}
    for impl in states:
        step = _step(cfg, impl)
        _build.reset_launch_counts()
        losses[impl] = []
        for batch in batches:
            states[impl], aux = step(states[impl], batch)
            losses[impl].append(float(aux["loss"]))
        counts = _build.launch_counts()
        if impl == "auto":
            want = {"embedding_bag": 6, "dense_tower_residuals": 6,
                    "in_batch_loss": 3, "in_batch_loss_dq": 3,
                    "in_batch_loss_dd": 3}
            assert {k: v for k, v in counts.items() if v} == want, counts
    np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=0,
                               atol=1e-2)
    for tower, tp in states["plain"].params.items():
        for k, want in tp.items():
            torch.testing.assert_close(states["auto"].params[tower][k], want,
                                       rtol=0, atol=2e-3)
    assert states["auto"].step == 3


# ---- the multi-device path on one card -----------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_bodies_summed_bit_equal_to_unsharded(dev, dtype):
    """The shard-local bodies of kernels/sharded_embed.py at mp = 2, both
    shards in this process on the card: the gathers of each shard's owned
    groups summed by hand are the unsharded gather, bit for bit (each row
    comes from one shard, the other adds zeros); each shard's scatter-add,
    and on a bf16 table its stochastic-rounding scatter (seed * 2 + shard),
    is the unsharded kernel's on that shard's rows; the bag's shard
    partials sum to the unsharded bag (rtol 1e-5: a row's lookups are
    summed in two parts). Sentinel and out-of-range slots sit among real
    ones, and slots land on both shards."""
    from dssm_tpu_torch.kernels.sharded_embed import (
        embedding_bag_local, gather_compact_local, scatter_add_groups_local,
        scatter_sr_groups_local)

    mp, group = 2, 8 if dtype == torch.float32 else 16
    g = torch.Generator(device="cpu").manual_seed(0)
    table = torch.randn(V, H, generator=g).to(dtype).to(dev)
    n_groups = V // group
    gids = torch.randperm(n_groups, generator=g)[:SLOTS].to(torch.int32)
    gids[::7] = int(SKIP_SENTINEL_GID)
    gids[3] = n_groups
    gids = gids.to(dev)
    vals = (torch.randn(SLOTS * group, H, generator=g) * 1e-2).to(dev)
    rows = V // mp
    shards = [table[m * rows:(m + 1) * rows].clone() for m in range(mp)]
    whole = gather_row_groups(table, gids, group)
    summed = sum(gather_compact_local(s, gids, group, m)
                 for m, s in enumerate(shards))
    assert torch.equal(summed, whole)
    if dtype == torch.float32:
        want = scatter_add_row_groups(table.clone(), gids, vals, group)
        got = [scatter_add_groups_local(s.clone(), gids, vals, group, m)
               for m, s in enumerate(shards)]
        assert torch.equal(torch.cat(got), want)
        idx = torch.randint(0, V, (64, 16), generator=g,
                            dtype=torch.int32).to(dev)
        wgt = torch.rand(64, 16, generator=g).to(dev)
        parts = sum(embedding_bag_local(s, idx, wgt, m)
                    for m, s in enumerate(shards))
        torch.testing.assert_close(parts, embedding_bag(table, idx, wgt),
                                   rtol=1e-5, atol=1e-6)
    else:
        for m, s in enumerate(shards):
            want = scatter_sr_row_groups(table.clone(), gids, vals, group,
                                         5 * mp + m)
            got = scatter_sr_groups_local(s.clone(), gids, vals, group, 5, m,
                                          mp)
            assert torch.equal(got, want[m * rows:(m + 1) * rows])


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_one_shard_slot_space_steps_bit_equal(dev, table_dtype):
    """Three joint steps on batches re-slotted into one slot space
    (sel_local [1, cap]) and on the same batches before it, from one
    state: the kernels read the same rows in lookup order and the
    backward sums each row's lookups in the same order, so the tables and
    dense parameters are bit-equal."""
    from dssm_tpu_torch.data.loader import reslot_local

    cfg, batches = _step_case(dev, "joint", 3, table_dtype)
    runs = []
    for local in (False, True):
        state = create_run_state(cfg, model_base.init_params(
            cfg.tower, seed=0, device=dev))
        step = make_train_step(cfg, "auto")
        for b in batches:
            state, _ = step(state, batch_to_torch(
                reslot_local(b, 128) if local else b, dev))
        runs.append(state.params)
    for tower, tp in runs[0].items():
        for k, v in tp.items():
            assert torch.equal(v, runs[1][tower][k]), (tower, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["joint_local", "joint", "raw"])
def test_parallel_step_on_nccl_group_of_one_bit_equal(dev, kind):
    """The parallel step over a real NCCL group of one process (its data
    group's sums run on NCCL) against the single-device step from one
    state, on an f32 wire: bit-equal tables, dense parameters and losses on
    the joint branch with and without a slot space. A raw batch takes
    dssm_tpu's dispatch to the dense step, which differentiates the table
    through the bag (its d_table adds with atomics) and runs each side's
    tower alone where the single-device sparse step stacks them: held to
    rtol 1e-4 / atol 1e-6 under f32 compute, as chip_smoke.py holds the
    dense step to the sparse one (under bf16 compute the two tower calls
    round to bf16 apart)."""
    import socket

    from dssm_tpu_torch.data.loader import reslot_local
    from dssm_tpu_torch.parallel import dist as pdist
    from dssm_tpu_torch.parallel.mesh import make_mesh
    from dssm_tpu_torch.parallel.train_step import (
        create_sharded_state, make_parallel_train_step)

    cfg, batches = _step_case(dev, "raw" if kind == "raw" else "joint", 3)
    if kind == "raw":
        cfg = cfg.replace(tower=cfg.tower.replace(compute_dtype="float32"))
    if kind == "joint_local":
        batches = [reslot_local(b, 128) for b in batches]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pdist.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh(cfg.mesh, dev)
        assert mesh.groups["data"] is not None
        params = model_base.init_params(cfg.tower, seed=0, device=dev)
        a = create_run_state(cfg, {t: {k: v.clone() for k, v in tp.items()}
                                   for t, tp in params.items()})
        b = create_sharded_state(cfg, mesh, params)
        single = make_train_step(cfg, "auto")
        par = make_parallel_train_step(cfg, mesh, "auto")
        for batch in batches:
            a, aux_a = single(a, batch_to_torch(batch, dev, vocab_size=V))
            b, aux_b = par(b, batch_to_torch(batch, dev, vocab_size=V))
            if kind != "raw":
                assert float(aux_a["loss"]) == float(aux_b["loss"])
        for tower, tp in a.params.items():
            for k, v in tp.items():
                if kind == "raw":
                    torch.testing.assert_close(v, b.params[tower][k],
                                               rtol=1e-4, atol=1e-6)
                else:
                    assert torch.equal(v, b.params[tower][k]), (tower, k)
    finally:
        pdist.shutdown()


# ---- the compiled step (train/compiled.py) --------------------------------

def _compiled_case(dev, name, n):
    """(config, numpy batches) of a compiled-step case: _train_config's
    small configs, or _step_case's dense-table steps (with train.remat:
    each side's embed recomputed in the backward, which the capture
    records too)."""
    if name.startswith("dense"):
        cfg, batches = _step_case(dev, "dense_adam" if name == "dense_adam"
                                  else "dense", n)
        if name == "dense_remat":
            cfg = cfg.replace(train=cfg.train.replace(remat=True))
        return cfg, batches
    cfg, _, batches = _train_config(**COMPILED_CASES[name], n=n)
    return cfg, batches


# Each branch the compiled step captures, as _train_config's arguments
# (and the dense-table step with sgd and adam, _step_case's).
COMPILED_CASES = {
    "f32_joint": dict(), "bf16_joint": dict(table_dtype="bfloat16"),
    "int8_joint": dict(table_dtype="int8"), "per_side": dict(shared=False),
    "adagrad_adam": dict(optimizer="adam", table_optimizer="adagrad"),
    "cnn_dedupe": dict(arch="cnn"), "cnn_raw": dict(arch="cnn", dedup=False),
    "lstm_dedupe": dict(arch="lstm"),
    "lstm_raw": dict(arch="lstm", dedup=False),
    "dense_sgd": None, "dense_adam": None, "dense_remat": None}
# Branches whose table update ends in index_add_'s float atomics.
ATOMICS = ("cnn_raw", "lstm_raw", "dense_sgd", "dense_adam", "dense_remat")


def _fresh_state(cfg, init):
    return create_run_state(cfg, {t: {k: v.clone() for k, v in tp.items()}
                                  for t, tp in init.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COMPILED_CASES))
def test_compiled_step_matches_eager(dev, name):
    """Four calls of the compiled step (a capture, then replays; calls 2
    and 3 on one batch) against four eager steps from one state: each
    step's state bit-equal (the raw branch and the dense step, whose
    index_add_ adds with atomics: 2e-3, as the kernels-against-plain
    tests), the aux of every call intact after the later replays, the
    launches of every kernel equal and as the step's code makes them; on a
    bf16 or int8 table the two replays on one batch draw their own steps'
    stochastic-rounding streams (a stream baked into the graph would
    repeat the captured step's and part from the eager run)."""
    cfg, batches_np = _compiled_case(dev, name, 3)
    order = [0, 1, 1, 2]
    init = model_base.init_params(cfg.tower, seed=0, device=dev)
    runs = {}
    for kind, step in (("compiled", make_train_step(cfg)),
                       ("eager", make_eager_train_step(cfg))):
        state = _fresh_state(cfg, init)
        _build.reset_launch_counts()
        auxes, states = [], []
        for i in order:
            state, aux = step(state, batch_to_device(batches_np[i], dev,
                                                     vocab_size=V))
            auxes.append(aux)
            states.append([t.clone() for t in state_tensors(state)])
        torch.cuda.synchronize()
        runs[kind] = (_build.launch_counts(), auxes, states, state)
        if kind == "compiled":
            assert step.num_graphs == 1
    (c_counts, c_aux, c_states, c_state), (e_counts, e_aux, e_states, _) = (
        runs["compiled"], runs["eager"])
    assert c_counts == e_counts
    if not cfg.train.remat:  # remat runs each side's forward kernels twice
        assert {k: v for k, v in c_counts.items() if v} == {
            k: 4 * n for k, n in _launches_per_step(cfg).items()}
    assert int(c_state.step) == c_state.host_step == 4
    for i, (ca, ea, cs, es) in enumerate(zip(c_aux, e_aux, c_states,
                                             e_states)):
        for k in ea:
            if name in ATOMICS:
                assert abs(float(ca[k]) - float(ea[k])) <= 1e-2, (i, k)
            else:
                assert torch.equal(ca[k], ea[k]), (i, k)
        for c, e in zip(cs, es, strict=True):
            if name in ATOMICS:
                torch.testing.assert_close(c, e, rtol=0, atol=2e-3)
            else:
                assert torch.equal(c, e), i


@pytest.mark.cuda
def test_compiled_step_recaptures_per_signature_and_state(dev):
    """One compiled step: a new batch signature (another dedupe width)
    captures a second graph, another state a third; a replay on the first
    state and signature reuses the first graph; every call equals the
    eager step from the same states, and an earlier call's aux stays what
    it was through the later replays."""
    cfg, hashed, batches = _train_config(n=3)
    # The same model's batch at another dedupe width: other shapes.
    wider = next(batch_iterator(hashed, 128, seed=5, dedup_unique=2048,
                                dedup_unique_rows=256, dedup_joint=True,
                                wire_compress=True, sort_rows=True))
    init = model_base.init_params(cfg.tower, seed=0, device=dev)
    calls = [("a", batches[0]), ("a", batches[1]), ("a", wider),
             ("b", batches[0]), ("a", batches[2])]
    graphs_after = [1, 1, 2, 3, 3]
    results = {}
    for kind, step in (("compiled", make_train_step(cfg)),
                       ("eager", make_eager_train_step(cfg))):
        states = {s: _fresh_state(cfg, init) for s in "ab"}
        out = []
        for j, (s, b) in enumerate(calls):
            states[s], aux = step(states[s], batch_to_device(b, dev))
            out.append((aux, [t.clone() for t in state_tensors(states[s])]))
            if kind == "compiled":
                assert step.num_graphs == graphs_after[j], j
        results[kind] = out
    first_loss = results["compiled"][0][0]["loss"]
    for (ca, cs), (ea, es) in zip(results["compiled"], results["eager"]):
        assert torch.equal(ca["loss"], ea["loss"])
        assert all(torch.equal(c, e) for c, e in zip(cs, es, strict=True))
    assert torch.equal(first_loss, results["eager"][0][0]["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_compiled_k_steps_match_eager_k_steps(dev, table_dtype):
    """K = 3 bodies in one graph (make_multi_train_step), called twice, and
    the same six steps eagerly (3 a call): bit-equal states and stacked
    aux; the launches of one replay are 3 steps' (one K-step graph)."""
    cfg, batches = _step_case(dev, "joint", 6, table_dtype)
    init = model_base.init_params(cfg.tower, seed=0, device=dev)
    stacked = [stack_batches(batches[:3]), stack_batches(batches[3:])]
    runs = {}
    for kind, fn in (("compiled", make_multi_train_step(cfg)),
                     ("eager", make_eager_train_step(cfg, multi=True))):
        state = _fresh_state(cfg, init)
        auxes = []
        for j, sb in enumerate(stacked):
            _build.reset_launch_counts()
            state, aux = fn(state, batch_to_device(sb, dev))
            auxes.append(aux)
        torch.cuda.synchronize()
        assert _build.launch_counts()["joint_lookup_bwd"] == 3
        runs[kind] = (state, auxes)
    (cs, ca), (es, ea) = runs["compiled"], runs["eager"]
    assert int(cs.step) == cs.host_step == 6
    for a, b in zip(ca, ea):
        assert a["loss"].shape == (3,) and torch.equal(a["loss"], b["loss"])
    for c, e in zip(state_tensors(cs), state_tensors(es), strict=True):
        assert torch.equal(c, e)


# ---- the compiled parallel steps (parallel/, train/compiled.py) ------------

# Each branch the compiled parallel step captures over an NCCL group of one:
# (_step_case's kind, or "per_side" from _train_config; the collective
# wire; a slot space). "raw" is the sparse config's raw batch, which the
# parallel dispatch takes to the dense body, as "dense" and "dense_adam".
PARALLEL_CASES = {
    "joint_f32": ("joint", "float32", False),
    "joint_local_f32": ("joint", "float32", True),
    "joint_local_bf16_wire": ("joint", "bfloat16", True),
    "per_side": ("per_side", "float32", False),
    "raw": ("raw", "float32", False),
    "dense": ("dense", "float32", False),
    "dense_adam": ("dense_adam", "float32", False)}
# The branches whose table update ends in index_add_'s float atomics.
PARALLEL_ATOMICS = ("raw", "dense", "dense_adam")


def _parallel_case(dev, name, n):
    from dssm_tpu_torch.config import MeshConfig
    from dssm_tpu_torch.data.loader import reslot_local

    kind, wire, local = PARALLEL_CASES[name]
    if kind == "per_side":
        cfg, _, batches = _train_config(shared=False, n=n)
    else:
        cfg, batches = _step_case(dev, kind, n)
    if local:
        batches = [reslot_local(b, 128) for b in batches]
    return validate(cfg.replace(mesh=MeshConfig(
        model_parallel=1, collective_dtype=wire))), batches


def _world1_parallel_checks(name: str, init: str) -> None:
    """Run in a process of its own (test_compiled_parallel_step_on_nccl_
    group_of_one): join an NCCL group of one at `init` and hold the
    compiled parallel step of case `name` to the eager parallel body, and,
    on an f32 wire, to the single-device compiled step; on joint_f32 also
    K = 4 a call as one graph and one graph a batch signature. Raises on a
    failed check."""
    from dssm_tpu_torch.parallel import dist as pdist
    from dssm_tpu_torch.parallel.mesh import make_mesh
    from dssm_tpu_torch.parallel.train_step import (
        create_sharded_state, make_eager_parallel_train_step,
        make_parallel_multi_step, make_parallel_train_step)

    dev = pdist.initialize(init, 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        cfg, batches = _parallel_case(dev, name, 9)
        mesh = make_mesh(cfg.mesh, dev)
        assert mesh.groups["data"] is not None
        init_p = model_base.init_params(cfg.tower, seed=0, device=dev)
        order = [0, 1, 1, 2]
        runs = {}
        steps = {"compiled": make_parallel_train_step(cfg, mesh),
                 "eager": make_eager_parallel_train_step(cfg, mesh)}
        if cfg.mesh.collective_dtype == "float32":
            steps["single"] = make_train_step(cfg)
        for kind, step in steps.items():
            state = (_fresh_state(cfg, init_p) if kind == "single" else
                     create_sharded_state(cfg, mesh, {
                         t: {k: v.clone() for k, v in tp.items()}
                         for t, tp in init_p.items()}))
            where = [t.data_ptr() for t in state_tensors(state)]
            _build.reset_launch_counts()
            auxes, states = [], []
            for i in order:
                state, aux = step(state, batch_to_device(batches[i], dev,
                                                         vocab_size=V))
                auxes.append(aux)
                states.append([t.clone() for t in state_tensors(state)])
            torch.cuda.synchronize()
            assert [t.data_ptr() for t in state_tensors(state)] == where
            assert int(state.step) == state.host_step == len(order)
            runs[kind] = (_build.launch_counts(), auxes, states)
        assert steps["compiled"].num_graphs == 1
        (c_counts, c_aux, c_states) = runs["compiled"]
        exact = name not in PARALLEL_ATOMICS
        for kind in ("eager", "single") if exact else ("eager",):
            if kind not in runs:
                continue
            counts, auxes, states = runs[kind]
            if kind == "eager":
                # (the single-device joint step fuses its gather into the
                # lookup; the parallel one gathers first)
                assert counts == c_counts, (counts, c_counts)
            for i, (ca, a, cs, s) in enumerate(zip(c_aux, auxes, c_states,
                                                   states)):
                for k in a:
                    if exact:
                        assert torch.equal(ca[k], a[k]), (kind, i, k)
                    else:
                        assert abs(float(ca[k]) - float(a[k])) <= 1e-2
                for c, e in zip(cs, s, strict=True):
                    if exact:
                        assert torch.equal(c, e), (kind, i)
                    else:
                        torch.testing.assert_close(c, e, rtol=0, atol=2e-3)
        if name != "joint_f32":
            return
        # K = 4 a call: one graph of 4 bodies, bit-equal to 4 compiled
        # single steps, launching 4 steps' kernels a replay.
        from dssm_tpu_torch.train.loop import stack_batches

        multi = make_parallel_multi_step(cfg, mesh)
        ends = []
        for fn, units in (
                (steps["compiled"], [batch_to_device(b, dev)
                                     for b in batches[:8]]),
                (multi, [batch_to_device(stack_batches(batches[i:i + 4]),
                                         dev) for i in (0, 4)])):
            state = create_sharded_state(cfg, mesh, {
                t: {k: v.clone() for k, v in tp.items()}
                for t, tp in init_p.items()})
            for u in units:
                _build.reset_launch_counts()
                state, aux = fn(state, u)
            ends.append(state)
        # The second block is a replay: its launches are the graph's.
        assert multi.num_graphs == 1 and aux["loss"].shape == (4,)
        assert _build.launch_counts()["joint_lookup_bwd"] == 4
        assert int(ends[1].step) == ends[1].host_step == 8
        assert all(torch.equal(a, b) for a, b in zip(
            state_tensors(ends[0]), state_tensors(ends[1]), strict=True))
        # One graph a batch signature: a wider dedupe captures a second,
        # the first signature replays its own.
        wider = next(batch_iterator(
            hash_pairs(make_toy_pairs(640, 96, 7), cfg.tower, cfg.data),
            128, seed=5, dedup_unique=2048, dedup_unique_rows=256,
            dedup_joint=True, wire_compress=True, sort_rows=True))
        step = steps["compiled"]
        state = ends[0]  # a state the step has a graph of already
        before = step.num_graphs
        for b in (wider, batches[8], wider):
            state, _ = step(state, batch_to_device(b, dev))
            assert step.num_graphs == before + 1
    finally:
        pdist.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PARALLEL_CASES))
def test_compiled_parallel_step_on_nccl_group_of_one(dev, name, tmp_path):
    """The compiled parallel step over a real NCCL group of one process
    (its collectives captured into the graph), in a process of its own
    (a file:// rendezvous): four calls (a capture, then replays; calls 2
    and 3 on one batch) against the eager parallel body from one state,
    each state bit-equal (the dense body's index_add_ atomics: 2e-3), the
    aux and the launches equal, the state's tensors where they were; on
    an f32 wire also bit-equal to the single-device compiled step; on the
    f32 joint branch K = 4 a call as one graph, bit-equal to four calls,
    and one graph a batch signature (_world1_parallel_checks)."""
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {tests!r}); "
            "import test_torch_cuda as t; "
            f"t._world1_parallel_checks({name!r}, "
            f"{'file://' + str(tmp_path / 'init')!r})")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(tests))
    env.pop("TORCH_NCCL_BLOCKING_WAIT", None)
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-6000:]


# ---- eval's and serving's compiled forward (train/compiled.py) -------------

# (arch, shared, table dtype, dedup) of each eval the compiled forward runs.
COMPILED_EVAL_CASES = {
    "f32": ("mlp", True, "float32", True),
    "bf16": ("mlp", True, "bfloat16", True),
    "int8": ("mlp", True, "int8", True),
    "per_side": ("mlp", False, "float32", True),
    "cnn_dedupe": ("cnn", True, "float32", True),
    "cnn_raw": ("cnn", True, "float32", False),
    "lstm_dedupe": ("lstm", True, "float32", True),
    "lstm_raw": ("lstm", True, "float32", False)}


def _drop_forward_graphs():
    """Start from no eval or serving graph (a graph an earlier test left
    at addresses this test's tensors take would replay, rightly, but
    change the counts below)."""
    from dssm_tpu_torch.serve import retrieval as serve
    from dssm_tpu_torch.train import eval as eval_mod

    for fwd in (eval_mod.EMBED, eval_mod.EMBED_STACKED, eval_mod.RANK,
                serve.TOPK):
        fwd.clear()


def _eval_case(dev, name):
    arch, shared, table_dtype, dedup = COMPILED_EVAL_CASES[name]
    cfg, hashed, _ = _train_config(arch, shared, table_dtype, dedup=dedup,
                                   n=0)
    params = model_base.init_params(cfg.tower, seed=0, device=dev)
    return cfg, hashed, params


def _eval_pass_launches(cfg, bodies):
    """{kernel: launches} of an eval pass of `bodies` batch bodies, as the
    towers' code makes them: per body and side the gather and the count
    lookup (dedupe) or the bag (raw), and the mlp's tower; the rank once."""
    per_side = ({"gather_row_groups": 1, "count_lookup": 1}
                if cfg.data.dedup_lookup else {"embedding_bag": 1})
    if cfg.tower.arch == "mlp":
        per_side["dense_tower"] = 1
    return {"rank_counts": 1, **{k: 2 * bodies * n
                                  for k, n in per_side.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COMPILED_EVAL_CASES))
def test_compiled_eval_matches_eager(dev, name, monkeypatch):
    """640 pairs in batches of 128, two a block: three blocks, the last
    padded with its one batch. The compiled pass (one replay a block, the
    rank graph) against the eager one from the same parameters, first pass
    and cached: embeddings and ranks bit-equal, metrics equal, every
    kernel's launches equal and as the towers' code makes them; one graph
    serves every block; the rank graph reads the embeddings in place, so
    it replays on the same tensors and evaluate's passes share one."""
    from dssm_tpu_torch.train import eval as eval_mod

    monkeypatch.setattr(eval_mod, "_k_block", lambda n, b: 2)
    cfg, hashed, params = _eval_case(dev, name)
    eval_mod._EVAL_CACHES.clear()
    _drop_forward_graphs()
    out = {}
    for kind in ("compiled", "eager", "compiled"):
        eager = kind == "eager"
        _build.reset_launch_counts()
        q, d = eval_mod.embed_corpus(params, cfg, hashed, 128, cache=True,
                                     eager=eager)
        ranks = eval_mod.compute_ranks(q, d, eager=eager)
        torch.cuda.synchronize()
        out.setdefault(kind, []).append(
            (q.clone(), d.clone(), ranks, _build.launch_counts()))
        if not eager:
            replays = eval_mod.RANK.replays
            assert np.array_equal(eval_mod.compute_ranks(q, d), ranks)
            assert eval_mod.RANK.replays == replays + 1
    before = eval_mod.RANK.captures, eval_mod.RANK.replays
    metrics = [evaluate(params, cfg, hashed, 128, eager=e)
               for e in (False, True, False)]
    # evaluate's buffer: captured once, unless it took the address of an
    # embed_corpus result above, whose graph it then replays
    moved = (eval_mod.RANK.captures - before[0],
             eval_mod.RANK.replays - before[1])
    assert moved in ((1, 1), (0, 2)), moved
    assert eval_mod.RANK.buffer_bytes == 0  # nothing copied
    (cq, cd, cr, cc), (cq2, cd2, cr2, cc2) = out["compiled"]
    (eq, ed, er, ec), = out["eager"]
    assert eval_mod.EMBED_STACKED.num_graphs == 1
    assert torch.equal(cq, eq) and torch.equal(cd, ed)
    assert torch.equal(cq2, eq) and torch.equal(cd2, ed)
    assert np.array_equal(cr, er) and np.array_equal(cr2, er)
    assert metrics[0] == metrics[1] == metrics[2]
    want = _eval_pass_launches(cfg, 6)
    for counts in (cc, cc2, ec):
        assert {k: n for k, n in counts.items() if n} == want
    eval_mod._EVAL_CACHES.clear()


@pytest.mark.cuda
def test_compiled_eval_one_graph_across_inplace_steps(dev):
    """Evaluations between compiled train steps, which update the
    parameters in place, replay one forward graph and one rank graph;
    each pass equals the eager pass at that state. New parameter tensors
    capture once more."""
    from dssm_tpu_torch.train import eval as eval_mod

    cfg, hashed, batches = _train_config(n=3)
    state = create_run_state(cfg, model_base.init_params(cfg.tower, seed=0,
                                                         device=dev))
    step = make_train_step(cfg)
    eval_mod._EVAL_CACHES.clear()
    _drop_forward_graphs()
    seen = []
    for b in batches:
        got = evaluate(state.params, cfg, hashed, 128)
        assert got == evaluate(state.params, cfg, hashed, 128, eager=True)
        seen.append(got)
        state, _ = step(state, batch_to_device(b, dev, vocab_size=V))
    assert eval_mod.EMBED_STACKED.num_graphs == eval_mod.RANK.num_graphs == 1
    assert seen[0] != seen[-1]  # the steps moved the model
    copy = {t: {k: v.clone() for k, v in tp.items()}
            for t, tp in state.params.items()}
    assert evaluate(copy, cfg, hashed, 128) == evaluate(state.params, cfg,
                                                        hashed, 128)
    assert eval_mod.EMBED_STACKED.num_graphs == 2
    eval_mod._EVAL_CACHES.clear()


@pytest.mark.cuda
def test_compiled_eval_graph_cache_lru_bound(dev):
    """33 input shapes through one CompiledForward: 32 graphs kept, the
    least recently used dropped (a call on it captures again); each
    replay counts the launches its capture recorded."""
    from dssm_tpu_torch.train.compiled import (
        GRAPH_CACHE_SIZE, CompiledForward)

    fwd = CompiledForward(lambda p, q, d: rank_counts(q, d))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((8 + i, 16)).astype(
        np.float32)).to(dev) for i in range(GRAPH_CACHE_SIZE + 1)]
    for x in xs:
        fwd({}, x, x, device=dev)
    assert fwd.num_graphs == GRAPH_CACHE_SIZE
    _build.reset_launch_counts()
    for x in xs[1:]:
        assert torch.equal(fwd({}, x, x, device=dev), rank_counts(x, x))
    assert fwd.num_graphs == GRAPH_CACHE_SIZE  # every one replayed
    assert _build.launch_counts()["rank_counts"] == 2 * GRAPH_CACHE_SIZE
    fwd({}, xs[0], xs[0], device=dev)  # captured again, xs[1]'s dropped
    assert fwd.num_graphs == GRAPH_CACHE_SIZE
    assert fwd._lookup(compiled_key(xs[1])) is None


@pytest.mark.cuda
def test_compiled_forward_captures_again_after_clear(dev):
    """clear() drops every graph and starts a new pool, so a capture after
    it works even while a tensor made in the first capture lives on (as a
    workspace a library caches for the capture stream does), which keeps
    the old pool from being released."""
    from dssm_tpu_torch.train.compiled import CompiledForward

    kept = []

    def fn(p, x):
        kept.append(x * 2)  # the warm run's, then the capture's
        return x @ p["w"]

    fwd = CompiledForward(fn)
    w = torch.randn(64, 64, device=dev)
    x = torch.randn(32, 64, device=dev)
    want = x @ w
    for _ in range(2):
        fwd.clear()
        assert torch.equal(fwd({"w": w}, x), want)  # captures
        assert torch.equal(fwd({"w": w}, x), want)  # replays
        assert fwd.captures == fwd.replays
    assert len(kept) == 4


def compiled_key(x):
    from dssm_tpu_torch.train.compiled import forward_key

    return forward_key({}, (x, x), {}, x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_compiled_serve_matches_eager(dev, arch):
    """The doc index and the query embeddings, a replay a batch, against
    the eager forward: bit-equal, launches equal; top_k's one graph of
    every chunk and the ragged tail against the eager chunks, exact and
    approximate: ids equal, scores bit-equal, a second call a replay."""
    from dssm_tpu_torch.serve import retrieval as serve

    cfg, hashed, _ = _train_config(arch, n=0)
    params = model_base.init_params(cfg.tower, seed=0, device=dev)
    _drop_forward_graphs()
    texts = make_toy_pairs(300, 96, 9)
    titles, queries = list(texts.titles), list(texts.queries)[:200]
    runs = {}
    for eager in (False, True, False):
        _build.reset_launch_counts()
        d_emb = build_doc_index(params, cfg, titles, 128, eager=eager)
        q_emb = serve.embed_queries(params, cfg, queries, 128, eager=eager)
        torch.cuda.synchronize()
        runs.setdefault(eager, []).append((d_emb, q_emb,
                                           _build.launch_counts()))
    (d0, q0, c0), (d2, q2, c2) = runs[False]
    (de, qe, ce), = runs[True]
    assert np.array_equal(d0, de) and np.array_equal(q0, qe)
    assert np.array_equal(d2, de) and np.array_equal(q2, qe)
    assert c0 == ce == c2 and serve.EMBED.num_graphs == 2  # d and q
    for exact in (True, False):
        graphs = serve.TOPK.num_graphs
        want = serve.top_k(q0, d0, k=10, chunk=64, exact=exact, eager=True)
        for _ in range(2):
            got = serve.top_k(q0, d0, k=10, chunk=64, exact=exact)
            assert np.array_equal(got[1], want[1])
            assert np.array_equal(got[0], want[0])
        assert serve.TOPK.num_graphs == graphs + 1


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
def test_compiled_serve_top_k_pool_near_one_block(dev, exact):
    """16 chunks of 1024 queries against 16,384 docs: the graph's pool
    holds about one chunk's [1024, 16384] f32 score block (64 MiB), as the
    capture reuses the block freed by chunk i for chunk i + 1; at most
    three blocks (the approximate route pads a copy) and 48 MiB (cuBLAS's
    workspace, where the capture makes it), where 16 blocks would be kept
    if nothing were reused."""
    from dssm_tpu_torch.serve import retrieval as serve
    from dssm_tpu_torch.train.compiled import CompiledForward

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((16 * 1024, 32)).astype(
        np.float32)).to(dev)
    d = torch.from_numpy(rng.standard_normal((16384, 32)).astype(
        np.float32)).to(dev)
    fwd = CompiledForward(serve._top_k_all)
    s, i = fwd({}, q, d, device=dev, k=10, chunk=1024, exact=exact)
    block = 1024 * 16384 * 4
    assert 0 < fwd.pool_bytes <= 3 * block + (48 << 20), fwd.pool_bytes
    s2, i2 = fwd({}, q, d, device=dev, k=10, chunk=1024, exact=exact)
    assert torch.equal(s, s2) and torch.equal(i, i2)


@pytest.mark.cuda
def test_compiled_serve_index_in_place_or_one_copy(dev):
    """top_k reads an index on the card where it lies (no static copy; a
    change to it in place shows at the next replay) and copies a numpy
    index into one static buffer, shared by the graphs of every query
    count."""
    from dssm_tpu_torch.serve import retrieval as serve

    _drop_forward_graphs()
    rng = np.random.default_rng(2)
    d = rng.standard_normal((500, 32)).astype(np.float32)
    q = rng.standard_normal((300, 32)).astype(np.float32)
    d_dev = torch.from_numpy(d).to(dev)
    first = serve.top_k(q, d_dev, k=5, chunk=128)
    assert serve.TOPK.buffer_bytes == q.nbytes  # only the host queries
    d_dev.neg_()
    replays = serve.TOPK.replays
    got = serve.top_k(q, d_dev, k=5, chunk=128)
    assert serve.TOPK.replays == replays + 1
    want = serve.top_k(q, d_dev, k=5, chunk=128, eager=True)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])
    assert not np.array_equal(got[1], first[1])
    _drop_forward_graphs()
    for n in (300, 200, 100):
        serve.top_k(q[:n], d, k=5, chunk=128)
    assert serve.TOPK.num_graphs == 3
    assert serve.TOPK.buffer_bytes == (500 + 300 + 200 + 100) * 32 * 4
    _drop_forward_graphs()
    assert serve.TOPK.buffer_bytes == 0


@pytest.mark.cuda
def test_compiled_step_capture_failure_raises(dev):
    """A body that reads a value back cannot be captured: the call raises
    (after the warm-up, a real step, which moved the state), caches no
    graph and does not give way to the eager body. Last in the file: a
    failed capture is the one thing here that leaves CUDA's error
    state to the next call."""
    def body(state, batch):
        scale = float(batch["x"].sum())  # a read-back: refused in capture
        state.params["shared"]["w"].add_(batch["x"] * scale)
        state.step.add_(1)
        return {"loss": state.params["shared"]["w"].sum()}

    from dssm_tpu_torch.train.state import TrainState

    state = TrainState(step=0, params={"shared": {"w": torch.zeros(
        4, device=dev)}}, opt_state={})
    step = CompiledStep(body)
    with pytest.raises(RuntimeError):
        step(state, {"x": torch.ones(4, device=dev)})
    assert step.num_graphs == 0
    torch.cuda.synchronize()
    assert int(state.step) == state.host_step == 1
    assert torch.equal(state.params["shared"]["w"].cpu(),
                       torch.full((4,), 4.0))
