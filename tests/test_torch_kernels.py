"""Each kernel module of dssm_tpu_torch against dssm_tpu's Pallas kernel in
interpret mode: the plain PyTorch versions on the CPU (the CUDA kernels are
held to those plain versions on a GPU by tests/test_torch_cuda.py).

Tolerances: the gather is a copy (exact); the count lookup and the tower
only sum in another order (f32: rtol 1e-5; bf16 tower: 2e-2, one bf16
rounding of an intermediate apart).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dssm_tpu.kernels import dedup_embed as jdedup
from dssm_tpu.kernels.pallas_count import count_lookup_pallas
from dssm_tpu.kernels.pallas_gather import force_interpret, gather_row_groups
from dssm_tpu.kernels.pallas_tower import dense_tower_pallas
from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID, dedupe_two_level_joint
from dssm_tpu_torch.kernels import _build
from dssm_tpu_torch.kernels import dedup_embed as tdedup
from dssm_tpu_torch.kernels.count import count_lookup, count_lookup_plain
from dssm_tpu_torch.kernels.gather import (
    gather_row_groups as t_gather, gather_row_groups_plain)
from dssm_tpu_torch.kernels.tower import dense_tower, dense_tower_plain

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


def _kernel_calls(dev):
    table = torch.zeros((V, H), device=dev)
    gids = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    c2 = torch.zeros((128, H), device=dev)
    inv = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    wgt = torch.ones((64, 8), device=dev)
    x = torch.zeros((64, 40), device=dev)
    layers = [(torch.zeros((40, 32), device=dev), torch.zeros(32, device=dev))]
    return {
        "gather_row_groups": lambda impl: t_gather(table, gids, GROUP,
                                                   impl=impl),
        "count_lookup": lambda impl: count_lookup(c2, inv, wgt, impl=impl),
        "dense_tower": lambda impl: dense_tower(x, layers, impl=impl),
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
