"""The raw-index embedding bag of dssm_tpu_torch against dssm_tpu on the CPU:
embedding_bag_plain against embedding_bag_xla and embedding_bag_pallas (in
interpret mode), its weight and table gradients against the Pallas custom
VJP's, the table update of the raw-index step against dssm_tpu's
scatter_table_update, and the wrappers' refusals.

Tolerances: rtol 1e-5 of the largest value (f32 sums in another order);
on a bf16 table 2e-2 relative (dssm_tpu's XLA bag sums bf16 rows in bf16,
the port in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.kernels import sparse_embed as jembed
from dssm_tpu.kernels.pallas_count import count_lookup_pallas
from dssm_tpu.kernels.pallas_embed import embedding_bag_pallas
from dssm_tpu.train.sparse_update import scatter_table_update as j_scatter
from dssm_tpu_torch.kernels import embed as tembed
from dssm_tpu_torch.kernels.count import count_lookup_plain
from dssm_tpu_torch.kernels import sparse_embed as tsparse_embed
from dssm_tpu_torch.train.sparse_update import scatter_table_update

V, H = 4096, 128


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, shape, dead_junk=False):
    """A table and ragged lookups: trailing entries of a row are padding
    (index 0, weight 0), or junk indices outside the table with weight 0."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, H)).astype(np.float32)
    k = shape[-1]
    idx = rng.integers(1, V, size=shape).astype(np.int32)
    wgt = rng.integers(1, 4, size=shape).astype(np.float32)
    nnz = rng.integers(0, k + 1, size=shape[:-1])
    dead = np.arange(k) >= nnz[..., None]
    wgt[dead] = 0.0
    idx[dead] = V + 11 if dead_junk else 0
    return table, idx, wgt


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(32, 16), (32, 4, 4), (8, 3, 24)])
def test_plain_bag_matches_xla_and_pallas(shape):
    table, idx, wgt = _inputs(1, shape)
    want_xla = jembed.embedding_bag_xla(jnp.asarray(table), jnp.asarray(idx),
                                        jnp.asarray(wgt))
    want_pl = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(idx),
                                   jnp.asarray(wgt), interpret=True)
    got = tembed.embedding_bag_plain(torch.from_numpy(table),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(wgt))
    assert got.dtype == torch.float32 and got.shape == (*shape[:-1], H)
    _close(got.numpy(), want_xla)
    _close(got.numpy(), want_pl)
    # The interface takes the same path on CPU tensors.
    out = tsparse_embed.embedding_bag(torch.from_numpy(table),
                                      torch.from_numpy(idx),
                                      torch.from_numpy(wgt))
    np.testing.assert_array_equal(out.numpy(), got.numpy())


@pytest.mark.parametrize("shape,dead_junk", [((32, 16), False),
                                             ((64, 40), True)])
def test_bag_is_the_count_lookup_over_the_table(shape, dead_junk):
    """The bag is the count lookup with compact2 = the whole table (the two
    CUDA kernels share one body): the bag's plain version against dssm_tpu's
    count lookup kernel (interpret mode) and the port's plain count lookup
    on the same inputs, dead lookups outside the table included."""
    table, idx, wgt = _inputs(7, shape, dead_junk=dead_junk)
    want = count_lookup_pallas(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(wgt), interpret=True)
    got = tembed.embedding_bag_plain(torch.from_numpy(table),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(wgt))
    _close(got.numpy(), want)
    _close(got.numpy(), count_lookup_plain(torch.from_numpy(table),
                                           torch.from_numpy(idx),
                                           torch.from_numpy(wgt)).numpy())


def test_plain_bag_on_a_bf16_table():
    table, idx, wgt = _inputs(2, (32, 4, 4))
    t16 = jnp.asarray(table).astype(jnp.bfloat16)
    want = np.asarray(jembed.embedding_bag_xla(t16, jnp.asarray(idx),
                                               jnp.asarray(wgt)), np.float32)
    tt16 = torch.from_numpy(table).to(torch.bfloat16)
    got = tembed.embedding_bag_plain(tt16, torch.from_numpy(idx),
                                     torch.from_numpy(wgt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
    out = tsparse_embed.embedding_bag(tt16, torch.from_numpy(idx),
                                      torch.from_numpy(wgt))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(32, 16), (16, 4, 4)])
def test_gradients_match_the_pallas_vjp(shape):
    """d_table (segment sum) and d_wgt, through autograd of the wrapper,
    against jax.vjp of embedding_bag_pallas (interpret mode); the plain
    d_wgt and segment-sum functions alone too."""
    table, idx, wgt = _inputs(3, shape)
    g = np.random.default_rng(4).normal(size=(*shape[:-1], H)).astype(
        np.float32)
    _, vjp = jax.vjp(
        lambda t, w: embedding_bag_pallas(t, jnp.asarray(idx), w,
                                          interpret=True),
        jnp.asarray(table), jnp.asarray(wgt))
    jd_table, jd_wgt = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(wgt).requires_grad_(True)
    out = tembed.embedding_bag(tt, torch.from_numpy(idx), tw)
    out.backward(torch.from_numpy(g))
    _close(tt.grad.numpy(), jd_table)
    _close(tw.grad.numpy(), jd_wgt)
    _close(tembed.embedding_bag_dwgt_plain(
        torch.from_numpy(table), torch.from_numpy(idx),
        torch.from_numpy(g)).numpy(), jd_wgt)
    want_seg = jembed.embedding_bag_grad_reference(
        jnp.asarray(g).reshape(-1, H), jnp.asarray(idx).reshape(-1, shape[-1]),
        jnp.asarray(wgt).reshape(-1, shape[-1]), V)
    got_seg = tembed.embedding_bag_grad_plain(
        torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(wgt), V)
    _close(got_seg.numpy(), want_seg)
    # The kernel wrapper's weight gradient takes the plain version here.
    np.testing.assert_array_equal(
        tembed.embedding_bag_dwgt(torch.from_numpy(table),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(g)).numpy(),
        tembed.embedding_bag_dwgt_plain(torch.from_numpy(table),
                                        torch.from_numpy(idx),
                                        torch.from_numpy(g)).numpy())


def test_dead_lookups_and_rows_outside_the_table():
    """Weight-0 lookups may carry any index and read nothing; a live lookup
    outside the table raises rather than clamps."""
    table, idx, wgt = _inputs(5, (16, 12), dead_junk=True)
    assert (idx >= V).any()
    live = np.where(wgt != 0, idx, 0)
    want = tembed.embedding_bag_plain(torch.from_numpy(table),
                                      torch.from_numpy(live),
                                      torch.from_numpy(wgt))
    got = tembed.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                               torch.from_numpy(wgt))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    g = torch.ones((16, H))
    dw = tembed.embedding_bag_dwgt_plain(torch.from_numpy(table),
                                         torch.from_numpy(idx), g)
    assert (dw.numpy()[idx >= V] == 0).all()
    bad = wgt.copy()
    bad[idx >= V] = 1.0
    for impl in ("auto", "plain"):
        with pytest.raises(IndexError, match="outside the table"):
            tembed.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(idx),
                                 torch.from_numpy(bad), impl=impl)
    neg = idx.copy()
    neg[0, 0], wgt[0, 0] = -3, 1.0
    with pytest.raises(IndexError, match="row -3"):
        tembed.embedding_bag(torch.from_numpy(table), torch.from_numpy(neg),
                             torch.from_numpy(wgt))


def test_wrappers_refuse_the_kernel_on_cpu_tensors():
    table, idx, wgt = _inputs(6, (4, 8))
    args = (torch.from_numpy(table), torch.from_numpy(idx))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tembed.embedding_bag(*args, torch.from_numpy(wgt), impl="kernel")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tembed.embedding_bag_dwgt(*args, torch.zeros((4, H)), impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        tembed.embedding_bag(*args, torch.from_numpy(wgt), impl="xla")


@pytest.mark.parametrize("shape,lr", [((32, 16), 0.1), ((16, 4, 4), 0.05)])
def test_scatter_table_update_matches_dssm_tpu(shape, lr):
    """The raw-index step's table update: duplicates add, padding adds zero
    into row 0, in place."""
    table, idx, wgt = _inputs(7, shape)
    idx[0, ..., :2] = idx[1, ..., :1]  # the same row twice, across rows
    g = np.random.default_rng(8).normal(size=(*shape[:-1], H)).astype(
        np.float32)
    want = j_scatter(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(wgt),
                     jnp.asarray(g), lr)
    tt = torch.from_numpy(table.copy())
    out = scatter_table_update(tt, torch.from_numpy(idx),
                               torch.from_numpy(wgt), torch.from_numpy(g), lr)
    assert out is tt
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    untouched = np.ones((V,), bool)
    untouched[idx[wgt != 0]] = False
    np.testing.assert_array_equal(out.numpy()[untouched], table[untouched])
