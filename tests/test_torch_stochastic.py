"""Stochastic rounding of dssm_tpu_torch against dssm_tpu on the CPU, the
Philox stream, and the two stochastic-rounding scatters' plain versions.

The rounding functions take the random bits as an argument, so the same
numpy uint32 bits go through both packages and the results are compared
bit for bit. One stated divergence: the port's int8 rounding adds u to the
fraction alone, dssm_tpu adds it to the whole value in one f32 add, which can
round across an integer; where the two differ the port must equal the exact
floor(x + u) computed in float64.

The scatters draw their bits from the port's own Philox stream, which is
neither dssm_tpu's threefry nor the TPU's PRNG: against dssm_tpu they are
equal on updates that round exactly, and otherwise each element is one of the
two grid neighbours of the f32 accumulator with the mean over seeds within
3 sigma of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dssm_tpu.kernels import pallas_gather as jgather
from dssm_tpu.kernels import stochastic as jst
from dssm_tpu_torch.data.dedupe import SKIP_SENTINEL_GID
from dssm_tpu_torch.kernels import scatter_sr as tsr
from dssm_tpu_torch.kernels import stochastic as tst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are far too small to gain from intra-op threads, and the
    suite runs several worker processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t_bits(bits):
    return torch.from_numpy(bits.astype(np.int64))


def _bf16_np(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def _jbf16_np(a):
    return np.asarray(a).view(np.uint16)


def _values(rng, n):
    """f32 values across exponent boundaries, both signs, exact bf16 values,
    zeros, tiny and large magnitudes."""
    x = np.concatenate([
        rng.normal(size=n).astype(np.float32),
        (rng.normal(size=n) * 1e-6).astype(np.float32),
        (rng.normal(size=n) * 1e6).astype(np.float32),
        # just below a power of two: a carry crosses the exponent boundary
        np.float32(2.0) ** rng.integers(-20, 20, size=n).astype(np.float32)
        * np.float32(1 - 2.0 ** -12) * rng.choice([-1, 1], size=n).astype(
            np.float32),
        # exactly representable in bf16
        (rng.integers(-128, 128, size=n) / 64.0).astype(np.float32),
        np.zeros(8, np.float32), -np.zeros(8, np.float32),
    ])
    return x


def test_stochastic_round_bf16_bit_equal():
    rng = np.random.default_rng(1)
    x = _values(rng, 2000)
    for bits in (_bits(rng, x.shape), np.zeros(x.shape, np.uint32),
                 np.full(x.shape, 0xFFFFFFFF, np.uint32)):
        want = _jbf16_np(jst.stochastic_round_bf16(jnp.asarray(x),
                                                   jnp.asarray(bits)))
        got = tst.stochastic_round_bf16(torch.from_numpy(x), _t_bits(bits))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_np(got), want)
    # int32 bit patterns are taken as the uint32 they hold
    bits = _bits(rng, x.shape)
    a = tst.stochastic_round_bf16(torch.from_numpy(x), _t_bits(bits))
    b = tst.stochastic_round_bf16(torch.from_numpy(x),
                                  torch.from_numpy(bits.view(np.int32)))
    assert torch.equal(a, b)
    # a representable value comes back unchanged whatever the bits
    exact = torch.from_numpy(x).to(torch.bfloat16)
    again = tst.stochastic_round_bf16(
        exact.float(), _t_bits(np.full(x.shape, 0xFFFFFFFF, np.uint32)))
    assert torch.equal(_as_bits(again), _as_bits(exact))


def _as_bits(t):
    return t.view(torch.int16)


def test_stochastic_round_int8_bit_equal_and_exact_on_grid():
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.uniform(-140, 140, size=6000).astype(np.float32),   # clips
        rng.uniform(-2, 2, size=2000).astype(np.float32),
        rng.integers(-130, 131, size=2000).astype(np.float32),  # grid points
    ])
    bits = _bits(rng, x.shape)
    bits[-500:] = 0xFFFFFFFF  # u = 1 - 2^-24 on grid points
    want = np.asarray(jst.stochastic_round_int8(jnp.asarray(x),
                                                jnp.asarray(bits)))
    got = tst.stochastic_round_int8(torch.from_numpy(x), _t_bits(bits)).numpy()
    assert got.dtype == np.int8
    u = (bits >> 8).astype(np.float64) * 2.0 ** -24
    exact = np.clip(np.floor(x.astype(np.float64) + u), -127, 127)
    differ = got != want
    # Where they differ, dssm_tpu's single f32 add rounded across an integer
    # and the port holds the exact floor; elsewhere they are bit-equal.
    np.testing.assert_array_equal(got, exact.astype(np.int8))
    assert differ.sum() <= 500 and np.all(want[differ] == got[differ] + 1)
    assert differ[:8000].sum() == 0
    # the stated case: a grid point and the largest u
    one = tst.stochastic_round_int8(torch.tensor([100.0, -5.0, 127.0, -127.0]),
                                    torch.full((4,), 0xFFFFFFFF))
    assert one.tolist() == [100, -5, 127, -127]
    assert int(jst.stochastic_round_int8(
        jnp.asarray([100.0], jnp.float32),
        jnp.asarray([0xFFFFFFFF], jnp.uint32))[0]) == 101


def test_sr_add_rows_bit_equal_on_dssm_tpus_own_bits():
    """dssm_tpu's threefry bits for a seed, fetched as numpy and handed to
    the port, give dssm_tpu's rows bit for bit."""
    rng = np.random.default_rng(3)
    old = (rng.normal(size=(48, 128)) * 0.1).astype(np.float32)
    vals = (rng.normal(size=(48, 128)) * 1e-3).astype(np.float32)
    vals[:4] = 0.0
    jold = jnp.asarray(old).astype(jnp.bfloat16)
    seed = jnp.int32(11)
    bits = np.asarray(jst.sr_bits(seed, old.shape))
    want = jst.sr_add_rows(jold, jnp.asarray(vals), seed)
    told = torch.from_numpy(old).to(torch.bfloat16)
    got = tst.sr_add_rows(told, torch.from_numpy(vals), _t_bits(bits))
    np.testing.assert_array_equal(_bf16_np(got), _jbf16_np(want))
    assert torch.equal(_as_bits(got[:4]), _as_bits(told[:4]))  # zero update
    assert not torch.equal(got, told)


def test_sr_quant_rows_int8_bit_equal_on_dssm_tpus_own_bits():
    rng = np.random.default_rng(4)
    old = rng.integers(-127, 128, size=(64, 128)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, size=(64, 1)).astype(np.float32)
    scale[5] = 0.0
    old[5] = 0
    vals = (rng.normal(size=(64, 128)) * 3e-3).astype(np.float32)
    seed = jnp.int32(5)
    bits = np.asarray(jst.sr_bits(seed, old.shape))
    want = np.asarray(jst.sr_quant_rows_int8(
        jnp.asarray(old), jnp.asarray(scale), jnp.asarray(vals), seed))
    got = tst.sr_quant_rows_int8(torch.from_numpy(old), torch.from_numpy(scale),
                                 torch.from_numpy(vals), _t_bits(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[5].any()  # a scale-0 row stays exactly 0
    assert (got != old).any()


# ---- the Philox stream -----------------------------------------------------

def test_philox_known_answers():
    """Philox4x32-10 vectors of the Random123 distribution's known-answer
    file (counter, key -> output)."""
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
        ((0xffffffff,) * 4, (0xffffffff,) * 2,
         (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
        ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
         (0xa4093822, 0x299f31d0),
         (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
    ]
    for ctr, key, want in cases:
        got = tst.philox4x32(*[torch.tensor([c]) for c in ctr], *key)
        assert tuple(int(w) for w in got) == want
    assert [int(w) for w in tst.philox_bits(0, 4)] == list(cases[0][2])


def test_philox_bits_stream():
    a = tst.philox_bits(7, 1001)
    assert a.dtype == torch.int64 and a.shape == (1001,)
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 32
    assert torch.equal(a, tst.philox_bits(7, 1001))          # deterministic
    assert torch.equal(a[:64], tst.philox_bits(7, 64))       # a prefix
    b = tst.philox_bits(8, 1001)
    assert (a != b).float().mean() > 0.99                    # other seed
    assert len(torch.unique(a)) > 990                        # other counters
    # a negative seed is its uint32 bit pattern
    assert torch.equal(tst.philox_bits(-1, 8), tst.philox_bits(0xFFFFFFFF, 8))


def test_philox_bits_uniform():
    n = 1 << 18
    bits = tst.philox_bits(12345, n).numpy()
    u = (bits >> 8) * 2.0 ** -24
    low = (bits & 0xFFFF) / 65536.0
    for x in (u, low):
        # mean and variance of U[0, 1): sigma of the mean is 1/sqrt(12 n)
        assert abs(x.mean() - 0.5) < 4 / np.sqrt(12 * n)
        assert abs(x.var() - 1 / 12) < 4 * np.sqrt(1 / 180 / n)
        counts = np.bincount((x * 256).astype(np.int64), minlength=256)
        chi2 = ((counts - n / 256) ** 2 / (n / 256)).sum()
        # chi-square with 255 degrees of freedom: mean 255, sigma 22.6
        assert chi2 < 255 + 5 * 22.6, chi2
    # neighbouring words are uncorrelated
    assert abs(np.corrcoef(u[:-1], u[1:])[0, 1]) < 4 / np.sqrt(n)


# ---- the scatters' plain versions against dssm_tpu -------------------------

def _gids(rng, num_groups, slots, real):
    g = np.full((slots,), SKIP_SENTINEL_GID, np.int32)
    g[:real] = np.sort(rng.choice(num_groups, real, replace=False))
    return g


def _xla_sr_scatter(table, gids, vals, group, seed):
    """dssm_tpu's XLA body of the bf16 update
    (train/sparse_update.py::apply_table_update)."""
    from dssm_tpu.kernels.dedup_embed import expand_group_rows

    rows = expand_group_rows(gids, group)
    old = jnp.take(table, rows, axis=0, mode="fill", fill_value=0)
    return table.at[rows].set(jst.sr_add_rows(old, vals, seed), mode="drop")


def _xla_sr_int8_scatter(table, gids, vals, sc, group, seed):
    from dssm_tpu.kernels.dedup_embed import expand_group_rows

    rows = expand_group_rows(gids, group)
    old = jnp.take(table, rows, axis=0, mode="fill", fill_value=0)
    return table.at[rows].set(jst.sr_quant_rows_int8(old, sc, vals, seed),
                              mode="drop")


def test_scatter_sr_bf16_plain_equals_dssm_tpu_on_exact_updates():
    """The reference's own check (tests/test_stochastic.py): its Pallas
    kernel in interpret mode where the interpreter has the TPU PRNG, and its
    XLA body, on updates whose sums are representable."""
    group, h = 16, 128
    v = 32 * group
    gids = np.asarray([1, 5, 9, 30, 2, 0, 31, 7], np.int32)
    vals = np.full((gids.shape[0] * group, h), 0.25, np.float32)
    table = torch.ones((v, h), dtype=torch.bfloat16)
    got = tsr.scatter_sr_row_groups(table, torch.from_numpy(gids),
                                    torch.from_numpy(vals), group, 0)
    assert got is table
    want = _xla_sr_scatter(jnp.ones((v, h), jnp.bfloat16), jnp.asarray(gids),
                           jnp.asarray(vals), group, jnp.int32(0))
    np.testing.assert_array_equal(_bf16_np(table), _jbf16_np(want))
    expected = np.ones((v, h), np.float32)
    for gid in gids:
        expected[gid * group:(gid + 1) * group] = 1.25
    np.testing.assert_array_equal(table.float().numpy(), expected)
    try:
        pallas = jgather.scatter_sr_row_groups(
            jnp.ones((v, h), jnp.bfloat16), jnp.asarray(gids),
            jnp.asarray(vals), group, jnp.int32(0), interpret=True,
            groups_per_step=8)
    except Exception:  # the interpreter lacks the TPU PRNG here
        pallas = None
    if pallas is not None:
        np.testing.assert_array_equal(_bf16_np(table), _jbf16_np(pallas))


def test_scatter_sr_int8_plain_equals_dssm_tpu_on_exact_updates():
    group, h = 32, 128
    v = 16 * group
    gids = np.asarray([1, 5, 9, 2, 0, 15, 7, SKIP_SENTINEL_GID], np.int32)
    vals_grid = np.full((gids.shape[0] * group, h), 2.0, np.float32)
    table = torch.full((v, h), 3, dtype=torch.int8)
    tsr.scatter_sr_int8_row_groups(table, torch.from_numpy(gids),
                                   torch.from_numpy(vals_grid), group, 0)
    sc = jnp.ones((gids.shape[0] * group, 1), jnp.float32)
    want = _xla_sr_int8_scatter(jnp.full((v, h), 3, jnp.int8),
                                jnp.asarray(gids), jnp.asarray(vals_grid), sc,
                                group, jnp.int32(0))
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    expected = np.full((v, h), 3, np.int8)
    for gid in gids[:-1]:
        expected[gid * group:(gid + 1) * group] = 5
    np.testing.assert_array_equal(table.numpy(), expected)
    try:
        pallas = jgather.scatter_sr_int8_row_groups(
            jnp.full((v, h), 3, jnp.int8), jnp.asarray(gids[:-1].tolist() + [11],
                                                       jnp.int32),
            jnp.asarray(vals_grid), group, jnp.int32(0), interpret=True,
            groups_per_step=8)
    except Exception:  # the interpreter lacks the TPU PRNG here
        pallas = None
    if pallas is not None:
        rest = np.ones((v,), bool)
        rest[11 * group:12 * group] = False
        np.testing.assert_array_equal(table.numpy()[rest],
                                      np.asarray(pallas)[rest])


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_scatter_sr_plain_general_updates(kind):
    """General updates: untouched rows and sentinel slots keep their bits,
    every updated element is a grid neighbour of dssm_tpu's f32 accumulator,
    a zero update changes nothing, and the mean over 200 seeds is within 3
    sigma of the accumulator."""
    rng = np.random.default_rng(6)
    h, slots, real = 128, 16, 9
    if kind == "bf16":
        group, dtype = 16, torch.bfloat16
        v = 64 * group
        table0 = torch.from_numpy(
            (rng.normal(size=(v, h)) * 0.1).astype(np.float32)).to(dtype)
        vals = (rng.normal(size=(slots * group, h)) * 2e-4).astype(np.float32)
        fn = tsr.scatter_sr_row_groups
    else:
        group, dtype = 32, torch.int8
        v = 32 * group
        table0 = torch.from_numpy(
            rng.integers(-100, 101, size=(v, h)).astype(np.int8))
        vals = rng.uniform(-0.9, 0.9, size=(slots * group, h)).astype(
            np.float32)
        fn = tsr.scatter_sr_int8_row_groups
    gids = _gids(rng, v // group, slots, real)
    gids[real] = -1  # a negative id is out of range too
    tg, tv = torch.from_numpy(gids), torch.from_numpy(vals)
    rows = (gids[:real, None].astype(np.int64) * group
            + np.arange(group)).reshape(-1)
    acc = table0.float().numpy()[rows] + vals[: real * group]  # f32, as both

    if kind == "bf16":  # the two grid neighbours of each accumulator
        down = torch.from_numpy(acc).view(torch.int32) & -65536
        lo = down.view(torch.float32).numpy()  # magnitude truncated
        up = (down + 65536).view(torch.float32).numpy()
    else:
        lo, up = np.floor(acc), np.floor(acc) + 1

    same = fn(table0.clone(), tg, torch.zeros_like(tv), group, 3)
    assert torch.equal(same.view(torch.int8), table0.view(torch.int8))

    total = np.zeros_like(acc, np.float64)
    seeds = 200
    for seed in range(seeds):
        out = fn(table0.clone(), tg, tv, group, seed)
        rest = np.ones((v,), bool)
        rest[rows] = False
        assert torch.equal(out[rest].view(torch.int8),
                           table0[rest].view(torch.int8))
        new = out.float().numpy()[rows]
        assert np.all((new == lo) | (new == up))
        total += new
    mean = total / seeds
    step = np.abs(up - lo)
    frac = np.clip(np.abs(acc - lo) / step, 0, 1)
    sigma = step * np.sqrt(np.maximum(frac * (1 - frac), 1e-12) / seeds)
    z = np.abs(mean - acc) / (sigma + 1e-12 * step)
    # Where the normal approximation holds (a fraction in [0.05, 0.95], so
    # at least 10 expected carries and 10 expected stays): within 3 sigma
    # but for the ~0.3% a normal variable leaves outside, none beyond 5.5.
    mid = (frac >= 0.05) & (frac <= 0.95)
    assert mid.mean() > 0.5
    assert (z[mid] > 3).mean() < 0.01 and z[mid].max() < 5.5
    exact = frac * (1 - frac) == 0
    assert np.all(mean[exact] == acc[exact])


def test_scatter_sr_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((64, 128), dtype=torch.bfloat16)
    gids = torch.zeros((1,), dtype=torch.int32)
    vals = torch.zeros((16, 128))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tsr.scatter_sr_row_groups(table, gids, vals, 16, 0, impl="kernel")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tsr.scatter_sr_int8_row_groups(table.to(torch.int8), gids,
                                       torch.zeros((32, 128)), 32, 0,
                                       impl="kernel")
    with pytest.raises(ValueError, match="not divisible"):
        tsr.scatter_sr_row_groups(table[:60], gids, vals, 16, 0)
    with pytest.raises(ValueError, match="unknown impl"):
        tsr.scatter_sr_row_groups(table, gids, vals, 16, 0, impl="fast")
