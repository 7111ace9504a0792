"""Stochastic rounding for low-precision embedding-table updates, and the
random stream the scatter kernels draw.

With a bfloat16 or int8 table a typical SGD step on a hot row is far below
half a grid step of the stored weight: round-to-nearest would erase it every
step. Stochastic rounding rounds to the two neighbouring grid values with
probability proportional to proximity, so E[round(x)] = x and the table
follows the f32 trajectory in expectation. Counterpart of
dssm_tpu/kernels/stochastic.py.

The rounding functions take the random bits as an ARGUMENT (an integer
tensor holding uint32 values; int64, or int32 bit patterns), so the same
bits can be fed to both packages: on the same bits they are bit-equal to
dssm_tpu's. torch has no uint32 arithmetic, so the bit tricks run on int64
holding values in [0, 2^32).

philox_bits is the written definition of the stream the CUDA scatter
kernels (csrc/scatter_sr.cu) generate in registers: Philox4x32-10 with

    key     = (seed as uint32, 0)          the train step's scatter seed
    counter = (e // 4 low 32 bits, e // 4 high 32 bits, 0, 0)
    word    = e % 4                        of the four output words

for the element with flat index e in the [G * group, H] compact block. It
takes the place of dssm_tpu's threefry sr_bits and of the TPU's in-kernel
PRNG; the three streams differ by design, so parity with dssm_tpu's updates
is statistical, while the kernel and its plain version here are bit-equal.
"""

from __future__ import annotations

from typing import Union

import torch

_MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b for a 32-bit constant a and int64 b
    in [0, 2^32), through 16-bit halves so nothing overflows int64."""
    lo_part = a * (b & 0xFFFF)          # < 2^48
    hi_part = a * (b >> 16)             # < 2^48
    low_sum = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (low_sum >> 32), low_sum & _MASK32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               c3: torch.Tensor, key0: Union[int, torch.Tensor],
               key1: int = 0):
    """Philox4x32-10 of the counters (c0, c1, c2, c3), int64 tensors in
    [0, 2^32), under key (key0, key1): four int64 tensors of uint32 values.
    key0 may be an int64 scalar tensor (a seed read on the device)."""
    k0, k1 = key0 & _MASK32, key1 & _MASK32
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & _MASK32, (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: Union[int, torch.Tensor], n: int,
                device="cpu") -> torch.Tensor:
    """The first n words of seed's stream: int64 [n] of uint32 values, word
    e being output word e % 4 of counter e // 4 (see the module docstring).
    seed: an int, or a one-element integer tensor on `device` (the train
    step's seed, computed on the device from its step counter)."""
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(blocks)
    key = (seed.reshape(()).to(torch.int64) if isinstance(seed, torch.Tensor)
           else int(seed))
    words = philox4x32(blocks & _MASK32, blocks >> 32, zero, zero, key)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def _u32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int64) & _MASK32


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Round f32 x to bf16 with uint32 random bits of x's shape: add the low
    16 random bits to the f32 bit pattern and truncate to the top 16. The
    low 16 bits of a normal f32 are the fraction of the way to the next
    bf16 of larger magnitude, so the carry happens with exactly that
    probability; a value already representable has zero low bits, cannot
    carry and comes back unchanged."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & _MASK32
    b = (b + (_u32(bits) & 0xFFFF)) & 0xFFFF0000
    b = torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32)
    return b.view(torch.float32).to(torch.bfloat16)  # exact: low bits are 0


def stochastic_round_int8(x_over_scale: torch.Tensor,
                          bits: torch.Tensor) -> torch.Tensor:
    """Round grid-relative f32 values to int8 stochastically: floor(x + u),
    u = (bits >> 8) * 2^-24 in [0, 1), clipped to [-127, 127]; E = x on the
    grid.

    The sum is split as floor(x) + (frac(x) + u >= 1), so that an exact grid
    point comes back unchanged whatever u is. dssm_tpu forms x + u in one
    f32 add, which rounds up to the next integer when u lies within half an
    ulp of x below 1 (x = 100, u = 1 - 2^-24 gives 101): there, and only
    there, the two differ on the same bits."""
    u = (_u32(bits) >> 8).float() * (2.0 ** -24)
    x = x_over_scale.float()
    low = torch.floor(x)
    q = low + ((x - low) + u >= 1.0).float()
    return q.clamp(-127.0, 127.0).to(torch.int8)


def sr_add_rows(old_rows: torch.Tensor, vals: torch.Tensor,
                bits: torch.Tensor) -> torch.Tensor:
    """new_rows = stochastic_round_bf16(f32(old_rows) + f32(vals)): the
    bf16-table row update, accumulated in f32 and rounded once."""
    return stochastic_round_bf16(old_rows.float() + vals.float(), bits)


def sr_quant_rows_int8(old_q: torch.Tensor, scale_rows: torch.Tensor,
                       vals: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """int8-table row update: accumulate in grid units in f32, round back to
    each row's grid stochastically. Rows with scale 0 (never initialized)
    stay exactly 0 whatever vals holds."""
    sc = scale_rows.float().clamp_min(1e-30)
    acc = old_q.float() + vals.float() / sc
    q = stochastic_round_int8(acc, bits)
    return torch.where(scale_rows > 0, q, torch.zeros_like(q))
