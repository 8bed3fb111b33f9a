"""Vectorized 128-bit decimal arithmetic on torch int64 tensors.

A port of the JAX package's exprs/int128.py. Wide decimals are
(capacity, 2) [lo, hi] int64 limb pairs (types.is_wide_decimal, the
reference's 16-byte decimal slot, shuffle_writer_exec.rs:196-220);
+, - and * on them run here, elementwise, with no host sync.

Internal model, as in the JAX package: sign-magnitude. A magnitude is
two 64-bit lanes (lo, hi), a sign a bool. The JAX code holds the lanes
in uint64; torch has almost no uint64 arithmetic, so here every lane
is an int64 tensor holding the uint64 BIT PATTERN, and only operations
whose bits do not depend on the sign interpretation are used:

- `+`, `-` and `*` wrap in two's complement (the low 64 bits of the
  unsigned result), on the CPU and on CUDA alike;
- an unsigned compare is a signed compare of both sides with the top
  bit flipped (`ult`);
- a logical right shift masks off the sign fill (`_srl`);
- a 32 x 32 -> 64-bit product is taken as its bit pattern and only
  split or compared unsigned afterwards;
- division only ever divides a value below 2^63 by a constant below
  2^31, where signed and unsigned division agree.

So one formulation gives the same bits on both devices; the CPU tests
hold it against the JAX package and Python ints.

Overflow semantics: Spark non-ANSI - a result beyond decimal(38)
becomes NULL (the `ok` lane each signed op returns). Rounding is
HALF_UP (away from zero). Rescale exponents are Python ints, fixed by
the plan's types.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK32 = 0xFFFFFFFF
_MIN64 = -(1 << 63)


def _s64(v: int) -> int:
    """A Python int in [0, 2^64) as the int64 with its bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a 64-bit pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b of 64-bit patterns (b a tensor or an int64 int)."""
    if isinstance(b, int):
        return (a ^ _MIN64) < _s64(b ^ (1 << 63))
    return (a ^ _MIN64) < (b ^ _MIN64)


def _bit(cond: torch.Tensor) -> torch.Tensor:
    return cond.to(torch.int64)


# ---------------------------------------------------------------------------
# boundary conversions: two's-complement limb pair <-> sign+magnitude
# ---------------------------------------------------------------------------

def from_limbs(lo: torch.Tensor, hi: torch.Tensor):
    """(lo, hi) int64 two's complement -> (mlo, mhi, neg)."""
    neg = hi < 0
    # 128-bit negate: ~x + 1; the +1 carries into the high limb
    # exactly when the low limb is zero
    nlo = ~lo + 1
    nhi = ~hi + _bit(lo == 0)
    return torch.where(neg, nlo, lo), torch.where(neg, nhi, hi), neg


def to_limbs(mlo: torch.Tensor, mhi: torch.Tensor, neg: torch.Tensor):
    """sign+magnitude -> (lo, hi) int64 two's complement."""
    nlo = ~mlo + 1
    nhi = ~mhi + _bit(mlo == 0)
    return torch.where(neg, nlo, mlo), torch.where(neg, nhi, mhi)


def from_narrow(v: torch.Tensor):
    """int64 unscaled value -> sign+magnitude. -INT64_MIN wraps to
    itself, whose bit pattern IS 2^63 unsigned."""
    v = v.to(torch.int64)
    neg = v < 0
    return torch.where(neg, -v, v), torch.zeros_like(v), neg


# ---------------------------------------------------------------------------
# magnitude primitives
# ---------------------------------------------------------------------------

def _mag_add(alo, ahi, blo, bhi):
    """u128 + u128 -> (lo, hi, overflow)."""
    lo = alo + blo
    c = ult(lo, alo)  # low-limb carry
    hi_sum = ahi + bhi
    ovf1 = ult(hi_sum, ahi)
    hi = hi_sum + _bit(c)
    ovf2 = c & ult(hi, hi_sum)  # the carry wrapped the high limb
    return lo, hi, ovf1 | ovf2


def _mag_sub(alo, ahi, blo, bhi):
    """u128 - u128 (a >= b) -> (lo, hi)."""
    return alo - blo, ahi - bhi - _bit(ult(alo, blo))


def _mag_cmp_lt(alo, ahi, blo, bhi):
    return ult(ahi, bhi) | ((ahi == bhi) & ult(alo, blo))


def _split32(x: torch.Tensor):
    return x & _MASK32, _srl(x, 32)


def _mag_mul_by_u64(mlo, mhi, m: int):
    """u128 x a constant 0 < m < 2^64 -> (lo, hi, overflow): overflow
    is any bit at 2^128 or above."""
    assert 0 < m < (1 << 64)
    ms = (m & _MASK32, m >> 32)
    a = _split32(mlo) + _split32(mhi)
    # partial products: limb i of a times limb j of m lands at 32*(i+j)
    res = [torch.zeros_like(mlo) for _ in range(6)]
    for i, ai in enumerate(a):
        for j, mj in enumerate(ms):
            if mj == 0:
                continue
            p = ai * mj  # the 64-bit pattern of a 32 x 32-bit product
            res[i + j] = res[i + j] + (p & _MASK32)
            res[i + j + 1] = res[i + j + 1] + _srl(p, 32)
    # carry-normalize (every lane stays below a few times 2^32)
    for k in range(5):
        res[k + 1] = res[k + 1] + _srl(res[k], 32)
        res[k] = res[k] & _MASK32
    lo = res[0] | (res[1] << 32)
    hi = res[2] | (res[3] << 32)
    return lo, hi, (res[4] | res[5]) != 0


def _mag_mul(alo, ahi, blo, bhi):
    """u128 x u128 -> (lo, hi, overflow): the full 4 x 4 32-bit limb
    product with everything at or above 2^128 folded into overflow."""
    a = _split32(alo) + _split32(ahi)
    b = _split32(blo) + _split32(bhi)
    res = [torch.zeros_like(alo) for _ in range(4)]
    ovf = torch.zeros(alo.shape, dtype=torch.bool, device=alo.device)
    for i in range(4):
        for j in range(4):
            p = a[i] * b[j]
            k = i + j
            if k >= 4:
                ovf = ovf | (p != 0)
                continue
            res[k] = res[k] + (p & _MASK32)
            if k + 1 >= 4:
                ovf = ovf | (_srl(p, 32) != 0)
            else:
                res[k + 1] = res[k + 1] + _srl(p, 32)
    for k in range(3):
        res[k + 1] = res[k + 1] + _srl(res[k], 32)
        res[k] = res[k] & _MASK32
    ovf = ovf | (_srl(res[3], 32) != 0)
    res[3] = res[3] & _MASK32
    lo = res[0] | (res[1] << 32)
    hi = res[2] | (res[3] << 32)
    return lo, hi, ovf


def _pow10_limbs(k: int) -> Tuple[int, int]:
    """10^k as int64 limb bit patterns (lo, hi)."""
    v = 10**k
    return _s64(v), _s64(v >> 64)


def _mag_divmod_u32(mlo, mhi, d: int):
    """u128 // d for a constant 0 < d < 2^31, with remainder: long
    division high -> low over four 32-bit limbs. The running value
    (rem << 32 | limb) stays below 2^63, so int64 floor division is the
    unsigned one."""
    assert 0 < d < (1 << 31)
    limbs = list(_split32(mlo)) + list(_split32(mhi))  # [l0..l3]
    q = [None] * 4
    rem = torch.zeros_like(mlo)
    for idx in (3, 2, 1, 0):
        cur = (rem << 32) | limbs[idx]
        q[idx] = torch.div(cur, d, rounding_mode="floor")
        rem = cur - q[idx] * d
    return q[0] | (q[1] << 32), q[2] | (q[3] << 32), rem  # rem < d


def div_pow10_half_up(mlo, mhi, k: int):
    """u128 magnitude // 10^k with HALF_UP -> (lo, hi); k >= 0."""
    if k == 0:
        return mlo, mhi
    # chain 10^9-sized chunks; accumulate the FULL remainder (against
    # the whole 10^k divisor) in 128 bits so the final half comparison
    # is exact - rounding digit at a time would be wrong (0.45 -> 0.5
    # -> 1 instead of 0)
    qlo, qhi = mlo, mhi
    rlo = torch.zeros_like(mlo)
    rhi = torch.zeros_like(mhi)
    divided = 1  # product of the divisors applied so far
    left = k
    while left > 0:
        step = min(9, left)
        d = 10**step
        qlo, qhi, rem = _mag_divmod_u32(qlo, qhi, d)
        if divided == 1:
            rlo, rhi = rem, torch.zeros_like(rem)
        else:
            # full remainder so far = rem * divided + prior; it fits
            # 128 bits (rem < 10^9, divided <= 10^29)
            plo, phi = rem, torch.zeros_like(rem)
            dleft = divided
            while dleft > 1:
                chunk = min(dleft, 10**19)
                while dleft % chunk:  # divided is a power of 10
                    chunk //= 10
                plo, phi, _ = _mag_mul_by_u64(plo, phi, chunk)
                dleft //= chunk
            rlo, rhi, _ = _mag_add(rlo, rhi, plo, phi)
        divided *= d
        left -= step
    # HALF_UP: q += (2 * rem >= 10^k); 2 * rem < 2 * 10^38 < 2^128
    tlo, thi, _ = _mag_add(rlo, rhi, rlo, rhi)
    dlo, dhi = _pow10_limbs(k)
    ge = ~(ult(thi, dhi) | ((thi == dhi) & ult(tlo, dlo)))
    qlo2 = qlo + _bit(ge)
    qhi2 = qhi + _bit(ge & (qlo2 == 0))
    return qlo2, qhi2


def rescale_up(mlo, mhi, k: int):
    """u128 magnitude x 10^k -> (lo, hi, overflow); k >= 0."""
    ovf = torch.zeros(mlo.shape, dtype=torch.bool, device=mlo.device)
    left = k
    while left > 0:
        step = min(19, left)  # 10^19 < 2^64
        mlo, mhi, o = _mag_mul_by_u64(mlo, mhi, 10**step)
        ovf = ovf | o
        left -= step
    return mlo, mhi, ovf


_D38_LO, _D38_HI = _pow10_limbs(38)


def exceeds_dec38(mlo, mhi):
    """|x| > 10^38 - 1 (Spark's non-ANSI NULL-on-overflow bound)."""
    return ~(ult(mhi, _D38_HI) | ((mhi == _D38_HI) & ult(mlo, _D38_LO)))


# ---------------------------------------------------------------------------
# signed ops over (mlo, mhi, neg) triples
# ---------------------------------------------------------------------------

def signed_add(a, b):
    """(mag, sign) + (mag, sign) -> (mlo, mhi, neg, ok)."""
    alo, ahi, aneg = a
    blo, bhi, bneg = b
    same = aneg == bneg
    slo, shi, ovf = _mag_add(alo, ahi, blo, bhi)
    # opposite signs: the larger magnitude wins
    a_lt_b = _mag_cmp_lt(alo, ahi, blo, bhi)
    dlo1, dhi1 = _mag_sub(blo, bhi, alo, ahi)
    dlo2, dhi2 = _mag_sub(alo, ahi, blo, bhi)
    mlo = torch.where(same, slo, torch.where(a_lt_b, dlo1, dlo2))
    mhi = torch.where(same, shi, torch.where(a_lt_b, dhi1, dhi2))
    neg = torch.where(same, aneg, torch.where(a_lt_b, bneg, aneg))
    neg = neg & ~((mlo == 0) & (mhi == 0))
    ok = ~(same & ovf) & ~exceeds_dec38(mlo, mhi)
    return mlo, mhi, neg, ok


def signed_mul(a, b, down: int):
    """(mag, sign) x (mag, sign), then a HALF_UP divide by 10^down ->
    (mlo, mhi, neg, ok). A product past 128 bits is NULL even where the
    rescaled value would fit: the JAX package's documented deviation
    from Spark's arbitrary-precision BigDecimal."""
    alo, ahi, aneg = a
    blo, bhi, bneg = b
    mlo, mhi, ovf = _mag_mul(alo, ahi, blo, bhi)
    if down > 0:
        mlo, mhi = div_pow10_half_up(mlo, mhi, down)
    neg = (aneg ^ bneg) & ~((mlo == 0) & (mhi == 0))
    ok = ~ovf & ~exceeds_dec38(mlo, mhi)
    return mlo, mhi, neg, ok


def _u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """A 64-bit pattern read unsigned, as float64 rounded once: both
    32-bit halves convert exactly and the sum rounds."""
    hi, lo = _srl(x, 32), x & _MASK32
    return hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)


def to_float64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two's-complement limb pair -> float64 (the decimal DIV path)."""
    mlo, mhi, neg = from_limbs(lo, hi)
    f = _u64_to_f64(mlo) + _u64_to_f64(mhi) * (2.0**64)
    return torch.where(neg, -f, f)


def limbs_of(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of a value column: a (cap, 2) limb pair as it is, an
    int64 (or narrower) unscaled column sign-extended."""
    if v.dim() == 2:
        return v[:, 0], v[:, 1]
    v = v.to(torch.int64)
    return v, v >> 63


def python_limbs(value: int) -> Tuple[int, int]:
    """(lo, hi) int64 bit patterns of a Python int in 128-bit two's
    complement."""
    t = value & ((1 << 128) - 1)
    return _s64(t), _s64(t >> 64)
