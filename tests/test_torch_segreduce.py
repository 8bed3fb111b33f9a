"""Kernel K3 (segmented reduce) and the hash table's grouping half of the
PyTorch port, held against the JAX package on the CPU.

On the CPU the K3 wrappers take their plain PyTorch versions (the CUDA
kernel runs only on the card, where chip_smoke.py holds it against the
same plain versions). K3 is compared with both the jnp code the JAX
package's live path runs (`jax.ops.segment_sum/min/max` in `_SegOps`)
and the Pallas kernel it replaces (interpret mode, the pinned cases of
test_pallas_kernels.py at their tolerance). The hash table must give
the JAX package's hash, slots and representative rows bit for bit.
Inputs come from seeded numpy generators.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from blaze_tpu.ops import hash_table as jht
from blaze_tpu.ops.kernels import segreduce_pallas

from blaze_tpu_torch.ops import hash_table as ht
from blaze_tpu_torch.ops.kernels import segreduce

N, K = 4096, 1024
_JAX_OPS = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
            "max": jax.ops.segment_max}
_PORT_OPS = {"sum": segreduce.segment_sum, "min": segreduce.segment_min,
             "max": segreduce.segment_max}


def _k3_case(op, dtype, name, rng):
    """(gid, values) host arrays for one named case."""
    gid = rng.integers(0, K, N).astype(np.int32)
    if np.issubdtype(dtype, np.floating):
        v = ((rng.random(N) - 0.5) * 2000).astype(dtype)
    else:
        info = np.iinfo(dtype)
        lo, hi = (-1000, 1000) if op == "sum" else (info.min, info.max)
        v = rng.integers(lo, hi, N, dtype=dtype)
    if name == "nonfinite":
        # NaN and +/-inf in segment 3 only, a NaN in segment 9, a dead
        # NaN row parked out of range
        gid[[5, 6, 7, 8]] = 3
        v[[5, 6, 7]] = [np.nan, np.inf, -np.inf]
        gid[100], v[100] = 9, np.nan
        gid[200], v[200] = K + 4, np.nan
    elif name == "out_of_range":
        gid[::7] = K + 3
        gid[1::11] = -1
        gid[2::13] = np.iinfo(np.int32).max
    elif name == "empty":
        # only even segments receive rows
        gid = (gid // 2) * 2
    elif name == "wrap":
        v = rng.integers(2 ** 62, 2 ** 63 - 1, N, dtype=np.int64)
    elif name == "all_out_of_range":
        # every row dropped: each segment holds the neutral value
        gid = np.where(rng.random(N) < 0.5, -7, K).astype(np.int32)
    elif name == "one_segment":
        # every row in the last segment, the rest empty
        gid[:] = K - 1
    elif name == "signed_zero":
        # segments 2-5 hold only zeros: +0/-0/+0, -0/+0, -0 alone and +0
        # alone; -0.0 orders below +0.0 whatever the row order
        gid[(gid >= 2) & (gid <= 5)] = 6
        gid[10:17] = [2, 2, 2, 3, 3, 4, 5]
        v[10:17] = [0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0]
    return gid, v


def _same_bits(got, exp):
    """Bit for bit, NaN equal to NaN (whatever its payload)."""
    if np.issubdtype(got.dtype, np.floating):
        nan = np.isnan(exp)
        assert np.array_equal(np.isnan(got), nan)
        ints = np.int32 if got.dtype == np.float32 else np.int64
        np.testing.assert_array_equal(got[~nan].view(ints),
                                      exp[~nan].view(ints))
    else:
        np.testing.assert_array_equal(got, exp)


K3_CASES = (
    [("sum", d, n) for d in (np.float64, np.int64)
     for n in ("random", "out_of_range", "empty", "all_out_of_range",
               "one_segment")]
    + [("sum", np.float64, "nonfinite"), ("sum", np.int64, "wrap")]
    + [(op, d, n) for op in ("min", "max")
       for d in (np.float32, np.float64, np.int32, np.int64)
       for n in ("random", "out_of_range", "empty")]
    + [(op, d, n) for op in ("min", "max")
       for d in (np.float32, np.float64)
       for n in ("nonfinite", "signed_zero")]
    + [("min", np.float32, "all_out_of_range"),
       ("max", np.int64, "all_out_of_range"),
       ("min", np.int32, "one_segment"), ("max", np.float64, "one_segment")]
)


@pytest.mark.parametrize(
    "op,dtype,name", K3_CASES,
    ids=[f"{o}-{d.__name__}-{n}" for o, d, n in K3_CASES])
def test_k3_matches_jax_segment_ops(op, dtype, name):
    """K3 against jax.ops.segment_* (the JAX aggregate's live path):
    out-of-range gids dropped, empty segments neutral, NaN confined to
    its segment, -0.0 below +0.0, int64 sums wrapping; float64 sums
    within 1e-12 * sum|x| per segment, everything else bit for bit."""
    rng = np.random.default_rng(21)
    gid, v = _k3_case(op, dtype, name, rng)
    exp = np.asarray(_JAX_OPS[op](jnp.asarray(v), jnp.asarray(gid),
                                  num_segments=K))
    got = _PORT_OPS[op](torch.from_numpy(gid), torch.from_numpy(v), K)
    assert got.dtype == torch.from_numpy(v).dtype and got.shape == (K,)
    got = got.numpy()
    if op == "sum" and dtype == np.float64:
        live = (gid >= 0) & (gid < K)
        mag = np.zeros(K)
        np.add.at(mag, gid[live], np.abs(v[live]))
        fin = np.isfinite(exp)
        assert np.array_equal(np.isnan(got), np.isnan(exp))
        assert np.array_equal(got[~fin & ~np.isnan(exp)],
                              exp[~fin & ~np.isnan(exp)])
        assert (np.abs(got[fin] - exp[fin]) <= 1e-12 * mag[fin]).all()
    else:
        _same_bits(got, exp)
    if name == "nonfinite":
        assert np.isnan(got[3]) and np.isnan(got[9])
        assert np.isnan(got).sum() == 2
    empty = segreduce.neutral(op, torch.from_numpy(v).dtype)
    if name == "all_out_of_range":
        assert (got == empty).all()
    if name == "one_segment":
        assert (got[:-1] == empty).all()


def test_k3_matches_pallas_segment_sum():
    """test_pallas_kernels.py::test_pallas_segment_sum_interpret's case
    (rows parked out of range) at its tolerance; the port sums the f32
    values in float64, as the engine does."""
    rng = np.random.default_rng(5)
    cap, k = 4096, 512
    gid = rng.integers(0, k, cap).astype(np.int32)
    gid[::97] = k + 3
    v = (rng.random(cap) * 100 - 50).astype(np.float32)
    ref = np.asarray(segreduce_pallas.segment_sum(
        jnp.asarray(gid), jnp.asarray(v), k))
    got = segreduce.segment_sum(torch.from_numpy(gid),
                                torch.from_numpy(v).double(), k).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_k3_matches_pallas_segment_minmax():
    """test_pallas_segment_minmax_interpret's case: exact, empty
    segments +/-inf."""
    rng = np.random.default_rng(6)
    cap, k = 2048, 512
    gid = rng.integers(0, k, cap).astype(np.int32)
    v = (rng.random(cap) * 1000 - 500).astype(np.float32)
    for is_min, port in ((True, segreduce.segment_min),
                         (False, segreduce.segment_max)):
        ref = np.asarray(segreduce_pallas.segment_minmax(
            jnp.asarray(gid), jnp.asarray(v), k, is_min))
        got = port(torch.from_numpy(gid), torch.from_numpy(v), k).numpy()
        _same_bits(got, ref)


def test_k3_matches_pallas_engine_parity_case():
    """test_pallas_segment_sum_matches_engine_segops' case (8192 rows,
    1024 segments) at its tolerance."""
    rng = np.random.default_rng(9)
    cap, k = 8192, 1024
    gid = rng.integers(0, k, cap).astype(np.int32)
    v = (rng.random(cap) * 10).astype(np.float32)
    ref = np.asarray(segreduce_pallas.segment_sum(
        jnp.asarray(gid), jnp.asarray(v), k))
    got = segreduce.segment_sum(torch.from_numpy(gid),
                                torch.from_numpy(v).double(), k).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_k3_matches_pallas_nonfinite_isolation():
    """test_pallas_segment_sum_nonfinite_isolated's case: a NaN and an
    inf poison only their own segments; a dead NaN row nowhere."""
    rng = np.random.default_rng(10)
    cap, k = 2048, 512
    gid = rng.integers(0, k, cap).astype(np.int32)
    v = (rng.random(cap) * 10).astype(np.float32)
    gid[7], v[7] = 3, np.nan
    gid[1500], v[1500] = 5, np.inf
    gid[11], v[11] = k + 2, np.nan
    ref = np.asarray(segreduce_pallas.segment_sum(
        jnp.asarray(gid), jnp.asarray(v), k))
    got = segreduce.segment_sum(torch.from_numpy(gid),
                                torch.from_numpy(v).double(), k).numpy()
    assert np.isnan(got[3]) and np.isnan(ref[3])
    assert got[5] == np.inf and ref[5] == np.inf
    fin = np.isfinite(ref)
    assert fin.sum() == k - 2 and np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-3)


def test_k3_wrappers_reject_bad_inputs():
    """Narrow and float32 columns are taken (they widen in the kernel);
    other dtypes, int64 gids, mismatched shapes, bad masks or slot lists
    and an empty domain raise."""
    g = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        segreduce.segment_sum(g, torch.zeros(8, dtype=torch.float16), 4)
    with pytest.raises(TypeError):
        segreduce.segment_min(g, torch.zeros(8, dtype=torch.uint8), 4)
    with pytest.raises(TypeError):
        segreduce.segment_max(g.long(), torch.zeros(8), 4)
    with pytest.raises(ValueError):
        segreduce.segment_sum(g, torch.zeros(4, dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        segreduce.segment_sum(g, torch.zeros(8, dtype=torch.float64), 0)
    with pytest.raises(ValueError):
        segreduce.segment_sum(g, torch.zeros(8), 4,
                              contrib=torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        segreduce.segment_sum(g, torch.zeros(8), 4,
                              contrib=torch.ones(7, dtype=torch.bool))
    with pytest.raises(ValueError):
        segreduce.segment_min(g, torch.zeros(8), 4,
                              at=torch.zeros(2, dtype=torch.int64))
    assert segreduce.segment_sum(g, torch.zeros(8), 4).dtype == torch.float64
    assert segreduce.segment_min(
        g, torch.zeros(8, dtype=torch.int16), 4).dtype == torch.int32


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_k3_takes_plain_version_only_for_cpu_tensors(op):
    """A tensor on another device than the CPU never falls back to the
    plain version: off the card the wrapper raises instead."""
    g = torch.zeros(8, dtype=torch.int32, device="meta")
    v = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        _PORT_OPS[op](g, v, 4)
    with pytest.raises(ValueError, match="meta"):
        _PORT_OPS[op](torch.zeros(8, dtype=torch.int32), v, 4)


def test_k3_cpu_never_counts_launches():
    before = segreduce.LAUNCHES
    g = torch.zeros(16, dtype=torch.int32)
    segreduce.segment_sum(g, torch.ones(16, dtype=torch.int64), 4)
    segreduce.segment_min(g, torch.ones(16), 4)
    assert segreduce.LAUNCHES == before


@pytest.mark.parametrize("n,k,op,dtype,pick", [
    (1 << 22, 16384, "sum", torch.float32, "shared"),  # grouped SUM: 128 KiB
    (1 << 22, 16384, "sum", torch.bool, "shared"),     # its counts
    (1 << 22, 16384, "min", torch.float32, "shared"),  # its MIN: 64 KiB
    (1032192, 16384, "sum", torch.float64, "shared"),  # FINAL: 63 rows a slot
    (1 << 22, 1024, "max", torch.int64, "shared"),     # the small domain end
    (1 << 19, 16384, "sum", torch.float32, "global"),  # 32 rows a slot
    (16384, 1024, "sum", torch.float64, "global"),     # 16 rows a slot
    (16384, 32768, "sum", torch.float32, "global"),    # the PARTIAL batch
    (16384, 32768, "min", torch.int8, "global"),
    (1 << 22, 32768, "sum", torch.bool, "global"),     # 256 KiB: no copy
    (1 << 22, 32768, "sum", torch.float32, "global"),
    (1 << 22, 65536, "min", torch.float32, "global"),  # 256 KiB of f32 keys
    (1 << 22, 65536, "max", torch.int64, "global"),
    (1 << 22, 65536, "sum", torch.int32, "global"),    # 512 KiB
    (1 << 22, 1 << 23, "sum", torch.float64, "global"),  # the largest domain
])
def test_k3_variant_by_domain(n, k, op, dtype, pick):
    """The wrapper's choice between a per-block shared-memory copy of
    the segments and global atomics, where each was fastest on the card
    (PERF.md, K3)."""
    assert segreduce.variant(n, k, op, dtype) == pick


# ---------------------------------------------------------------------------
# K3 with the mask and the widening inside: the column in its own dtype
# ---------------------------------------------------------------------------

_SRC_DTYPES = (np.bool_, np.int8, np.int16, np.int32, np.int64, np.float32,
               np.float64)
MASKED_CASES = [(op, d) for op in ("sum", "min", "max") for d in _SRC_DTYPES]


def _masked_case(dtype, rng):
    """(gid, values, contrib): values over the dtype's range with its
    edge values, NaN/+-inf/+-0.0 for floats; some gids out of range; NaN
    and the extremes also on masked-out rows, which must not count."""
    gid = rng.integers(0, K, N).astype(np.int32)
    gid[::29] = K + 1
    gid[1::31] = -5
    if dtype == np.bool_:
        v = rng.random(N) < 0.5
    elif np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, N, dtype=dtype, endpoint=True)
        v[:4] = [info.min, info.max, 0, -1]
    else:
        v = ((rng.random(N) - 0.5) * 2000).astype(dtype)
        # no subnormals: XLA flushes them on the CPU (ROADMAP section 3);
        # the encoding twin below covers them
        v[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, np.nan, 1e-30, -1e-30]
    contrib = rng.random(N) < 0.7
    contrib[5] = False  # a masked-out NaN
    return gid, v, contrib


def _jax_masked(op, v, gid, contrib, wide):
    """jax.ops.segment_* over the jnp.where'd, widened column, as the JAX
    aggregate builds it (blaze_tpu/ops/hash_aggregate.py:1125-1150), in
    the port's result dtype `wide`."""
    jv = jnp.asarray(v).astype(wide)
    if op == "sum":
        fill = jnp.zeros((), wide)
    elif np.issubdtype(wide, np.floating):
        fill = jnp.asarray(np.inf if op == "min" else -np.inf, wide)
    else:
        info = np.iinfo(wide)
        fill = jnp.asarray(info.max if op == "min" else info.min, wide)
    acc = jnp.where(jnp.asarray(contrib), jv, fill)
    return np.asarray(_JAX_OPS[op](acc, jnp.asarray(gid), num_segments=K))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "contrib"])
@pytest.mark.parametrize("op,dtype", MASKED_CASES,
                         ids=[f"{o}-{d.__name__}" for o, d in MASKED_CASES])
def test_k3_narrow_masked_matches_jax(op, dtype, masked):
    """K3 takes the column in its own dtype and the contrib mask: sums
    widen to int64 / float64, min/max of bool/int8/int16 to int32; the
    result equals jax.ops.segment_* over the masked, widened column
    (float64 sums within 1e-12 * sum|x| per segment, the rest bit for
    bit), and the same at a list of slots (`at`)."""
    rng = np.random.default_rng(81)
    gid, v, contrib = _masked_case(dtype, rng)
    if not masked:
        contrib = np.ones(N, bool)
    tv = torch.from_numpy(v)
    wide = segreduce.result_dtype(op, tv.dtype)
    exp = _jax_masked(op, v, gid, contrib,
                      torch.empty((), dtype=wide).numpy().dtype)
    got = _PORT_OPS[op](torch.from_numpy(gid), tv, K,
                        torch.from_numpy(contrib) if masked else None)
    assert got.dtype == wide and got.shape == (K,)
    got = got.numpy()
    if op == "sum" and np.issubdtype(exp.dtype, np.floating):
        live = (gid >= 0) & (gid < K) & contrib
        mag = np.zeros(K)
        np.add.at(mag, gid[live], np.abs(v[live].astype(np.float64)))
        fin = np.isfinite(exp)
        _same_bits(got[~fin], exp[~fin])
        assert (np.abs(got[fin] - exp[fin]) <= 1e-12 * mag[fin]).all()
    else:
        _same_bits(got, exp)
    at = rng.integers(0, K, 300).astype(np.int32)
    taken = _PORT_OPS[op](torch.from_numpy(gid), tv, K,
                          torch.from_numpy(contrib) if masked else None,
                          torch.from_numpy(at)).numpy()
    _same_bits(taken, got[at])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_k3_masked_matches_pallas(op):
    """The masked float32 column against the Pallas kernel in interpret
    mode over the jnp.where'd column (test_pallas_kernels.py's shape and
    tolerance for sums, exact for min/max)."""
    rng = np.random.default_rng(82)
    cap, k = 4096, 512
    gid = rng.integers(0, k, cap).astype(np.int32)
    v = (rng.random(cap) * 100 - 50).astype(np.float32)
    contrib = rng.random(cap) < 0.6
    port = _PORT_OPS[op](torch.from_numpy(gid), torch.from_numpy(v), k,
                         torch.from_numpy(contrib)).numpy()
    if op == "sum":
        ref = np.asarray(segreduce_pallas.segment_sum(
            jnp.asarray(gid), jnp.where(contrib, v, 0.0), k))
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-3)
    else:
        fill = np.inf if op == "min" else -np.inf
        ref = np.asarray(segreduce_pallas.segment_minmax(
            jnp.asarray(gid), jnp.where(contrib, v, fill).astype(np.float32),
            k, op == "min"))
        _same_bits(port, ref)


# A numpy twin of the CUDA accumulator encoding (csrc/segreduce.cu, Acc):
# every empty accumulator is all-zero bits; max stores ordered(x), min
# ~ordered(x), both folded with an unsigned max; a NaN is all ones.

_UINT = {np.dtype(np.int32): np.uint32, np.dtype(np.int64): np.uint64,
         np.dtype(np.float32): np.uint32, np.dtype(np.float64): np.uint64}


def _enc_twin(op, x):
    u = _UINT[x.dtype]
    sign = u(1) << u(8 * x.itemsize - 1)
    bits = x.view(u)
    if np.issubdtype(x.dtype, np.floating):
        ordered = np.where(bits & sign, ~bits, bits | sign).astype(u)
    else:
        ordered = bits ^ sign
    key = ordered if op == "max" else ~ordered
    if np.issubdtype(x.dtype, np.floating):
        key = np.where(np.isnan(x), ~u(0), key).astype(u)
    return key


def _dec_twin(op, dtype, key):
    dtype = np.dtype(dtype)
    u = _UINT[dtype]
    sign = u(1) << u(8 * dtype.itemsize - 1)
    k = key if op == "max" else ~key
    if np.issubdtype(dtype, np.floating):
        bits = np.where(k & sign, k ^ sign, ~k).astype(u)
        out = bits.view(dtype).copy()
        out[key == 0] = np.inf if op == "min" else -np.inf
        out[key == ~u(0)] = np.nan
        return out
    return (k ^ sign).astype(u).view(dtype)


def _ref_extreme(op, x):
    """XLA's min/max of a list: NaN wins, -0.0 below +0.0."""
    if np.issubdtype(x.dtype, np.floating):
        if np.isnan(x).any():
            return np.array(np.nan, x.dtype)
        best = x.min() if op == "min" else x.max()
        if best == 0:
            neg = np.signbit(x[x == 0])
            best = -0.0 if (neg.any() if op == "min" else neg.all()) else 0.0
        return np.array(best, x.dtype)
    return np.array(x.min() if op == "min" else x.max(), x.dtype)


_BITS = {
    np.float32: st.integers(0, 2 ** 32 - 1).map(
        lambda b: np.array([b], np.uint32).view(np.float32)[0]),
    np.float64: st.integers(0, 2 ** 64 - 1).map(
        lambda b: np.array([b], np.uint64).view(np.float64)[0]),
    np.int32: st.integers(-2 ** 31, 2 ** 31 - 1),
    np.int64: st.integers(-2 ** 63, 2 ** 63 - 1),
}
# NaN payloads of both signs, quiet and signalling, +-0, subnormals,
# +-inf, the largest finite values, and the integer extremes
_EDGE_BITS = {
    np.float32: [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0x7FFFFFFF,
                 0x0, 0x80000000, 0x1, 0x807FFFFF, 0x7F800000, 0xFF800000,
                 0x7F7FFFFF, 0xFF7FFFFF],
    np.float64: [0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001,
                 0xFFFFFFFFFFFFFFFF, 0x0, 0x8000000000000000, 0x1,
                 0x800FFFFFFFFFFFFF, 0x7FF0000000000000, 0xFFF0000000000000,
                 0x7FEFFFFFFFFFFFFF],
}


def _edges(dtype):
    if dtype in _EDGE_BITS:
        u = np.uint32 if dtype == np.float32 else np.uint64
        return np.array(_EDGE_BITS[dtype], u).view(dtype)
    info = np.iinfo(dtype)
    return np.array([info.min, info.max, 0, -1, 1], dtype)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64], ids=lambda d: d.__name__)
def test_k3_key_encoding_twin(op, dtype):
    """The zero-neutral key encoding, on random bit patterns (every NaN
    payload, subnormals, +-0.0, +-inf, the integer extremes): the
    unsigned max of the keys of any list, from the all-zero empty key,
    decodes to XLA's min/max of the list (NaN wins, -0.0 below +0.0);
    decoding the empty key gives the neutral; every value decodes back
    to itself bit for bit; non-NaN float keys lie strictly between 0 and
    all ones."""
    edges = _edges(dtype)
    empty = _dec_twin(op, dtype, np.zeros(1, _UINT[np.dtype(dtype)]))[0]
    neutral = segreduce.neutral(op, torch.from_numpy(edges).dtype)
    assert empty == neutral

    @settings(max_examples=150, deadline=None, database=None)
    @given(st.lists(_BITS[dtype], min_size=1, max_size=12))
    def check(values):
        x = np.array(values, dtype)
        keys = _enc_twin(op, x)
        if np.issubdtype(dtype, np.floating):
            fin = ~np.isnan(x)
            ones = ~keys.dtype.type(0)
            assert (keys[fin] > 0).all() and (keys[fin] < ones).all()
            assert (keys[~fin] == ones).all()
            back = _dec_twin(op, dtype, keys[fin])
            assert np.array_equal(back.view(keys.dtype),
                                  x[fin].view(keys.dtype))
        else:
            assert np.array_equal(_dec_twin(op, dtype, keys), x)
        folded = np.maximum.reduce(np.concatenate(
            [np.zeros(1, keys.dtype), keys]))
        got = _dec_twin(op, dtype, np.array([folded], keys.dtype))[0]
        exp = _ref_extreme(op, x)
        if np.isnan(exp):
            assert np.isnan(got)
        else:
            assert np.array(got, dtype).view(keys.dtype) == \
                exp.view(keys.dtype)

    check()
    for i in range(len(edges)):  # every edge alone and with each other
        for j in range(len(edges)):
            x = edges[[i, j]]
            folded = _enc_twin(op, x).max()
            got = _dec_twin(op, dtype, np.array([folded]))[0]
            exp = _ref_extreme(op, x)
            assert (np.isnan(got) and np.isnan(exp)) or \
                np.array(got, dtype).view(_UINT[np.dtype(dtype)]) == \
                exp.view(_UINT[np.dtype(dtype)])


# ---------------------------------------------------------------------------
# hash table, grouping half
# ---------------------------------------------------------------------------

def _key_col(dtype, rng, n, nulls=False):
    if dtype == np.bool_:
        v = rng.random(n) < 0.5
    elif np.issubdtype(dtype, np.floating):
        v = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.inf, -np.inf,
                                 3.0e38, 1e-40], dtype=dtype), n)
        bits = np.array([0x7FC00000, 0xFFC00001, 0x7F800001],
                        dtype=np.uint32).view(np.float32)
        with np.errstate(invalid="ignore"):
            v[rng.integers(0, n, 9)] = np.resize(bits.astype(dtype), 9)
        v[rng.integers(0, n, 30)] = (rng.random(30) * 1e6).astype(dtype)
    else:
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, n, dtype=dtype)
        v[: n // 2] = rng.integers(-50, 50, n // 2).astype(dtype)
    m = (rng.random(n) < 0.8) if nulls else None
    return v, m


HASH_CASES = [
    ("int8", [np.int8]), ("int16", [np.int16]), ("int32", [np.int32]),
    ("int64", [np.int64]), ("bool", [np.bool_]), ("float32", [np.float32]),
    ("float64", [np.float64]), ("nullable_int64_f32", [np.int64, np.float32]),
    ("uint8", [np.uint8]),
    ("nullable_bool_f64_int16", [np.bool_, np.float64, np.int16]),
]


@pytest.mark.parametrize("name,dtypes", HASH_CASES,
                         ids=[c[0] for c in HASH_CASES])
def test_cheap_hash_bit_exact(name, dtypes):
    """cheap_hash equals the JAX package's bit for bit: every integer
    width, bool, f32/f64 with NaN payloads and -0.0, nullable keys."""
    rng = np.random.default_rng(31)
    n = 2048
    cols = [_key_col(d, rng, n, nulls=name.startswith("nullable"))
            for d in dtypes]
    exp = np.asarray(jht.cheap_hash(
        [(jnp.asarray(v), None if m is None else jnp.asarray(m))
         for v, m in cols], n)).view(np.uint32)
    got = ht.cheap_hash(
        [(torch.from_numpy(v), None if m is None else torch.from_numpy(m))
         for v, m in cols], n).numpy()
    np.testing.assert_array_equal(got, exp.astype(np.int64))


def _slot_inputs(case, rng, cap):
    live = rng.random(cap) < 0.9
    if case == "direct":
        return [(rng.integers(-300, 300, cap).astype(np.int32), None)], live
    if case == "direct_nullable_int64":
        v = rng.integers(10 ** 12, 10 ** 12 + 500, cap, dtype=np.int64)
        return [(v, rng.random(cap) < 0.7)], live
    if case == "direct_bool":
        return [(rng.random(cap) < 0.3, rng.random(cap) < 0.9)], live
    if case == "hash_wide_int":
        return [(rng.integers(-2 ** 40, 2 ** 40, cap), None)], live
    if case == "direct_int8_full_span":
        # a span of 255 overflows int8 unless the key widens first
        v = rng.integers(-128, 128, cap).astype(np.int8)
        v[:2] = [-128, 127]
        return [(v, rng.random(cap) < 0.9)], live
    if case == "direct_int16":
        return [(rng.integers(-30000, -29500, cap).astype(np.int16),
                 None)], live
    if case == "hash_float64":
        v = rng.choice(np.array([0.0, -0.0, np.nan, 1e300, -1e-300, 7.25]),
                       cap)
        return [(v, rng.random(cap) < 0.9)], live
    if case == "all_null_key":
        # no valid key: the direct branch is refused, NULL is one group
        return [(rng.integers(0, 9, cap).astype(np.int32),
                 np.zeros(cap, bool))], live
    if case == "no_live_rows":
        return [(rng.integers(0, 9, cap).astype(np.int32), None)], \
            np.zeros(cap, bool)
    # two keys, some nullable, float NaN and +/-0.0
    a = rng.integers(0, 40, cap).astype(np.int32)
    f = rng.choice(np.array([0.0, -0.0, np.nan, 1.0, 2.5], np.float32), cap)
    return [(a, rng.random(cap) < 0.9), (f, None)], live


@pytest.mark.parametrize("case", ["direct", "direct_nullable_int64",
                                  "direct_bool", "hash_wide_int",
                                  "hash_two_keys", "direct_int8_full_span",
                                  "direct_int16", "hash_float64",
                                  "all_null_key", "no_live_rows"])
def test_group_slots_match_jax(case):
    """Slots and representative rows equal the JAX package's, on the
    direct branch and on the hash branch."""
    rng = np.random.default_rng(41)
    cap, tsize = 2048, 4096
    cols, live = _slot_inputs(case, rng, cap)
    jcols = [(jnp.asarray(v), None if m is None else jnp.asarray(m))
             for v, m in cols]
    jslot, jtab, jover = jax.jit(
        lambda c, lv: jht.group_slots(c, lv, cap, tsize))(
            jcols, jnp.asarray(live))
    slot, tab, over = ht.group_slots(
        [(torch.from_numpy(v), None if m is None else torch.from_numpy(m))
         for v, m in cols], torch.from_numpy(live), cap, tsize)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    np.testing.assert_array_equal(slot.numpy()[live], np.asarray(jslot)[live])
    assert bool(over) == bool(jover) is False
    occupied = tab.numpy() != cap
    if case.startswith("direct"):
        assert occupied.sum() <= 602
    if case == "direct_int8_full_span":
        (v, m), = cols
        assert occupied.sum() == (len(np.unique(v[live & m]))
                                  + (live & ~m).any())
        assert occupied.sum() > 250
    if case in ("all_null_key", "no_live_rows"):
        assert occupied.sum() == int(case == "all_null_key")


def test_insert_round_bound_trips_like_jax():
    """An undersized table (more distinct keys than 16 probe rounds can
    place) reports overflow, with the same partial table as the JAX
    package's bounded while_loop."""
    rng = np.random.default_rng(51)
    cap, tsize = 4096, 4096
    a = rng.permutation(cap).astype(np.int64) * 7919
    b = rng.integers(0, 3, cap).astype(np.int32)
    live = np.ones(cap, bool)
    jcols = [(jnp.asarray(a), None), (jnp.asarray(b), None)]
    _, jtab, jover = jax.jit(
        lambda c, lv: jht.group_slots(c, lv, cap, tsize, max_rounds=16))(
            jcols, jnp.asarray(live))
    _, tab, over = ht.group_slots(
        [(torch.from_numpy(a), None), (torch.from_numpy(b), None)],
        torch.from_numpy(live), cap, tsize, max_rounds=16)
    assert bool(over) and bool(jover)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))


@pytest.mark.parametrize("c", [0x9E3779B9, 0x85EBCA6B, 0xFFFFFFFF, 1])
def test_mul32_is_uint32_multiply(c):
    """The int64 emulation of the uint32 product wraps as uint32 does,
    over the whole [0, 2^32) input range."""
    rng = np.random.default_rng(61)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 2 ** 32 - 1]
    exp = (a * np.uint32(c)).astype(np.int64)
    got = ht._mul32(torch.from_numpy(a.astype(np.int64)), c).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("r", [0, 1, 15, 65535, 65536, 92682, 1 << 20])
def test_tri_slot_matches_jax(r):
    """Probe round r's slot equals the JAX package's, also past the
    rounds whose offset r(r+1)/2 wraps in uint32."""
    rng = np.random.default_rng(71)
    mask = (1 << 23) - 1
    u0 = rng.integers(0, mask + 1, 512)
    exp = np.asarray(jht._tri_slot(jnp.asarray(u0, jnp.uint32),
                                   jnp.uint32(r), jnp.uint32(mask)))
    got = ht._tri_slot(torch.from_numpy(u0), r, mask).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("case,branch,rounds", [
    ("direct", 1, 0), ("hash_wide_int", 1, None), ("hash_two_keys", 0, None),
])
def test_group_slots_counts_its_syncs(case, branch, rounds):
    """One counted readback for the direct-or-hash choice (single
    integer keys only) and one per probe round plus the last, empty
    check of the insert loop."""
    from blaze_tpu_torch.runtime import dispatch

    rng = np.random.default_rng(41)
    cap, tsize = 2048, 4096
    cols, live = _slot_inputs(case, rng, cap)
    with dispatch.counting() as c:
        ht.group_slots(
            [(torch.from_numpy(v), None if m is None else torch.from_numpy(m))
             for v, m in cols], torch.from_numpy(live), cap, tsize)
    got_rounds = c.counts.get("d2h_syncs.insert_round", 0)
    assert c.counts.get("d2h_syncs.group_branch", 0) == branch
    assert c.counts["d2h_syncs"] == branch + got_rounds
    if rounds is None:
        assert 2 <= got_rounds <= 17
    else:
        assert got_rounds == rounds


def test_table_size_for_matches_jax():
    for cap in (1, 256, 512, 513, 4096, 8192, 1 << 22):
        assert ht.table_size_for(cap) == jht.table_size_for(cap)
    assert ht.table_size_for(8192) == 16384
    assert ht.table_size_for(1 << 22) == 1 << 23
