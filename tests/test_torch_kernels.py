"""Kernels K1 (masked statistics) and K2 (compaction permutation) of the
PyTorch port, held against the JAX package on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernels run only on the card, where chip_smoke.py holds them
against the same plain versions). Each kernel is compared with both
the Pallas kernel it replaces (interpret mode) and the jnp code the JAX
package's live path runs. Inputs come from seeded numpy generators.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.ops.hash_aggregate import _SegOps
from blaze_tpu.ops.kernels import compact_pallas, stats_pallas
from blaze_tpu.ops.util import _compact_indices

from blaze_tpu_torch.ops.kernels import _build, compact, stats

CAP = 4096


def _k1_case(name, dtype, rng, n=CAP):
    """(values, mask) host arrays for one named case; "u8_mask" keeps
    the rows whose uint8 mask byte holds 2..255."""
    if dtype == np.bool_:
        v = rng.random(n) < 0.5
    elif np.issubdtype(dtype, np.floating):
        v = ((rng.random(n) - 0.5) * 2000).astype(dtype)
    else:
        info = np.iinfo(dtype)
        v = rng.integers(max(info.min, -1000), min(info.max, 1000),
                         n).astype(dtype)
    m = rng.random(n) < 0.6
    if name == "u8_mask":
        m = np.where(m, rng.integers(2, 256, n), 0).astype(np.uint8)
    if name == "nan":
        v[rng.integers(0, n, 4)] = np.nan
        m[:] = True
    elif name == "inf":
        v[rng.integers(0, n, 3)] = np.inf
        v[rng.integers(0, n, 3)] = -np.inf
    elif name == "all_masked":
        m[:] = False
    elif name == "all_kept":
        m[:] = True
    elif name == "wrap":
        v = rng.integers(2 ** 62, 2 ** 63 - 1, n, dtype=np.int64)
        m[:] = True
    elif name == "signed_zero":
        # -0.0 and +0.0 mixed: min is -0.0 and max +0.0 in any row order
        v = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(dtype)
    elif name == "neg_zero":
        v = np.full(n, -0.0, dtype)
    return v, m


def _port_stats(v, m):
    s, lo, hi, c = stats.masked_stats(torch.from_numpy(v),
                                      torch.from_numpy(m))
    return s.numpy()[0], lo.numpy()[0], hi.numpy()[0], int(c.numpy()[0])


def _same(a, b):
    """Exact equality, NaN equal to NaN and -0.0 apart from +0.0."""
    return bool(np.isnan(a) and np.isnan(b)) or (
        a == b and np.signbit(a) == np.signbit(b))


PALLAS_CASES = [
    (np.float32, "random"), (np.float32, "nan"), (np.float32, "inf"),
    (np.float32, "all_masked"), (np.float32, "all_kept"),
    (np.int32, "random"), (np.int32, "all_kept"),
]


@pytest.mark.parametrize("dtype,name", PALLAS_CASES,
                         ids=[f"{d.__name__}-{n}" for d, n in PALLAS_CASES])
def test_k1_matches_pallas_interpret(dtype, name):
    """K1 against stats_pallas.masked_stats in interpret mode: rtol 1e-5
    on the sum for the Pallas kernel's f32 partials (as in
    test_pallas_kernels.py), exact min/max/count."""
    rng = np.random.default_rng(11)
    v, m = _k1_case(name, dtype, rng)
    ref = np.asarray(stats_pallas.masked_stats(
        jnp.asarray(v), jnp.asarray(m), interpret=True))
    s, lo, hi, c = _port_stats(v, m)
    assert c == int(ref[3])
    if name == "nan":
        assert np.isnan(s) and np.isnan(ref[0])
    elif name == "inf" and not np.isfinite(ref[0]):
        assert (np.isnan(s) and np.isnan(ref[0])) or s == ref[0]
    else:
        np.testing.assert_allclose(s, ref[0], rtol=1e-5, atol=1e-3)
    if c:
        assert _same(np.float64(lo), ref[1]) and _same(np.float64(hi), ref[2])
    elif dtype == np.float32:
        # empty selection: the identities (+inf, -inf)
        assert lo == np.inf and hi == -np.inf
        assert ref[1] == np.inf and ref[2] == -np.inf


SEGOPS_CASES = [
    (d, n)
    for d in (np.float32, np.float64, np.int32, np.int64, np.bool_, np.int8,
              np.int16)
    for n in ("random", "nan", "inf", "all_masked", "all_kept",
              "signed_zero", "neg_zero")
    if np.issubdtype(d, np.floating) or n in ("random", "all_masked",
                                              "all_kept")
] + [(np.int64, "wrap")] + [
    (d, "u8_mask") for d in (np.float32, np.int16, np.bool_)]


def _jax_keyless(v, m):
    """(sum, min, max, count) by the jnp reductions the JAX keyless
    aggregate runs (`_SegOps.scalar` over the masked acc/contrib of
    `_agg_state`); a bool's min and max are its AND and OR, with True
    and False as the identities."""
    seg = _SegOps(None, 1, True)
    jv, jm = jnp.asarray(v), jnp.asarray(m) != 0
    st = jnp.float64 if np.issubdtype(v.dtype, np.floating) else jnp.int64
    exp_sum = np.asarray(seg.sum(jnp.where(jm, jv, 0).astype(st)))[0]
    if v.dtype == np.bool_:
        lo_n, hi_n = True, False
    elif np.issubdtype(v.dtype, np.floating):
        lo_n, hi_n = jnp.inf, -jnp.inf
    else:
        lo_n, hi_n = np.iinfo(v.dtype).max, np.iinfo(v.dtype).min
    exp_lo = np.asarray(seg.min(jnp.where(jm, jv, jnp.asarray(lo_n,
                                                              v.dtype))))
    exp_hi = np.asarray(seg.max(jnp.where(jm, jv, jnp.asarray(hi_n,
                                                              v.dtype))))
    exp_cnt = int(np.asarray(seg.sum(jm.astype(jnp.int64)))[0])
    return exp_sum, exp_lo[0], exp_hi[0], exp_cnt


def _assert_matches_jax(v, m, got):
    """ints, counts and min/max exact (min and max in the column's
    dtype), float64 sums within 1e-12 * sum|x|."""
    s, lo, hi, c = got
    exp_sum, exp_lo, exp_hi, exp_cnt = _jax_keyless(v, m)
    assert c == exp_cnt
    assert _same(lo, exp_lo) and _same(hi, exp_hi)
    assert lo.dtype == v.dtype and hi.dtype == v.dtype
    if np.issubdtype(v.dtype, np.floating):
        assert s.dtype == np.float64
        if np.isfinite(exp_sum):
            tol = 1e-12 * np.abs(v[m != 0].astype(np.float64)).sum()
            assert abs(s - exp_sum) <= tol
        else:
            assert _same(s, exp_sum)
    else:
        assert s.dtype == np.int64 and s == exp_sum


@pytest.mark.parametrize("dtype,name", SEGOPS_CASES,
                         ids=[f"{d.__name__}-{n}" for d, n in SEGOPS_CASES])
def test_k1_matches_keyless_segops(dtype, name):
    """K1 against the jnp reductions the JAX keyless aggregate runs, for
    every column dtype K1 takes (bool, int8-64, float32/64) and uint8
    masks holding 2..255."""
    rng = np.random.default_rng(12)
    v, m = _k1_case(name, dtype, rng)
    _assert_matches_jax(v, m, _port_stats(v, m))


@pytest.mark.parametrize("offset", range(1, 16))
def test_k1_views_at_storage_offsets_match_jax(offset):
    """Values and mask as views `offset` and 16 - `offset` elements into
    their storages (a sliced batch column starts anywhere), int16 values
    and a uint8 mask, against the JAX reductions on the same rows."""
    rng = np.random.default_rng(100 + offset)
    n = 1000
    v, m = _k1_case("u8_mask", np.int16, rng, n)
    vs = torch.zeros(n + 16, dtype=torch.int16)
    ms = torch.zeros(n + 16, dtype=torch.uint8)
    moff = 16 - offset
    vs[offset:offset + n] = torch.from_numpy(v)
    ms[moff:moff + n] = torch.from_numpy(m)
    got = stats.masked_stats(vs[offset:offset + n], ms[moff:moff + n])
    assert got[0].device.type == "cpu"
    s, lo, hi, c = (t.numpy()[0] for t in got)
    _assert_matches_jax(v, m, (s, lo, hi, int(c)))


K1_DTYPES = [torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
             torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
def test_k1_results_are_views_of_one_buffer(dtype):
    """The four results keep their dtypes and shape (1,), as views of one
    32-byte buffer laid out as the kernel writes it: the sum at byte 0,
    the count at 8, min at 16 and max right after it."""
    v = torch.zeros(40, dtype=dtype)
    res = stats.masked_stats(v, torch.ones(40, dtype=torch.bool))
    acc = torch.float64 if dtype.is_floating_point else torch.int64
    assert [t.dtype for t in res] == [acc, dtype, dtype, torch.int64]
    assert all(t.shape == (1,) for t in res)
    base = res[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in res)
    assert res[0].untyped_storage().nbytes() == 32
    starts = [t.data_ptr() - base for t in res]
    assert starts == [0, 16, 16 + v.element_size(), 8]


def test_k1_grid():
    """One block up to 64 KiB of values, then one per 32 KiB round, at
    most two an SM."""
    assert stats.grid(0, 4, 132) == 1
    assert stats.grid(16384, 4, 132) == 1
    assert stats.grid(65536, 1, 132) == 1
    assert stats.grid(16385, 4, 132) == 3
    assert stats.grid(16384, 8, 132) == 4
    assert stats.grid(1 << 24, 4, 132) == 264


def _k2_masks(rng, n):
    return {
        "p30": rng.random(n) < 0.3,
        "all_kept": np.ones(n, bool),
        "none_kept": np.zeros(n, bool),
        "tail_only": np.arange(n) >= n - 5,
    }


@pytest.mark.parametrize("name", ["p30", "all_kept", "none_kept",
                                  "tail_only"])
def test_k2_matches_pallas_compact_perm(name):
    """K2 against compact_pallas.compact_perm (interpret mode on the
    CPU): the live prefix and the count agree exactly."""
    keep = _k2_masks(np.random.default_rng(13), CAP)[name]
    ref_src, ref_n = compact_pallas.compact_perm(jnp.asarray(keep))
    src, n = compact.compact_perm(torch.from_numpy(keep))
    n = int(n[0])
    assert n == int(ref_n)
    np.testing.assert_array_equal(src.numpy()[:n],
                                  np.asarray(ref_src)[:n])
    assert src.dtype == torch.int32


@pytest.mark.parametrize("cap", [256, 1000, CAP])
def test_k2_matches_compact_indices(cap):
    """K2 against ops/util._compact_indices, the function it stands in
    for: the whole array (0-filled tail included) and the count."""
    rng = np.random.default_rng(14)
    for keep in _k2_masks(rng, cap).values():
        ref_idx, ref_n = _compact_indices(jnp.asarray(keep), cap)
        src, n = compact.compact_perm(torch.from_numpy(keep))
        np.testing.assert_array_equal(src.numpy().astype(np.int64),
                                      np.asarray(ref_idx))
        assert int(n[0]) == int(ref_n)


K2_SIZES = [1, 15, 17, 4097, 8191, 8192, 8193]


@pytest.mark.parametrize("offset", [0, 1, 7, 15])
@pytest.mark.parametrize("n", K2_SIZES)
def test_k2_uint8_views_match_jax(n, offset):
    """A uint8 mask holding 0..255 (any nonzero byte is kept), taken as a
    view that starts `offset` bytes into its storage, against numpy's
    flatnonzero and the JAX package's _compact_indices over `keep != 0`
    (it sums its mask; the JAX package only passes bool ones): the
    whole array (0-filled tail included) and the count."""
    rng = np.random.default_rng(16 + n + offset)
    store = rng.integers(0, 256, n + 16).astype(np.uint8)
    store[rng.random(n + 16) < 0.5] = 0
    store[offset] = 2  # a kept row at each end
    store[offset + n - 1] = 255
    view = torch.from_numpy(store)[offset:offset + n]
    assert view.storage_offset() == offset
    keep = store[offset:offset + n]
    ref_idx, ref_n = _compact_indices(jnp.asarray(keep != 0), n)
    src, cnt = compact.compact_perm(view)
    exp = np.zeros(n, np.int64)
    live = np.flatnonzero(keep)
    exp[:len(live)] = live
    np.testing.assert_array_equal(src.numpy().astype(np.int64), exp)
    np.testing.assert_array_equal(np.asarray(ref_idx), exp)
    assert int(cnt[0]) == int(ref_n) == len(live)


@pytest.mark.parametrize("n", K2_SIZES + [0, 65536, 65537, 1 << 24])
@pytest.mark.parametrize("head", [0, 1, 15])
def test_k2_allocation_layout(n, head):
    """One allocation per call: the permutation at 0 and the count word
    after it on 16-byte boundaries; past 65,536 rows, then the look-back
    scratch (16 + 8 bytes a tile), whose tiles, laid on the 16-byte grid
    `head` bytes below the first row, cover every row. Up to 65,536 rows
    the kernel needs no scratch."""
    tiles, live_at, words = compact.layout(n, head)
    assert live_at >= n and live_at % 4 == 0
    if n <= compact._SMALL_ROWS:
        assert tiles == 0 and words == live_at + 4
        return
    assert tiles * compact._TILE >= head + n
    assert (tiles - 1) * compact._TILE < head + n
    assert words == live_at + 4 + (16 + 8 * tiles) // 4


def test_k2_gather_is_bit_exact_for_nonfinite():
    """Columns move through the permutation by index_select: NaN
    payloads, infinities and -0.0 survive bit for bit."""
    rng = np.random.default_rng(15)
    v = (rng.random(CAP) * 10).astype(np.float32)
    v[[3, 70, 900]] = [np.nan, np.inf, -0.0]
    keep = rng.random(CAP) < 0.5
    keep[[3, 70, 900]] = True
    src, n = compact.compact_perm(torch.from_numpy(keep))
    got = torch.index_select(torch.from_numpy(v), 0, src)[: int(n[0])]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  v[keep].view(np.uint32))


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        stats.masked_stats(torch.zeros(8, dtype=torch.float16),
                           torch.ones(8, dtype=torch.bool))
    with pytest.raises(TypeError):
        stats.masked_stats(torch.zeros(8), torch.ones(8))
    with pytest.raises(ValueError):
        stats.masked_stats(torch.zeros(8), torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        compact.compact_perm(torch.ones(8, dtype=torch.int32))


def test_cpu_tensors_never_count_launches():
    """The launch counters count CUDA launches only."""
    before = (stats.LAUNCHES, compact.LAUNCHES)
    stats.masked_stats(torch.ones(16), torch.ones(16, dtype=torch.bool))
    compact.compact_perm(torch.ones(16, dtype=torch.bool))
    assert (stats.LAUNCHES, compact.LAUNCHES) == before


def test_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing degrades to the plain
    versions. Library names carry the source hash."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("stats")
    p1 = _build.library_path("stats")
    p2 = _build.library_path("compact")
    assert p1.name.startswith("libstats-") and p1 != p2
    assert p1 == _build.library_path("stats")
