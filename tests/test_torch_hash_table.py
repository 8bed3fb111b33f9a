"""The join half of the port's hash table (blaze_tpu_torch/ops/
hash_table.py) against the JAX package's functions on the same numpy
inputs, on the CPU, bit for bit: the tables `insert_kr`, `insert_direct`
and `insert` build, their `dup` flags, and the `match_idx` that
`lookup_kr`, `lookup_direct` and `lookup` return.

The port's fused key|row entries are int64 `key32 << 31 | row` where the
JAX package's are uint64 `key32 << 32 | row` (torch's `amin` scatter
takes no uint64): the tables are compared entry by entry as (key, row)
pairs, EMPTY against EMPTY. Inputs hold repeated keys, NULL keys, dead
rows, -0.0 and NaN of several payloads, and tables small enough for
long probe chains.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blaze_tpu.ops import hash_table as jht

from blaze_tpu_torch.ops import hash_table as ht

CAP = 512


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys(rng, dtype, n, distinct):
    if dtype == np.float32:
        k = rng.integers(0, distinct, n).astype(np.float32) / 4
        nans = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001],
                        np.uint32).view(np.float32)
        k[rng.integers(0, n, 12)] = nans[rng.integers(0, 4, 12)]
        k[rng.integers(0, n, 6)] = -0.0
        k[rng.integers(0, n, 6)] = 0.0
        return k
    return rng.integers(-distinct, distinct, n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.float32,
                                   np.bool_])
def test_key_u32_bit_exact(dtype):
    rng = np.random.default_rng(1)
    k = (rng.random(CAP) < 0.5) if dtype == np.bool_ \
        else _keys(rng, dtype, CAP, 100)
    got = ht.key_u32(_t(k), None).numpy()
    exp = np.asarray(jht.key_u32(jnp.asarray(k), None)).astype(np.int64)
    np.testing.assert_array_equal(got, exp)
    assert ht.key_u32(torch.zeros(4, dtype=torch.float64), None) is None
    assert ht.key_u32(torch.zeros(4, dtype=torch.int64), None) is None


def test_table_sizes_match():
    for n in (0, 1, 511, 512, 513, 4096, 131_072, 1 << 21, 5 << 20):
        assert ht.probe_table_size(n) == jht.probe_table_size(n)
        assert ht.direct_table_size(n) == jht.direct_table_size(n)


def _kr_pairs(tab, shift):
    """(key, row) of every entry; EMPTY as (-1, -1)."""
    tab = np.asarray(tab).astype(np.uint64)
    empty = np.uint64(0x7FFFFFFFFFFFFFFF) if shift == 31 \
        else np.uint64(0xFFFFFFFFFFFFFFFF)
    key = (tab >> np.uint64(shift)).astype(np.int64)
    row = (tab & np.uint64((1 << shift) - 1)).astype(np.int64)
    key[tab == empty] = -1
    row[tab == empty] = -1
    return key, row


@pytest.mark.parametrize("dtype,distinct,tsize", [
    (np.int16, 400, 1024),   # some repeated keys, roomy table
    (np.float32, 4000, 512),  # full table: long probe chains
])
def test_insert_kr_and_lookup_kr_bit_exact(dtype, distinct, tsize):
    rng = np.random.default_rng(2)
    n = min(CAP, tsize // 2)
    k = _keys(rng, dtype, n, distinct)
    live = rng.random(n) < 0.9
    pk = np.concatenate([k[rng.integers(0, n, 300)],
                         _keys(rng, dtype, 300, distinct * 2)])
    plive = rng.random(len(pk)) < 0.9

    jk32 = jht.key_u32(jnp.asarray(k), None)
    jh = jht.cheap_hash([(jnp.asarray(k), None)], n)
    jtab, jdup = jht.insert_kr(jk32, jh, jnp.asarray(live), n, tsize)
    k32 = ht.key_u32(_t(k), None)
    h = ht.cheap_hash([(_t(k), None)], n)
    tab, dup = ht.insert_kr(k32, h, _t(live), n, tsize)
    for a, b in zip(_kr_pairs(tab.numpy(), 31), _kr_pairs(jtab, 32)):
        np.testing.assert_array_equal(a, b)
    assert bool(dup) == bool(jdup)

    jm, jok = jht.lookup_kr(jtab, jht.key_u32(jnp.asarray(pk), None),
                            jht.cheap_hash([(jnp.asarray(pk), None)],
                                           len(pk)), jnp.asarray(plive))
    m, ok = ht.lookup_kr(tab, ht.key_u32(_t(pk), None),
                         ht.cheap_hash([(_t(pk), None)], len(pk)),
                         _t(plive))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("dtype,unique", [(np.int16, True),
                                          (np.int64, False)])
def test_insert_direct_and_lookup_direct_bit_exact(dtype, unique):
    rng = np.random.default_rng(3)
    n = 400
    k = (rng.permutation(n) if unique else rng.integers(0, 300, n)) \
        .astype(dtype) - 50
    live = rng.random(n) < 0.9
    base, span = int(k[live].min()), int(k[live].max() - k[live].min() + 1)
    tsize = ht.direct_table_size(span)
    pk = rng.integers(-80, 420, 700).astype(dtype)
    plive = rng.random(700) < 0.9

    jtab, jdup = jht.insert_direct(jnp.asarray(k), jnp.asarray(live), n,
                                   jnp.asarray(base, jnp.int64), tsize)
    tab, dup = ht.insert_direct(_t(k), _t(live), n, base, tsize)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    assert bool(dup) == bool(jdup) == (not unique)

    jm, jok = jht.lookup_direct(jtab, jnp.asarray(base, jnp.int64),
                                jnp.asarray(span, jnp.int64),
                                jnp.asarray(pk), jnp.asarray(plive))
    m, ok = ht.lookup_direct(tab, base, span, _t(pk), _t(plive))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("nulls", [True])
def test_insert_and_lookup_generic_bit_exact(nulls):
    """Two keys (int64 and float64) with NULLs: the generic row table
    of a join (null_equal=False) and its lookup, as the join uses them."""
    rng = np.random.default_rng(4)
    n = 300
    a = rng.integers(0, 40, n).astype(np.int64)
    x = (rng.integers(0, 10, n) / 2).astype(np.float64)
    x[:3] = [np.nan, -0.0, 0.0]
    am = (rng.random(n) < 0.85) if nulls else None
    xm = (rng.random(n) < 0.85) if nulls else None
    live = rng.random(n) < 0.95
    if nulls:
        live = live & am & xm
    pn = 500
    sel = rng.integers(0, n, pn)
    pa_, px = a[sel].copy(), x[sel].copy()
    pa_[::7] = 99
    pam = (rng.random(pn) < 0.85) if nulls else None
    pxm = None
    plive = rng.random(pn) < 0.95
    if nulls:
        plive = plive & pam
    tsize = 1024

    def jcols(*cols):
        return [(jnp.asarray(v), None if m is None else jnp.asarray(m))
                for v, m in cols]

    def tcols(*cols):
        return [(_t(v), None if m is None else _t(m)) for v, m in cols]

    jb, tb = jcols((a, am), (x, xm)), tcols((a, am), (x, xm))
    jp, tp = jcols((pa_, pam), (px, pxm)), tcols((pa_, pam), (px, pxm))
    jslot, jtab, jdup, _ = jht.insert(jht.cheap_hash(jb, n), jb,
                                      jnp.asarray(live), n, tsize, False)
    slot, tab, dup, ovf = ht.insert(ht.cheap_hash(tb, n), tb, _t(live), n,
                                    tsize, False)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    assert bool(dup) == bool(jdup) and not bool(ovf)
    np.testing.assert_array_equal(slot.numpy()[live],
                                  np.asarray(jslot)[live])

    jm, jok = jht.lookup(jtab, jht.cheap_hash(jp, pn), jp, jb,
                         jnp.asarray(plive), n)
    m, ok = ht.lookup(tab, ht.cheap_hash(tp, pn), tp, tb, _t(plive), n)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.any()


def test_insert_kr_refuses_rows_past_its_encoding():
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="at most"):
        ht.insert_kr(k, k, torch.ones(4, dtype=torch.bool),
                     ht.KR_MAX_ROWS + 1, 1024)
