"""Spec tests for the rans16 profile (range_coder_rust_tpu.rans)."""

import numpy as np
import pytest

from range_coder_rust_tpu import rans
from range_coder_rust_tpu.models.table import build_table_pow2, table_from_data_pow2


def _zipf(n, a=256, seed=3, alpha=1.2):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, a + 1)
    p = 1.0 / ranks**alpha
    p /= p.sum()
    return rng.choice(a, size=n, p=p).astype(np.int32)


@pytest.mark.parametrize("B,L,a", [(16, 64, 10), (64, 256, 256), (1024, 32, 2)])
def test_roundtrip(B, L, a):
    rng = np.random.default_rng(B + L)
    syms = rng.integers(0, a, size=(B, L)).astype(np.int32)
    t = table_from_data_pow2(syms, a, 16)
    stream, dec = rans.roundtrip_group(syms, t.c, t.cum)
    assert np.array_equal(dec, syms)


def test_roundtrip_skewed_and_degenerate():
    # all-same-symbol input: c[pad] = 2^16 (the c == total edge case)
    syms = np.zeros((8, 128), np.int32)
    t = build_table_pow2(np.array([1000]), 16)
    stream, dec = rans.roundtrip_group(syms, t.c, t.cum)
    assert np.array_equal(dec, syms)
    # region section must be empty: a certain symbol carries zero bits
    assert len(stream) == 8 * 8

    # extremely skewed table with rare symbols present
    data = np.concatenate([np.zeros(10000, np.int32), np.arange(64)])
    np.random.default_rng(0).shuffle(data)
    syms = data[: 64 * 128].reshape(64, 128)
    t = table_from_data_pow2(syms, 64, 16)
    _, dec = rans.roundtrip_group(syms, t.c, t.cum)
    assert np.array_equal(dec, syms)


def test_rate_near_entropy():
    n = 1 << 20
    data = _zipf(n)
    t = table_from_data_pow2(data.reshape(1, -1), 256, 16)
    syms = data.reshape(rans.GROUP_LANES, -1)
    stream, dec = rans.roundtrip_group(syms, t.c, t.cum)
    assert np.array_equal(dec, syms)
    counts = np.bincount(data, minlength=256)
    h_q = float(
        (counts * np.log2(65536.0 / np.maximum(t.c, 1))).sum() / n
    )  # table cross-entropy in bits/sym
    total_bits = 8 * len(stream) / n
    pre_bits = 8 * 8 * rans.GROUP_LANES / n
    # the whole stream (body + state preamble) can't beat the entropy bound,
    # and the 16-bit renorm loss on top of it must be tiny (< 0.2%)
    assert total_bits >= h_q - 1e-3
    assert total_bits <= h_q * 1.002 + pre_bits


def test_stream_layout_split_inverse():
    syms = _zipf(32 * 64).reshape(32, 64)
    t = table_from_data_pow2(syms, 256, 16)
    states, regions, counts = rans.encode_lanes(syms, t.c, t.cum)
    stream = rans.build_group_stream(states, regions, counts)
    st2, hw = split = rans.split_group_stream(stream, 32)
    assert np.array_equal(st2, states)
    assert hw.size == int(counts.sum())
    # region t occupies hw[prefix[t] : prefix[t] + counts[t]]
    off = 0
    for t_i in range(64):
        got = hw[off : off + counts[t_i]]
        assert np.array_equal(got, regions[t_i])
        off += counts[t_i]


def test_batch_table_builders_match_scalar():
    """The kernels' batched table builders (symbol_words, cum_rows) must
    equal their one-table results row by row and unpack to the exact
    counts — including the c > 2^15 band and c == 2^16 single-symbol
    tables (packed as c - 1 in 16 bits)."""
    import numpy as np

    from range_coder_rust_tpu.kernels.rans_decode import cum_rows
    from range_coder_rust_tpu.kernels.rans_encode import symbol_words
    from range_coder_rust_tpu.models.table import build_table_pow2

    rng = np.random.default_rng(3)
    tables = []
    for a in (2, 64, 256):
        counts = rng.integers(1, 1000, a).astype(np.uint64)
        tables.append(build_table_pow2(counts, 16).c)
    tables.append(np.array([1 << 16], np.uint32))            # c == 2^16
    tables.append(np.array([40000, 25536], np.uint32))       # c > 2^15
    for c in tables:
        a = c.shape[0]
        cum = np.concatenate([[0], np.cumsum(c)]).astype(np.uint32)
        w = symbol_words(c)[0]
        np.testing.assert_array_equal(w[:a] & 0xFFFF, cum[:a])
        np.testing.assert_array_equal((w[:a] >> 16) + 1, c)
        both = np.stack([c, c[::-1]])
        np.testing.assert_array_equal(symbol_words(both)[0], w)
        np.testing.assert_array_equal(
            symbol_words(both)[1], symbol_words(c[::-1])[0])
        rows = cum_rows(both)
        np.testing.assert_array_equal(rows[0, : a + 1], cum)
        assert np.all(rows[:, a:] == 1 << 16)
