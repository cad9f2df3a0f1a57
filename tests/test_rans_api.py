"""End-to-end api.encode/decode round trips for the rans16 profile."""

import numpy as np
import pytest

from range_coder_rust_tpu import api, format as fmt
from range_coder_rust_tpu.errors import ChecksumMismatch, ConfigError


def _zipf(n, a=256, seed=3):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, a + 1)
    p = 1.0 / ranks**1.2
    p /= p.sum()
    return rng.choice(a, size=n, p=p).astype(np.int32)


CFG = api.CodecConfig(profile="rans16", block_len=64)


def test_rans16_roundtrip_exact_multiple():
    data = _zipf(1024 * 64)  # exactly one group
    blob = api.encode(data, config=CFG)
    cont = fmt.unpack(blob)
    from range_coder_rust_tpu import rans
    assert cont.profile == "rans16" and cont.group_lanes == rans.GROUP_LANES
    out = api.decode(blob)
    np.testing.assert_array_equal(out, data)


def test_rans16_roundtrip_partial_group():
    data = _zipf(1024 * 64 + 777, seed=5)  # 2 groups, second mostly pad
    blob = api.encode(data, config=CFG)
    out = api.decode(blob)
    np.testing.assert_array_equal(out, data)


def test_rans16_checksum_detects_corruption():
    data = _zipf(1024 * 64, seed=6)
    blob = bytearray(api.encode(data, config=CFG))
    blob[-3] ^= 0x40  # flip a bit in the last payload
    with pytest.raises(ChecksumMismatch):
        api.decode(bytes(blob))


def test_rans16_requires_k16():
    with pytest.raises(ConfigError):
        api.CodecConfig(profile="rans16", k=12)
    with pytest.raises(ConfigError):
        api.CodecConfig(profile="nope")


def test_rans16_long_lane_single_call_matches_spec():
    """Long lanes (many tiles) run in ONE kernel invocation; the payload's
    region stream must equal the NumPy spec's one-pass encode and the
    per-tile sizes must partition it exactly at tile boundaries."""
    from range_coder_rust_tpu import rans, rans_codec
    from range_coder_rust_tpu.models.table import table_from_data_pow2

    G = rans.GROUP_LANES
    L = 4 * rans_codec.TILE_STEPS
    data = _zipf(G * L, seed=9).reshape(G, L)
    t = table_from_data_pow2(data, 256, 16)

    payloads = rans_codec.encode_groups(data, t, L)
    assert len(payloads) == 1
    sizes, pre6, region = rans_codec._parse_payload(payloads[0], L)
    assert len(sizes) == 4

    # oracle: the NumPy spec over the full lanes in one pass
    states, sregions, counts = rans.encode_lanes(data, t.c, t.cum)
    x8 = np.zeros((G, 8), np.uint8)
    x8[:, :6] = np.frombuffer(pre6, np.uint8).reshape(G, 6)
    np.testing.assert_array_equal(x8.reshape(-1).view("<u8"), states)
    spec_regions = b"".join(r.astype("<u2").tobytes() for r in sregions)
    assert bytes(region) == spec_regions
    # tile boundaries: sizes[t] = halfwords of the t-th TILE_STEPS window
    np.testing.assert_array_equal(
        sizes, counts.reshape(4, rans_codec.TILE_STEPS).sum(axis=1))

    rows = rans_codec.decode_groups(payloads, t.c, L)
    np.testing.assert_array_equal(rows, data)


def test_rans16_shrink_lane_len_small_inputs():
    """Tiny inputs must not be padded to the full requested lane length."""
    from range_coder_rust_tpu import rans_codec

    data = _zipf(5000, seed=11)
    cfg = api.CodecConfig(profile="rans16", block_len=4096)
    blob = api.encode(data, config=cfg)
    cont = fmt.unpack(blob)
    assert cont.block_len <= 64  # shrunk: 5000 symbols need 5-step lanes
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_absent_leading_symbol():
    """Tables with zero-frequency leading symbols (c[0] == 0) must decode
    correctly — the packed-search probe ``cum[j+1]-1`` underflowed for
    absent symbol 0 and silently decoded wrong symbols (round-2 advisor,
    high severity)."""
    rng = np.random.default_rng(11)
    data = rng.integers(1, 8, 1024 * 64).astype(np.int32)  # symbol 0 absent
    blob = api.encode(data, alphabet=8, config=CFG)
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_absent_leading_run_and_interior():
    """Several leading absent symbols plus interior holes; the most
    frequent present symbol sits at cum == 0 so slot == 0 occurs often."""
    rng = np.random.default_rng(12)
    support = np.array([3, 5, 9, 200])  # absent: 0,1,2,4,6,7,8,...
    p = np.array([0.7, 0.2, 0.06, 0.04])
    data = rng.choice(support, size=1024 * 64, p=p).astype(np.int32)
    blob = api.encode(data, alphabet=256, config=CFG)
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_per_group_tables_adaptive():
    """Adaptive rans16: per-group order-0 tables (two-pass device
    histogram + the same kernels with group-indexed table blocks) must
    round-trip, beat the shared table on heterogeneous data, and keep
    random access working across group boundaries."""
    from range_coder_rust_tpu import rans

    rng = np.random.default_rng(5)
    G = rans.GROUP_LANES
    L = 128
    zipf = (lambda p: p / p.sum())(1 / np.arange(1, 65) ** 1.5)
    flat = (lambda p: p / p.sum())(1 / np.arange(1, 65) ** 0.5)
    g1 = rng.choice(64, size=G * L, p=zipf).astype(np.int32)
    g2 = (128 + rng.choice(64, size=G * L, p=flat)).astype(np.int32)
    data = np.concatenate([g1, g2])

    cfg_a = api.CodecConfig(profile="rans16", block_len=L,
                            per_group_tables=True)
    blob_a = api.encode(data, alphabet=256, config=cfg_a)
    blob_s = api.encode(data, alphabet=256,
                        config=api.CodecConfig(profile="rans16", block_len=L))
    cont = fmt.unpack(blob_a)
    assert cont.per_block_tables and cont.tables_c.shape == (2, 256)
    np.testing.assert_array_equal(api.decode(blob_a), data)
    assert len(blob_a) < len(blob_s), "per-group tables must win here"
    got = api.decode_range(blob_a, G * L - 500, 1000)
    np.testing.assert_array_equal(got, data[G * L - 500: G * L + 500])


def test_rans16_per_group_tables_requires_rans16():
    from range_coder_rust_tpu.errors import ConfigError

    with pytest.raises(ConfigError):
        api.CodecConfig(profile="planar", per_group_tables=True)


@pytest.mark.parametrize("lo", [26, 39, 91, 213])
def test_rans16_shifted_support(lo):
    """Supports starting above 16 absent symbols: the slot==0 repair can
    land OUTSIDE the parallel count round's fetched word window, so its
    c value must come from the dedicated probe (round-3 regression — the
    windowed extraction read garbage and ~36% of symbols decoded wrong)."""
    rng = np.random.default_rng(lo)
    data = ((lo + rng.integers(0, 40, 1024 * 64)) % 256).astype(np.int32)
    blob = api.encode(data, alphabet=256, config=CFG)
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_wide_alphabet_api():
    """Alphabets above 256 take the generic search path end-to-end
    through the api (device histogram, u16 output finalize)."""
    rng = np.random.default_rng(31)
    data = rng.integers(0, 300, 1024 * 64 + 123).astype(np.int32)
    blob = api.encode(data, alphabet=300, config=CFG)
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_wide_alphabet_falls_back_to_planar():
    """Alphabets beyond the rans16 search-table limit (1024) must not
    surface a raw kernel error: api.encode falls back to planar
    (VERDICT r3 item 7) and a direct rans_codec.encode raises a typed
    ConfigError with guidance."""
    from range_coder_rust_tpu import rans_codec
    from range_coder_rust_tpu.errors import ConfigError

    rng = np.random.default_rng(11)
    data = rng.integers(0, 4096, size=20_000).astype(np.int32)
    cfg = api.CodecConfig(profile="rans16")
    blob = api.encode(data, alphabet=4096, config=cfg)
    cont = fmt.unpack(blob)
    assert cont.profile == "planar"
    np.testing.assert_array_equal(api.decode(blob), data)

    with pytest.raises(ConfigError, match="1023"):
        rans_codec.encode(data, alphabet=4096, block_len=64)
    with pytest.raises(ConfigError, match="per_group_tables"):
        api.encode(data, alphabet=4096,
                   config=api.CodecConfig(profile="rans16",
                                          per_group_tables=True))


def test_rans16_narrow_group_lanes():
    """group_lanes=1024 containers encode, round-trip and interoperate
    with the width-generic decoder (the adaptive mode's size knob: half
    the per-symbol lane-state overhead at a fixed group size)."""
    rng = np.random.default_rng(21)
    data = rng.integers(0, 200, size=1024 * 96 + 777).astype(np.int32)
    cfg = api.CodecConfig(profile="rans16", block_len=64, group_lanes=1024)
    blob = api.encode(data, alphabet=256, config=cfg)
    cont = fmt.unpack(blob)
    assert cont.group_lanes == 1024
    np.testing.assert_array_equal(api.decode(blob), data)

    # adaptive + narrow groups
    cfg_a = api.CodecConfig(profile="rans16", block_len=64,
                            group_lanes=1024, per_group_tables=True)
    blob_a = api.encode(data, alphabet=256, config=cfg_a)
    np.testing.assert_array_equal(api.decode(blob_a), data)


def test_rans16_many_batches_pipeline(monkeypatch):
    """> 2 device batches exercise the double-buffered pipeline's steady
    state (a round-4 bug only fired from batch 3 on: the payload loop
    shadowed the group-width variable)."""
    from range_coder_rust_tpu import rans, rans_codec

    G = rans.GROUP_LANES
    L = 16
    monkeypatch.setattr(rans_codec, "_BATCH_SYMBOLS", G * L)  # 1 group/batch
    data = _zipf(5 * G * L + 321, seed=31)  # 6 groups -> 6 batches
    cfg = api.CodecConfig(profile="rans16", block_len=L)
    blob = api.encode(data, alphabet=256, config=cfg)
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_adaptive_odd_block_len_narrow_groups():
    """Adaptive mode with a non-pow2 block_len and narrow groups: the
    grouped histogram's chunk size must DIVIDE the group size (advisor
    r4 — the old formula crashed for group_lanes*block_len % 2048 != 0)."""
    from range_coder_rust_tpu import rans_codec

    rng = np.random.default_rng(17)
    data = rng.integers(0, 64, size=2 * 1024 * 33).astype(np.int32)
    blob = rans_codec.encode(
        data, alphabet=64, block_len=33, per_group_tables=True,
        group_lanes=1024)
    np.testing.assert_array_equal(api.decode(blob), data)


def test_rans16_alphabet_1024_falls_back():
    """Alphabet exactly 1024 exceeds the kernel tables' A+1 <= 1024 capacity
    and must fall back to planar like any wider alphabet (advisor r4:
    the a > 1024 check was off by one)."""
    rng = np.random.default_rng(19)
    data = rng.integers(0, 1024, size=30_000).astype(np.int32)
    blob = api.encode(data, alphabet=1024,
                      config=api.CodecConfig(profile="rans16"))
    assert fmt.unpack(blob).profile == "planar"
    np.testing.assert_array_equal(api.decode(blob), data)
    # and with group_lanes set, the fallback must still not trip the
    # planar config validation
    blob = api.encode(data, alphabet=1024,
                      config=api.CodecConfig(profile="rans16",
                                             group_lanes=1024))
    np.testing.assert_array_equal(api.decode(blob), data)
