"""Sharded codec tests on the virtual 8-device CPU mesh: results identical
to the single-device path, blocks actually distributed, scaling smoke."""

import numpy as np

import jax
import jax.numpy as jnp

from range_coder_rust_tpu.blocks import decode_blocks, default_capacity, encode_blocks
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu.parallel import (
    block_sharding,
    default_mesh,
    make_sharded_codec,
    replicated,
)

RNG = np.random.default_rng(9)


def test_mesh_has_8_devices():
    mesh = default_mesh()
    assert mesh.devices.size == 8


def test_sharded_matches_single_device():
    k, L, B = 12, 256, 16
    data = RNG.integers(0, 64, size=(B, L))
    t = table_from_data_pow2(data, 64, k)
    cap = default_capacity(L, k)
    c, cum = jnp.asarray(t.c), jnp.asarray(t.cum)

    code1, len1 = encode_blocks(jnp.asarray(data), c, cum, k=k, capacity=cap)

    mesh = default_mesh()
    enc, dec = make_sharded_codec(mesh, k=k, block_len=L, capacity=cap)
    syms_sh = jax.device_put(jnp.asarray(data), block_sharding(mesh))
    c_sh = jax.device_put(c, replicated(mesh))
    cum_sh = jax.device_put(cum, replicated(mesh))
    code2, len2 = enc(syms_sh, c_sh, cum_sh)

    assert np.array_equal(np.asarray(code1), np.asarray(code2))
    assert np.array_equal(np.asarray(len1), np.asarray(len2))

    dec2 = dec(code2, c_sh, cum_sh)
    assert np.array_equal(np.asarray(dec2), data)


def test_sharded_outputs_are_distributed():
    k, L, B = 10, 128, 8
    data = RNG.integers(0, 16, size=(B, L))
    t = table_from_data_pow2(data, 16, k)
    cap = default_capacity(L, k)
    mesh = default_mesh()
    enc, _ = make_sharded_codec(mesh, k=k, block_len=L, capacity=cap)
    syms_sh = jax.device_put(jnp.asarray(data), block_sharding(mesh))
    code, lengths = enc(
        syms_sh,
        jax.device_put(jnp.asarray(t.c), replicated(mesh)),
        jax.device_put(jnp.asarray(t.cum), replicated(mesh)),
    )
    # each of the 8 devices holds exactly one block row
    assert len(code.addressable_shards) == 8
    for shard in code.addressable_shards:
        assert shard.data.shape == (1, cap)
    # decode result equals input even through the distributed layout
    dec = decode_blocks(code, jnp.asarray(t.c), jnp.asarray(t.cum), k=k, block_len=L)
    assert np.array_equal(np.asarray(dec), data)


def _regions(buf, counts):
    """Each group's valid region (the right-aligned tail of its buffer)."""
    buf, totals = np.asarray(buf), np.asarray(counts).sum(axis=1)
    return [buf[g, buf.shape[1] - int(n):] for g, n in enumerate(totals)]


def _check_sharded_rans16(data, t_c, G, L, per_group):
    """Sharded encode == single-device encode; groups land on distinct
    devices; sharded decode inverts the container's payloads."""
    from range_coder_rust_tpu import rans_codec
    from range_coder_rust_tpu.models.table import build_table_pow2
    from range_coder_rust_tpu.parallel import make_sharded_rans16

    n_dev = 8
    mesh = default_mesh(jax.devices()[:n_dev])
    NG = data.shape[0] // G
    from range_coder_rust_tpu.kernels.rans_encode import symbol_words

    words = jnp.asarray(symbol_words(t_c) if per_group
                        else symbol_words(t_c)[0])
    cum = rans_codec.decode_tables(t_c)
    tab_sh = block_sharding(mesh) if per_group else replicated(mesh)
    sh = block_sharding(mesh)

    enc, dec = make_sharded_rans16(
        mesh, block_len=L, a_count=t_c.shape[-1], group_lanes=G,
        per_group_tables=per_group)
    buf, counts, hi, lo = enc(jax.device_put(jnp.asarray(data), sh),
                              jax.device_put(words, tab_sh))
    assert len({s.device for s in counts.addressable_shards}) == n_dev

    buf1, counts1, hi1, lo1 = rans_codec._encode_device(
        jnp.asarray(data), words, group_lanes=G, interpret=True)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(counts1))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(hi1))
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(lo1))
    for a, b in zip(_regions(buf, counts), _regions(buf1, counts1)):
        np.testing.assert_array_equal(a, b)

    # container payloads via the unchanged assembly, then sharded decode
    tables = ([build_table_pow2(c.astype(np.uint64), 16) for c in t_c]
              if per_group else build_table_pow2(t_c.astype(np.uint64), 16))
    payloads = rans_codec.encode_groups(data, tables, L, 0, G)
    parsed = [rans_codec._parse_payload(p, L, G) for p in payloads]
    stream, offsets = rans_codec._stage_stream(
        [r for _, _, r in parsed], n_rows=n_dev)
    hi_p, lo_p = rans_codec._states_from6([p6 for _, p6, _ in parsed], G)
    out = dec(*(jax.device_put(jnp.asarray(x), sh)
                for x in (stream, offsets, hi_p, lo_p)),
              jax.device_put(cum, tab_sh))
    np.testing.assert_array_equal(
        np.asarray(out).transpose(0, 2, 1).reshape(NG * G, L), data)


def test_sharded_rans16_matches_single_device():
    """rans16 kernels under shard_map over the 8-device group axis must be
    bit-identical to the single-device kernels (=> byte-identical
    containers); decode must invert them."""
    from range_coder_rust_tpu.models.table import table_from_data_pow2

    G, L, NG = 256, 64, 8  # one group per device
    rng = np.random.default_rng(17)
    data = rng.integers(0, 200, size=(NG * G, L)).astype(np.int32)
    t = table_from_data_pow2(data, 256, 16)
    _check_sharded_rans16(data, t.c, G, L, per_group=False)


def test_sharded_rans16_per_group_tables():
    """Adaptive rans16 sharded: each device carries its own group AND its
    own table (tables ride the group axis); outputs bit-match the
    single-device per-group pipeline."""
    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu import rans_codec
    from range_coder_rust_tpu.models.table import table_from_data_pow2

    G, L, NG = 256, 64, 8
    rng = np.random.default_rng(23)
    # a different distribution per group
    data = np.concatenate([
        ((g * 13) + rng.integers(0, 40, G * L)) % 256
        for g in range(NG)
    ]).astype(np.int32).reshape(NG * G, L)
    tables = [table_from_data_pow2(data[g * G:(g + 1) * G], 256, 16)
              for g in range(NG)]
    _check_sharded_rans16(data, np.stack([t.c for t in tables]), G, L,
                          per_group=True)

    # full adaptive container path round-trips the same data
    blob = rans_codec.encode(
        data.reshape(-1), alphabet=256, block_len=L, per_group_tables=True)
    np.testing.assert_array_equal(
        rans_codec.decode(fmt.unpack(blob)), data.reshape(-1))
