"""The rans16 kernels (kernels/rans_encode.py, kernels/rans_decode.py) in
Pallas interpret mode against the NumPy spec (rans.py): per-tile sizes,
region halfwords, final and sync states, and the round trip — across
group widths, alphabets, zero-frequency symbols, multi-tile lanes, sync
points and per-group tables.  Also the one backend selection point, the
compile-cache placement and the per-group histogram."""

import numpy as np
import pytest

from range_coder_rust_tpu import rans, rans_codec
from range_coder_rust_tpu.models.table import table_from_data_pow2


def _draw(shape, a, seed, lo=0, gap=None):
    """Skewed symbols in [lo, a), optionally with an interior gap of
    absent (zero-frequency) symbols."""
    rng = np.random.default_rng(seed)
    vals = np.arange(lo, a)
    if gap is not None:
        vals = vals[(vals < gap[0]) | (vals >= gap[1])]
    p = 1.0 / np.arange(1, vals.size + 1) ** 0.9
    return rng.choice(vals, size=shape, p=p / p.sum()).astype(np.int32)


def _states(pre6, g):
    x8 = np.zeros((g, 8), np.uint8)
    x8[:, :6] = np.frombuffer(pre6, np.uint8).reshape(g, 6)
    return x8.reshape(-1).view("<u8")


def _check_against_spec(data, tables, L, g, sync_tiles=0):
    """Encode through the kernel, compare every payload with the spec,
    decode through the kernel."""
    NG = data.shape[0] // g
    payloads = rans_codec.encode_groups(data, tables, L, sync_tiles, g)
    tile, NT = rans_codec._tile_geometry(L, g)
    for gi in range(NG):
        t = tables[gi] if isinstance(tables, list) else tables
        rows = data[gi * g:(gi + 1) * g]
        states, regions, counts = rans.encode_lanes(rows, t.c, t.cum)
        sizes, pre6, region, sync_t, sync6 = rans_codec._parse_payload(
            payloads[gi], L, g, full=True)
        np.testing.assert_array_equal(
            sizes, counts.reshape(NT, tile).sum(axis=1))
        np.testing.assert_array_equal(
            np.frombuffer(region, "<u2"),
            np.concatenate([r for r in regions if r.size]
                           or [np.zeros(0, np.uint16)]))
        np.testing.assert_array_equal(_states(pre6, g), states)
        n_sync = (NT - 1) // sync_tiles if sync_tiles else 0
        assert sync_t == (sync_tiles if n_sync else 0)
        for j in range(n_sync):
            # the decoder's state before step s = the encoder's state
            # after encoding steps [s, L)
            s = (j + 1) * sync_tiles * tile
            want, _, _ = rans.encode_lanes(rows[:, s:], t.c, t.cum)
            np.testing.assert_array_equal(
                _states(sync6[j * 6 * g:(j + 1) * 6 * g], g), want)
    c = (np.stack([t.c for t in tables]) if isinstance(tables, list)
         else tables.c)
    out = rans_codec.decode_groups(payloads, c, L, g)
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("a", [2, 77, 129, 256, 300, 1023])
@pytest.mark.parametrize("g", [128, 256, 2048])
def test_kernels_match_spec(g, a):
    L = 24
    data = _draw((2 * g, L), a, seed=g + a)
    _check_against_spec(data, table_from_data_pow2(data, a, 16), L, g)


@pytest.mark.parametrize("a,lo,gap", [
    (2, 1, None), (129, 60, None), (300, 5, (100, 250)), (1023, 0, (1, 900))])
def test_kernels_zero_frequency_symbols(a, lo, gap):
    """Leading and interior absent symbols: the decode search must skip
    every zero-width cum interval."""
    g, L = 128, 40
    data = _draw((2 * g, L), a, seed=a, lo=lo, gap=gap)
    t = table_from_data_pow2(data, a, 16)
    assert t.c[0] == 0 or gap is not None
    _check_against_spec(data, t, L, g)


@pytest.mark.parametrize("g", [128, 2048])
def test_kernels_multi_tile(g):
    """Lanes of three container tiles: per-tile sizes sum each tile."""
    L = 3 * rans.tile_steps_for(g)
    data = _draw((g, L), 200, seed=g)
    _check_against_spec(data, table_from_data_pow2(data, 200, 16), L, g)


@pytest.mark.parametrize("sync_tiles", [1, 2])
def test_kernels_sync_states(sync_tiles):
    """Sync sections hold the decoder's lane states at tile boundaries."""
    g = 1024
    L = 5 * rans.tile_steps_for(g)
    data = _draw((2 * g, L), 256, seed=sync_tiles)
    _check_against_spec(data, table_from_data_pow2(data, 256, 16), L, g,
                        sync_tiles=sync_tiles)


@pytest.mark.parametrize("a", [64, 300])
def test_kernels_per_group_tables(a):
    """Each group coded with its own table (the adaptive rans16 mode)."""
    g, L = 256, 32
    data = np.concatenate([
        _draw((g, L), a, seed=1, lo=0, gap=(a // 2, a)),
        _draw((g, L), a, seed=2, lo=a // 3),
        _draw((g, L), a, seed=3),
    ])
    tables = [table_from_data_pow2(data[i * g:(i + 1) * g], a, 16)
              for i in range(3)]
    _check_against_spec(data, tables, L, g)


# ---- the backend selection point ---------------------------------------

def test_backend_cpu_interprets():
    from range_coder_rust_tpu.kernels.backend import interpret_kernels

    assert interpret_kernels() is True      # the suite runs on the CPU
    assert interpret_kernels("cpu") is True


def test_backend_gpu_compiles():
    from range_coder_rust_tpu.kernels.backend import interpret_kernels

    assert interpret_kernels("gpu") is False


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_backend_other_platform_raises(platform):
    from range_coder_rust_tpu.errors import ConfigError
    from range_coder_rust_tpu.kernels.backend import interpret_kernels

    with pytest.raises(ConfigError):
        interpret_kernels(platform)


def test_gpu_never_interprets(monkeypatch):
    """On a GPU backend every codec path hands the kernels
    ``interpret=False``; the kernel calls are stubbed to record it."""
    import jax

    from range_coder_rust_tpu import api

    seen = []

    class Stop(Exception):
        pass

    def record(*a, **kw):
        seen.append(kw["interpret"])
        raise Stop

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(rans_codec, "_encode_device", record)
    monkeypatch.setattr(rans_codec, "_decode_device", record)
    data = _draw(5000, 64, seed=1)
    with pytest.raises(Stop):
        api.encode(data, alphabet=64,
                   config=api.CodecConfig(profile="rans16", block_len=8))
    monkeypatch.undo()
    blob = api.encode(data, alphabet=64,
                      config=api.CodecConfig(profile="rans16", block_len=8))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(rans_codec, "_decode_device", record)
    with pytest.raises(Stop):
        api.decode(blob)
    with pytest.raises(Stop):
        api.decode_range(blob, 10, 5)
    assert seen == [False, False, False]


def test_sharded_rans16_other_platform_raises():
    """The sharded wrappers resolve the mode from the mesh's devices
    through the same selection point."""
    from types import SimpleNamespace

    from range_coder_rust_tpu.errors import ConfigError
    from range_coder_rust_tpu.parallel import make_sharded_rans16

    mesh = SimpleNamespace(devices=np.array(
        [SimpleNamespace(platform="metal")], dtype=object))
    with pytest.raises(ConfigError):
        make_sharded_rans16(mesh, block_len=8, a_count=4)


# ---- compile cache -------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from range_coder_rust_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch):
    import os

    import jax

    from range_coder_rust_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.use_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        ignored = open(os.path.join(root, ".gitignore")).read().split()
        assert ".jax_cache/" in ignored
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---- per-group histogram -------------------------------------------------

@pytest.mark.parametrize("alphabet,n_groups,gs", [
    (2, 1, 1000), (256, 3, 4096), (300, 4, 777), (1023, 2, 5000)])
def test_histogram_groups_matches_bincount(alphabet, n_groups, gs):
    import jax.numpy as jnp

    rng = np.random.default_rng(alphabet)
    data = rng.integers(0, alphabet, size=n_groups * gs)
    dtype = np.uint8 if alphabet <= 256 else np.uint16
    got = np.asarray(rans_codec._histogram_groups(
        jnp.asarray(data.astype(dtype)), alphabet=alphabet,
        n_groups=n_groups))
    want = np.stack([np.bincount(part, minlength=alphabet)
                     for part in data.reshape(n_groups, gs)])
    np.testing.assert_array_equal(got, want)


# ---- on the card ---------------------------------------------------------

@pytest.mark.gpu
def test_compiled_kernels_match_spec_on_gpu():
    """The compiled kernels (not the interpreter) against the spec at the
    default group width; chip_smoke.py runs the same check at 1 GB."""
    from range_coder_rust_tpu.kernels.backend import interpret_kernels

    assert interpret_kernels() is False
    g, L = rans.GROUP_LANES, 96
    data = _draw((2 * g, L), 256, seed=5)
    _check_against_spec(data, table_from_data_pow2(data, 256, 16), L, g)
