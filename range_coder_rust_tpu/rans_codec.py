"""Host orchestration for the rans16 profile: array <-> container.

The device kernels (kernels/rans_encode.py, kernels/rans_decode.py) run one
program per group of ``G`` lanes; this module chooses geometry, batches
groups into bounded device calls, and assembles/parses the container
(format.py, FLAG_RANS16, container VERSION 2).

Symbol order contract: lane ``l`` of group ``g`` encodes the flat segment
``[(g * G + l) * L, (g * G + l + 1) * L)`` — i.e. ``reshape(NG * G, L)``
row-major, exactly like the planar profile's blocks.

Per-group payload layout (container VERSION 2):

    u32 NT | u32 region_hw[NT] (time order) | preamble (6 * G bytes,
    lane l's final state as 48-bit LE at [6l, 6l+6)) | regions 0..NT-1

With sync points (bit 31 of the NT word set — tile random access,
``sync_tiles``):

    u32 NT|1<<31 | u32 sync_T | u32 region_hw[NT] | preamble |
    sync states (floor((NT-1)/sync_T) x 6*G bytes, the decoder's lane
    states before time-tiles sync_T, 2*sync_T, ...) | regions 0..NT-1

A tile is ``rans.tile_steps_for(G)`` steps; region ``t`` holds the
halfwords the decoder refills during tile ``t``, so the regions together
are the group's whole halfword stream in decode order.  The 48-bit states
are exact — they live in [2^32, 2^48).  The group width G comes from the
container header, the tile count NT from the payload itself — both
self-describing.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import format as fmt
from . import rans
from .errors import ConfigError, InvalidHeader
from .kernels.backend import interpret_kernels
from .kernels.rans_decode import cum_rows, rans_decode
from .kernels.rans_encode import rans_encode, symbol_words
from .models.table import Pow2Table

G = rans.GROUP_LANES
#: encoder-side steps per tile for the default group width; decode derives
#: the tile size from each container's payload NT, so containers written
#: with other group widths still decode
TILE_STEPS = rans.tile_steps_for(G)

#: symbols per device call; None derives it from the device's memory
#: (:func:`_batch_symbols`).  Tests set it to force many batches.
_BATCH_SYMBOLS = None

#: device bytes a call holds per symbol, with headroom for the next call
#: already in flight: encode keeps the input, its step-major copy, the
#: 2-byte emission buffer and the compacted stream (about 5 B/symbol for
#: bytes); decode the stream, the step-major symbols and their transpose
_BYTES_PER_SYMBOL = 16


def _batch_symbols() -> int:
    """Symbols per device call: the device's memory limit over
    _BYTES_PER_SYMBOL, capped at 2^30 (the kernels index one call's
    buffers with int32).  Devices that report no limit (the CPU) get
    2^27."""
    if _BATCH_SYMBOLS:
        return _BATCH_SYMBOLS
    # this process's own card: in a multi-process run jax.devices()[0]
    # can belong to another process
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit", 0)
    if not limit:
        return 1 << 27
    return int(min(1 << 30, max(1 << 24, limit // _BYTES_PER_SYMBOL)))


def _groups_per_call(L: int, group_lanes: int = None) -> int:
    g = group_lanes if group_lanes else G
    return max(1, _batch_symbols() // (g * L))


def _narrow_dtype(a_count: int):
    """The narrowest output dtype for the alphabet (rans16: A <= 1023)."""
    return np.uint8 if a_count <= 256 else np.uint16


@functools.partial(jax.jit, static_argnames=(
    "group_lanes", "sync_every", "interpret"))
def _encode_device(rows, words, *, group_lanes, sync_every=0, interpret):
    """(NG*G, L) symbol rows (any int dtype) -> rans_encode outputs."""
    B, L = rows.shape
    sym = jnp.transpose(rows.reshape(B // group_lanes, group_lanes, L),
                        (0, 2, 1))
    return rans_encode(sym, words, sync_every=sync_every,
                       interpret=interpret)


@functools.partial(jax.jit, static_argnames=("out_len",))
def _compact(buf, totals, *, out_len):
    """Right-aligned per-group regions (rans_encode's buf) -> one flat
    stream of every group's section in group order, padded to
    ``out_len`` halfwords (a bucketed static size)."""
    NG, cap = buf.shape
    ends = jnp.cumsum(totals)
    # group of output halfword i: the number of group ends at or before i
    gi = jnp.cumsum(jnp.zeros(out_len, jnp.int32).at[ends[:-1]].add(
        1, mode="drop"))
    gi = jnp.minimum(gi, NG - 1)
    src = gi * cap + cap - ends[gi] + jnp.arange(out_len, dtype=jnp.int32)
    return buf.reshape(-1)[jnp.clip(src, 0, NG * cap - 1)]


def _bucket(n: int) -> int:
    """Round up to one of few sizes (limits recompiles; <= 1/16 waste)."""
    q = 1 << max(12, n.bit_length() - 4)
    return -(-max(n, 1) // q) * q


@functools.partial(jax.jit, static_argnames=("alphabet", "n_groups"))
def _histogram_groups(data, *, alphabet, n_groups):
    """Per-group order-0 histograms on device: (n_groups * gs,) symbols ->
    (n_groups, alphabet) int32 counts, one int32 scatter-add."""
    gid = jnp.arange(data.size, dtype=jnp.int32) // (data.size // n_groups)
    flat = jnp.zeros(n_groups * alphabet, jnp.int32).at[
        gid * alphabet + data.astype(jnp.int32)].add(1)
    return flat.reshape(n_groups, alphabet)


@functools.partial(jax.jit, static_argnames=("rows", "length"))
def _pad_rows_device(data, pad_sym, *, rows, length):
    """Flat device array -> (rows, length) padded with ``pad_sym``."""
    pad = rows * length - data.size
    full = jnp.concatenate(
        [data, jnp.full((pad,), pad_sym, data.dtype)])
    return full.reshape(rows, length)


def _states6(hi: np.ndarray, lo: np.ndarray) -> bytes:
    """(..., G) u32 state limbs -> 6-byte LE per lane."""
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return x.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6].tobytes()


def _states_from6(states6_list, g: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group 6-byte LE lane states -> (nb, g) u32 (hi, lo)."""
    nb = len(states6_list)
    x8 = np.zeros((nb, g, 8), np.uint8)
    for gi, s6 in enumerate(states6_list):
        x8[gi, :, :6] = np.frombuffer(s6, np.uint8).reshape(g, 6)
    x = x8.reshape(nb, g * 8).view("<u8")
    return (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)


def _tile_geometry(block_len: int, group_lanes: int = None
                   ) -> Tuple[int, int]:
    """(tile_steps, n_tiles) for a lane length and group width."""
    ts = rans.tile_steps_for(group_lanes if group_lanes else G)
    tile = min(ts, block_len)
    if block_len % tile:
        raise ConfigError(
            f"rans16 block_len {block_len} must be <= {ts} or a "
            f"multiple of it")
    return tile, block_len // tile


def encode_groups(
    symbols, table, block_len: int, sync_tiles: int = 0,
    group_lanes: int = None
) -> List[bytes]:
    """Encode (NG*g, L) padded symbol rows into per-group payload bytes.

    ``symbols``: a host or device array.  ``table``: one shared
    Pow2Table, or a LIST of NG tables (one per group — the adaptive
    rans16 mode).  ``sync_tiles=T > 0`` records each group's lane states
    every T tiles (6 B/lane/sync) so :func:`decode_tile_range` can start
    decoding mid-group — tile-level random access.  ``group_lanes``
    narrows/widens the group (a power of two >= 128)."""
    g = group_lanes if group_lanes else G
    n_rows, L = symbols.shape
    if L != block_len or n_rows % g:
        raise ConfigError(f"bad group geometry ({n_rows}, {L})")
    NG = n_rows // g
    tile, NT = _tile_geometry(L, g)
    if not isinstance(table, Pow2Table):  # a LIST of per-group tables
        if len(table) != NG:
            raise ConfigError(f"{len(table)} tables for {NG} groups")
        words = jnp.asarray(symbol_words(np.stack([t.c for t in table])))
    else:
        words = jnp.asarray(symbol_words(table.c)[0])
    interp = interpret_kernels()

    n_sync = (NT - 1) // sync_tiles if sync_tiles > 0 else 0
    sync_every = sync_tiles * tile if n_sync else 0
    gpc = _groups_per_call(L, g)
    bounds_all = [(s, min(s + gpc, NG)) for s in range(0, NG, gpc)]
    hdr_nt = np.uint32(NT | (_SYNC_FLAG if n_sync else 0)).tobytes()
    if n_sync:
        hdr_nt += np.uint32(sync_tiles).tobytes()

    def dispatch(start, stop):
        """Dispatch one batch's upload + encode (all async)."""
        return _encode_device(
            jnp.asarray(symbols[start * g : stop * g]),
            words if words.ndim == 1 else words[start:stop],
            group_lanes=g, sync_every=sync_every, interpret=interp)

    # double-buffered: batch i+1's upload + kernel are in flight while
    # batch i's counts and stream come back
    payloads: List[bytes] = []
    inflight = dispatch(*bounds_all[0])
    for bi, (start, stop) in enumerate(bounds_all):
        buf, counts, hi, lo, *syncs = inflight
        if bi + 1 < len(bounds_all):
            inflight = dispatch(*bounds_all[bi + 1])
        counts_np = np.asarray(counts)                  # (nb, L)
        totals = counts_np.sum(axis=1)
        total = int(totals.sum())
        region_hw = np.asarray(_compact(
            buf, jnp.asarray(totals.astype(np.int32)),
            out_len=_bucket(total)))[:total]
        sizes = counts_np.reshape(stop - start, NT, tile).sum(axis=2)
        hi_np, lo_np = np.asarray(hi), np.asarray(lo)
        if n_sync:
            sync_hi, sync_lo = (np.asarray(s) for s in syncs)
        bounds = np.concatenate([[0], np.cumsum(totals)])
        for bg in range(stop - start):  # must not shadow the width ``g``
            payloads.append(
                hdr_nt
                + sizes[bg].astype("<u4").tobytes()
                + _states6(hi_np[bg], lo_np[bg])
                + (_states6(sync_hi[bg], sync_lo[bg]) if n_sync else b"")
                + region_hw[bounds[bg] : bounds[bg + 1]].tobytes()
            )
    return payloads


#: payload NT-word flag: sync-point section present (tile random access)
_SYNC_FLAG = 1 << 31


def _parse_payload(p, block_len: int, group_lanes: int = None,
                   full: bool = False):
    """One group payload -> (sizes (NT,) int64, pre6 bytes, region bytes);
    with ``full=True`` additionally ``(sync_T, sync6 bytes)`` (sync_T = 0
    when the payload has no sync section).

    The tile size is DERIVED from the payload's own NT (tile = L / NT),
    so containers written by encoders with other group widths or tile
    defaults parse and decode — the format is self-describing."""
    g = group_lanes if group_lanes else G
    p = memoryview(p)
    if len(p) < 4:
        raise InvalidHeader("rans16 payload too short")
    nt_word = int(np.frombuffer(p[:4], "<u4")[0])
    nt = nt_word & ~_SYNC_FLAG
    has_sync = bool(nt_word & _SYNC_FLAG)
    if nt < 1 or block_len % nt:
        raise InvalidHeader(
            f"rans16 payload has {nt} tiles for lane length {block_len}")
    tile = block_len // nt
    off = 4
    sync_t = 0
    if has_sync:
        if len(p) < 8:
            raise InvalidHeader("rans16 payload too short for sync header")
        sync_t = int(np.frombuffer(p[4:8], "<u4")[0])
        if sync_t < 1:
            raise InvalidHeader("rans16 sync period must be >= 1")
        off = 8
    head = off + 4 * nt
    if len(p) < head:  # np.frombuffer on a short/unaligned slice raises
        raise InvalidHeader("rans16 payload truncated in the size table")
    sizes = np.frombuffer(p[off:head], "<u4").astype(np.int64)
    if np.any(sizes > tile * g):
        raise InvalidHeader("rans16 tile size exceeds capacity")
    pre6 = p[head : head + 6 * g]
    off2 = head + 6 * g
    n_sync = (nt - 1) // sync_t if has_sync else 0
    sync6 = p[off2 : off2 + 6 * g * n_sync]
    off2 += 6 * g * n_sync
    if (len(pre6) != 6 * g or len(sync6) != 6 * g * n_sync
            or off2 + 2 * int(sizes.sum()) != len(p)):
        raise InvalidHeader("rans16 payload size mismatch")
    if full:
        return sizes, pre6, p[off2:], sync_t, sync6
    return sizes, pre6, p[off2:]


def decode_tables(table_c: np.ndarray):
    """(A,) shared or (NG, A) per-group counts -> the decode kernel's
    device cum table(s) (shared: 1-D; per group: one row per group)."""
    rows = cum_rows(table_c)
    return jnp.asarray(rows[0] if np.ndim(table_c) == 1 else rows)


@functools.partial(jax.jit, static_argnames=(
    "n_steps", "a_count", "out_dtype", "interpret"))
def _decode_device(stream, offsets, hi, lo, cum, *, n_steps, a_count,
                   out_dtype, interpret):
    """Decode kernel -> flat lane-major symbols (NG*G*L,) in the narrow
    output dtype."""
    sym = rans_decode(stream, offsets, hi, lo, cum, n_steps=n_steps,
                      a_count=a_count, out_dtype=out_dtype,
                      interpret=interpret)
    return jnp.transpose(sym, (0, 2, 1)).reshape(-1)


def _stage_stream(regions, n_rows: int = 1):
    """Per-group region bytes -> ``(stream, offsets)``: the sections
    concatenated into ``n_rows`` equal-length uint16 rows (row r holds
    groups [r*k, (r+1)*k), k = len(regions) / n_rows — the per-device
    layout of the sharded decoder) and each group's start within its
    row."""
    k = len(regions) // n_rows
    lens = np.array([len(r) // 2 for r in regions], np.int64)
    width = max(1, int(max(lens.reshape(n_rows, k).sum(axis=1))))
    stream = np.zeros((n_rows, width), np.uint16)
    offsets = np.zeros(len(regions), np.int32)
    for r in range(n_rows):
        at = 0
        for gi in range(r * k, (r + 1) * k):
            stream[r, at : at + lens[gi]] = np.frombuffer(regions[gi], "<u2")
            offsets[gi] = at
            at += lens[gi]
    return stream, offsets


def decode_groups(
    payloads: List[bytes], table_c: np.ndarray, block_len: int,
    group_lanes: int = None
) -> np.ndarray:
    """Decode per-group payload bytes back to (NG*g, L) symbol rows.

    ``table_c``: (A,) shared counts, or (NG, A) per-group counts (the
    adaptive rans16 mode).  ``group_lanes`` comes from the container."""
    g = group_lanes if group_lanes else G
    NG = len(payloads)
    a_count = int(table_c.shape[-1])
    shared = table_c.ndim == 1
    tables = decode_tables(table_c) if shared else None
    out = np.empty((NG * g, block_len), _narrow_dtype(a_count))
    gpc = _groups_per_call(block_len, g)
    bounds = [(s, min(s + gpc, NG)) for s in range(0, NG, gpc)]

    def dispatch(start, stop):
        tabs = tables if shared else decode_tables(table_c[start:stop])
        return _decode_batch(payloads[start:stop], tabs, a_count,
                             block_len, g)

    # double-buffered: batch i+1's upload + kernel run while batch i's
    # decoded symbols come back
    inflight = dispatch(*bounds[0])
    for bi, (start, stop) in enumerate(bounds):
        cur = inflight
        if bi + 1 < len(bounds):
            inflight = dispatch(*bounds[bi + 1])
        out[start * g : stop * g] = np.asarray(cur).reshape(-1, block_len)
    return out


def _decode_batch(payloads: List[bytes], tables, a_count: int,
                  block_len: int, g: int):
    """Parse + upload + dispatch one batch of group payloads; returns the
    device array of flat decoded symbols (still in flight)."""
    parsed = [_parse_payload(p, block_len, g) for p in payloads]
    NT = parsed[0][0].shape[0]
    if any(s.shape[0] != NT for s, _, _ in parsed):
        raise InvalidHeader("rans16 payloads disagree on tile count")
    stream, offsets = _stage_stream([r for _, _, r in parsed])
    hi, lo = _states_from6([p6 for _, p6, _ in parsed], g)
    return _decode_device(
        jnp.asarray(stream[0]), jnp.asarray(offsets), jnp.asarray(hi),
        jnp.asarray(lo), tables, n_steps=block_len, a_count=a_count,
        out_dtype=_narrow_dtype(a_count), interpret=interpret_kernels())


def decode_tile_range(
    payload, table_c: np.ndarray, block_len: int,
    step_lo: int, step_hi: int, group_lanes: int = None,
    *, parsed=None, tables=None,
):
    """Decode a STEP range of one group payload without decoding the rest.

    Starts at the nearest sync point at or before ``step_lo`` (the
    preamble when the payload has no sync section — sizes still let the
    decode stop at ``step_hi``, so the tail is never decoded) and decodes
    through ``step_hi``.  Returns ``(rows (g, steps), step0)`` where
    ``rows[:, s - step0]`` is every lane's symbol at step ``s`` —
    tile-level random access.

    ``parsed`` / ``tables``: optional pre-parsed payload (the
    ``_parse_payload(..., full=True)`` tuple) and device tables
    (:func:`decode_tables`) — many-slice readers
    (api._decode_range_rans16) pass them to avoid re-parsing a multi-MB
    payload and rebuilding the tables per slice.
    """
    g = group_lanes if group_lanes else G
    if parsed is None:
        parsed = _parse_payload(payload, block_len, g, full=True)
    sizes, pre6, region, sync_t, sync6 = parsed
    NT = sizes.shape[0]
    tile = block_len // NT
    if not 0 <= step_lo < step_hi <= block_len:
        raise ConfigError(
            f"step range [{step_lo}, {step_hi}) outside [0, {block_len})")
    tile_lo = step_lo // tile
    tile_hi = -(-step_hi // tile)
    j = min(tile_lo // sync_t, (NT - 1) // sync_t) if sync_t else 0
    t0 = j * sync_t
    states6 = bytes(pre6) if j == 0 else bytes(
        sync6[(j - 1) * 6 * g : j * 6 * g])
    off_hw = int(sizes[:t0].sum())
    sub = bytes(region[2 * off_hw : 2 * (off_hw + int(
        sizes[t0:tile_hi].sum()))])
    stream, offsets = _stage_stream([sub])
    hi, lo = _states_from6([states6], g)
    a_count = int(table_c.shape[-1])
    if tables is None:
        tables = decode_tables(table_c)
    steps = (tile_hi - t0) * tile
    flat = np.asarray(_decode_device(
        jnp.asarray(stream[0]), jnp.asarray(offsets), jnp.asarray(hi),
        jnp.asarray(lo), tables, n_steps=steps, a_count=a_count,
        out_dtype=_narrow_dtype(a_count), interpret=interpret_kernels()))
    return flat.astype(np.int32).reshape(g, steps), t0 * tile


def _shrink_lane_len(n: int, L: int, group_lanes: int = None) -> int:
    """Smallest valid lane length that still covers ``n`` symbols with one
    group, capped at the requested ``L`` — long lanes only pay off when
    there is data to fill them, and shrinking caps the padding waste.
    Valid lengths: any value <= the tile size, else multiples of it."""
    g = group_lanes if group_lanes else G
    ts = rans.tile_steps_for(g)
    need = max(1, -(-n // g))
    if need >= L:
        return L
    if need <= ts:
        return need
    return min(L, -(-need // ts) * ts)


def encode(
    symbols: np.ndarray,
    *,
    alphabet: int,
    table: Pow2Table | None = None,
    block_len: int,
    with_checksums: bool = True,
    per_group_tables: bool = False,
    sync_tiles: int = 0,
    group_lanes: int = None,
) -> bytes:
    """Compress a 1-D integer symbol array into a rans16 container.

    ``block_len`` is the REQUESTED lane length; it is shrunk (to a
    multiple of the tile size, or less for tiny inputs) when the input is
    too small to fill even one group at that length.

    ``table=None`` builds the shared order-0 table from the data's
    histogram (host ``np.bincount``).

    ``per_group_tables=True`` is the ADAPTIVE rans16 mode: a separate
    order-0 table per group of ``group_lanes * L`` symbols (two-pass:
    device histogram per group, then the same kernels with group-indexed
    table blocks — adaptive coding at full kernel speed).  Pick a small
    ``block_len`` so groups are small enough to adapt, and consider
    ``group_lanes=1024``: narrower groups halve the 6 B/lane state
    overhead per symbol at a fixed adaptive group size (the default
    2048-lane groups maximize shared-table throughput instead).
    """
    if table is not None and table.k != 16:
        raise ConfigError("rans16 profile requires k == 16")
    if per_group_tables and table is not None:
        raise ConfigError("per_group_tables builds its own tables")
    if alphabet > 1023:
        raise ConfigError(
            f"alphabet {alphabet} exceeds the rans16 limit of 1023 "
            "symbols (the kernels' symbol tables hold A+1 <= 1024 "
            "entries); use the "
            "planar profile — api.encode falls back automatically")
    n = int(symbols.size)
    g = group_lanes if group_lanes else G
    if not (128 <= g <= 65536 and g & (g - 1) == 0):
        raise ConfigError(
            f"group_lanes {g} must be a power of two in [128, 65536]")
    _tile_geometry(block_len, g)  # validate requested geometry
    if n >= 1 << 31:
        # beyond the single-call bound (the device histogram accumulates
        # in int32) the input is encoded in SLABS of whole groups appended
        # into ONE container — the unbounded-input analogue of the
        # reference's streaming Encoder (src/encoder.rs:24-46)
        return _encode_chunked(
            symbols, alphabet=alphabet, table=table, block_len=block_len,
            with_checksums=with_checksums,
            per_group_tables=per_group_tables, sync_tiles=sync_tiles, g=g)
    L = _shrink_lane_len(n, block_len, g)
    ng = max(1, math.ceil(n / (g * L)))

    narrow = (symbols if alphabet > 256
              else symbols.astype(np.uint8, copy=False))
    from .models.table import build_table_pow2

    if per_group_tables:
        # device path: per-group histograms want the data resident, and
        # the one upload serves both the histogram and the kernels
        data_dev = jnp.asarray(narrow)
        # pad with the last data symbol: guaranteed present in the last
        # group's histogram (a zero-frequency pad would be uncodable)
        pad_symbol = int(symbols[-1]) if n else 0
        padded = _pad_rows_device(
            data_dev, np.asarray(pad_symbol, narrow.dtype),
            rows=ng * g, length=L)
        counts = np.asarray(_histogram_groups(
            padded.reshape(-1), alphabet=alphabet, n_groups=ng)
        ).astype(np.uint64)
        if n == 0:
            counts[:] = 1
        tables = [build_table_pow2(c, 16) for c in counts]
        payloads = encode_groups(padded, tables, L, sync_tiles, g)
        tables_c = np.stack([t.c for t in tables])
    else:
        # host histogram + host padding: keeping the rows host-side lets
        # encode_groups upload per batch, overlapping batch i+1's upload
        # with batch i's stream fetch
        if table is None:
            if n == 0:
                counts = np.ones(max(alphabet, 1), np.uint64)
            else:
                hist_src = (narrow if narrow.dtype == np.uint8
                            else narrow.astype(np.uint16, copy=False))
                counts = np.zeros(alphabet, np.int64)
                step = 1 << 28
                for i in range(0, n, step):
                    counts += np.bincount(
                        hist_src[i : i + step],
                        minlength=alphabet)[:alphabet]
                counts = counts.astype(np.uint64)
            table = build_table_pow2(counts, 16)
        pad_symbol = int(np.argmax(table.c))
        rows_host = np.full(ng * g * L, pad_symbol, narrow.dtype)
        rows_host[:n] = narrow
        payloads = encode_groups(
            rows_host.reshape(ng * g, L), table, L, sync_tiles, g)
        tables_c = table.c
    return fmt.pack(
        k=16,
        alphabet=alphabet,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=tables_c,
        per_block_tables=per_group_tables,
        with_checksums=with_checksums,
        profile="rans16",
        group_lanes=g,
    )


#: symbols per slab in the chunked (>= 2^31 symbols) encode path —
#: rounded down to whole groups; each slab runs the standard batched
#: device pipeline and appends its groups to the one container
_SLAB_SYMBOLS = 1 << 30


def _encode_chunked(
    symbols: np.ndarray, *, alphabet: int, table, block_len: int,
    with_checksums: bool, per_group_tables: bool, sync_tiles: int, g: int
) -> bytes:
    """Multi-slab encode for inputs past the single-call 2^31-symbol cap
    (BASELINE config 4, 10 GB): whole-group slabs stream through
    :func:`encode_groups`, payloads append into one container.

    The shared table comes from a host histogram pass (so the corpus is
    uploaded once, slab by slab); per-group tables likewise build
    host-side per slab.  The container is identical in structure to
    the single-call output — decode needs no special handling.
    """
    from .models.table import build_table_pow2

    n = int(symbols.size)
    L = block_len
    span = g * L
    narrow = (symbols if symbols.dtype == np.uint8
              else symbols.astype(np.uint8) if alphabet <= 256
              else symbols.astype(np.uint16) if alphabet <= 65536
              else symbols)
    slab = max(1, _SLAB_SYMBOLS // span) * span

    if not per_group_tables and table is None:
        counts = np.zeros(alphabet, np.int64)
        step = 1 << 28
        for i in range(0, n, step):
            counts += np.bincount(narrow[i : i + step],
                                  minlength=alphabet)[:alphabet]
        table = build_table_pow2(counts.astype(np.uint64), 16)
    pad_symbol = (int(np.argmax(table.c)) if not per_group_tables
                  else int(narrow[-1]))

    payloads: List[bytes] = []
    tables_per_group: List = []
    for s0 in range(0, n, slab):
        part = narrow[s0 : min(s0 + slab, n)]
        ng = -(-part.size // span)
        if part.size < ng * span:  # last slab: pad to whole groups
            full = np.full(ng * span, pad_symbol, narrow.dtype)
            full[: part.size] = part
            part = full
        rows = part.reshape(ng * g, L)
        if per_group_tables:
            slab_tables = []
            for gi in range(ng):
                cnt = np.bincount(rows[gi * g : (gi + 1) * g].reshape(-1),
                                  minlength=alphabet)[:alphabet]
                slab_tables.append(build_table_pow2(
                    cnt.astype(np.uint64), 16))
            payloads += encode_groups(rows, slab_tables, L, sync_tiles, g)
            tables_per_group += [t.c for t in slab_tables]
        else:
            payloads += encode_groups(rows, table, L, sync_tiles, g)
    return fmt.pack(
        k=16,
        alphabet=alphabet,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=(np.stack(tables_per_group) if per_group_tables
                  else table.c),
        per_block_tables=per_group_tables,
        with_checksums=with_checksums,
        profile="rans16",
        group_lanes=g,
    )


def decode(cont: fmt.Container) -> np.ndarray:
    """Decompress a parsed rans16 container back to the symbol array."""
    if cont.profile != "rans16":
        raise ConfigError("not a rans16 container")
    gl = cont.group_lanes
    if gl < 128 or gl % 128:
        raise ConfigError(
            f"container group_lanes {gl} is not a multiple of 128")
    rows = decode_groups(cont.payloads, np.asarray(cont.tables_c),
                         cont.block_len, gl)
    return rows.reshape(-1)[: cont.n_symbols]
