"""High-level one-call API: ``encode(data) -> bytes``, ``decode(blob) -> data``.

What a reference user writes by hand — building the table, driving the
encode loop, carrying the symbol count and model out-of-band
(reference examples/sample_impl.rs:72-128) — is one call here, executed
block-parallel on the device and framed by the container (format.py).

Orchestration is host-side and deliberately thin: chunk the input into
``(B, L)`` blocks, run the jitted device coder over bounded-size chunks
(compile once per geometry), trim payloads by the returned lengths, and
pack.  Capacity overflow (adversarial inputs emitting more than the default
budget) is detected from the lengths and retried with doubled capacity —
never silent corruption.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import format as fmt
from .blocks import FLUSH_BYTES, decode_blocks, default_capacity, encode_blocks
from .errors import ConfigError, ZeroFrequency
from .models.table import Pow2Table, build_table_pow2

#: cap on device temp memory: symbols per device invocation
_CHUNK_SYMBOLS = 1 << 24


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Tunables for the block-parallel codec (the reference hard-codes all
    of these — SURVEY.md §5 'config system: absent')."""

    k: int = 16  # total_freq = 2**k
    #: symbols per block (L).  None picks a profile-appropriate default:
    #: 512 for planar (short blocks keep XLA's run-length compaction
    #: bandwidth-bound), 65536 for rans16 (long lanes amortize the
    #: per-lane state overhead below the scalar reference's stream size).
    block_len: Optional[int] = None
    with_checksums: bool = True
    chunk_symbols: int = _CHUNK_SYMBOLS
    #: "planar" = block-parallel range coder (byte-exact reference
    #: semantics per block); "rans16" = interleaved word rANS (the
    #: fast device profile, rans.py; requires k == 16)
    profile: str = "planar"
    #: use the raw symbol histogram as the table (total_freq = corpus
    #: count, any u32) instead of pow2 normalization — the reference
    #: FreqTable's exact semantics (examples/sample_impl.rs:58-69), coded
    #: with true u64/u32 division on device (blocks.encode_blocks_div)
    raw_total: bool = False
    #: adaptive rans16: one order-0 table per group of group_lanes *
    #: block_len symbols (two-pass device histogram + the same kernels
    #: with group-indexed tables).  Use a moderate block_len so groups
    #: are small enough to adapt (32-64 at the 2048-lane default).
    per_group_tables: bool = False
    #: rans16 group width (lanes per group, a power of two >= 128).
    #: None = rans.GROUP_LANES (2048).  Narrower groups (1024) halve
    #: the 6 B/lane state overhead per symbol at a fixed ADAPTIVE group
    #: size; the kernels and container are width-generic.
    group_lanes: Optional[int] = None
    #: rans16 tile-level random access: record every group's lane states
    #: every ``sync_tiles`` tiles (6 B/lane/sync of container overhead),
    #: letting api.decode_range start decoding mid-group instead of
    #: touching the whole group.  At the default geometry (2048 lanes,
    #: 32-step tiles) sync_tiles=128 costs ~0.2% of container size and a
    #: 1 KB read decodes a <= 128*32*2048 ~ 8M-symbol window instead of
    #: a whole group.
    #: 0 = off (the default keeps the headline size).
    sync_tiles: int = 0

    def __post_init__(self):
        if not 1 <= self.k <= 16:
            raise ConfigError(f"k={self.k} out of range [1, 16]")
        if self.block_len is None:
            object.__setattr__(
                self, "block_len",
                65536 if self.profile == "rans16" else 512)
        if self.block_len < 1:
            raise ConfigError(f"block_len={self.block_len} must be >= 1")
        if self.profile not in ("planar", "rans16"):
            raise ConfigError(f"unknown profile {self.profile!r}")
        if self.profile == "rans16" and self.k != 16:
            raise ConfigError("rans16 profile requires k == 16")
        if self.raw_total and self.profile != "planar":
            raise ConfigError("raw_total requires the planar profile")
        if self.per_group_tables and self.profile != "rans16":
            raise ConfigError(
                "per_group_tables is the adaptive rans16 mode; for planar "
                "per-block tables use adaptive.encode_adaptive")
        if self.sync_tiles < 0:
            raise ConfigError("sync_tiles must be >= 0")
        if self.sync_tiles and self.profile != "rans16":
            raise ConfigError(
                "sync_tiles is rans16 tile random access; planar blocks "
                "are already independently decodable")
        if self.group_lanes is not None:
            if self.profile != "rans16":
                raise ConfigError("group_lanes applies to rans16 only")
            g = self.group_lanes
            # power of two required: the kernels' block vector must be a
            # power of two and the container stores the width as log2
            # (format.pack) — a bare multiple of 128 (e.g. 384) passed
            # validation then crashed mid-trace (advisor r4)
            if not (128 <= g <= 65536 and g & (g - 1) == 0):
                raise ConfigError(
                    f"group_lanes {g} must be a power of two in "
                    "[128, 65536]")


def _as_symbols(data, alphabet: Optional[int]) -> tuple[np.ndarray, int]:
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    else:
        arr = np.asarray(data)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    if arr.size and arr.dtype.kind != "u" and int(arr.min()) < 0:
        raise ConfigError("negative symbol indices")
    inferred = int(arr.max()) + 1 if arr.size else 1
    a = alphabet if alphabet is not None else max(inferred, 1)
    if inferred > a:
        raise ConfigError(f"symbol {inferred - 1} outside alphabet of {a}")
    # keep narrow unsigned dtypes (byte corpora stay 1 B/sym end to end —
    # a blanket int32 cast quadrupled host memory traffic at GB scale)
    if arr.dtype in (np.uint8, np.uint16):
        return arr, a
    return arr.astype(np.int32), a


def _encode_rows(
    rows: np.ndarray, table: Pow2Table, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Device-encode (B, L) rows, retrying with doubled capacity on overflow."""
    c = jnp.asarray(table.c)
    cum = jnp.asarray(table.cum)
    while True:
        code, lengths = encode_blocks(
            jnp.asarray(rows), c, cum, k=table.k, capacity=capacity
        )
        lengths_np = np.asarray(lengths)
        if int(lengths_np.max()) <= capacity:
            return np.asarray(code), lengths_np
        capacity *= 2  # rare adversarial blocks; re-encode with more room


def encode(
    data,
    *,
    alphabet: Optional[int] = None,
    config: CodecConfig = CodecConfig(),
    table: Optional[Pow2Table] = None,
) -> bytes:
    """Compress ``data`` (bytes or 1-D integer array) into a container.

    A shared order-0 table is built from the data's histogram unless one is
    supplied.  Mirrors the reference round-trip driver end-to-end
    (histogram -> calc_cum -> encode loop -> finish; examples/sample_impl.rs:72-107)
    but block-parallel on device.
    """
    symbols, a = _as_symbols(data, alphabet)
    n = int(symbols.size)
    L = config.block_len
    b = max(1, math.ceil(n / L))

    if config.raw_total:
        return _encode_raw(symbols, a, config)

    if config.profile == "rans16" and a > 1023:
        # the rans16 kernels' symbol tables hold A+1 <= 1024
        # entries, so A <= 1023; wider alphabets fall back to the planar
        # profile automatically, mirroring the CLI's k != 16 fallback
        # rule (VERDICT r3 item 7 — previously this surfaced as a raw
        # ValueError deep in the kernel)
        if config.per_group_tables:
            raise ConfigError(
                f"alphabet {a} exceeds the rans16 limit of 1023 symbols "
                "and per_group_tables has no planar fallback; use "
                "adaptive.encode_adaptive or an alphabet <= 1023")
        config = dataclasses.replace(
            config, profile="planar", sync_tiles=0, group_lanes=None,
            block_len=None if config.block_len == 65536
            else config.block_len)
        L = config.block_len
        b = max(1, math.ceil(n / L))

    if config.profile == "rans16" and table is None:
        # the rans16 path builds the table(s) on device from the uploaded
        # data (np.bincount costs seconds at GB scale on this host class)
        from . import rans_codec

        return rans_codec.encode(
            symbols,
            alphabet=a,
            table=None,
            block_len=L,
            with_checksums=config.with_checksums,
            per_group_tables=config.per_group_tables,
            sync_tiles=config.sync_tiles,
            group_lanes=config.group_lanes,
        )

    if table is None:
        counts = np.bincount(symbols, minlength=a).astype(np.uint64)
        if n == 0:
            counts[0] = 1  # degenerate empty input: any valid table
        table = build_table_pow2(counts, config.k)
    else:
        if table.alphabet < a:
            raise ConfigError(
                f"table covers {table.alphabet} symbols, data needs {a}"
            )
        a = table.alphabet
        present = np.zeros(a, bool)
        present[np.unique(symbols)] = True
        if np.any(present & (table.c == 0)):
            raise ZeroFrequency(
                "data contains symbols with zero frequency in the given table"
            )

    if config.profile == "rans16":
        from . import rans_codec

        return rans_codec.encode(
            symbols,
            alphabet=a,
            table=table,
            block_len=L,
            with_checksums=config.with_checksums,
            sync_tiles=config.sync_tiles,
            group_lanes=config.group_lanes,
        )

    pad_symbol = int(np.argmax(table.c))
    padded = np.full(b * L, pad_symbol, np.int32)
    padded[:n] = symbols
    rows = padded.reshape(b, L)

    rows_per_chunk = max(1, config.chunk_symbols // L)
    capacity = default_capacity(L, table.k)
    payloads = []
    for start in range(0, b, rows_per_chunk):
        chunk = rows[start : start + rows_per_chunk]
        code, lengths = _encode_rows(chunk, table, capacity)
        for i in range(chunk.shape[0]):
            payloads.append(code[i, : lengths[i]].tobytes())

    return fmt.pack(
        k=table.k,
        alphabet=a,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=table.c,
        per_block_tables=False,
        with_checksums=config.with_checksums,
    )


def _encode_raw(symbols: np.ndarray, a: int, config: CodecConfig) -> bytes:
    """Planar encode with the raw-histogram table (arbitrary u32 total) —
    the reference FreqTable path (examples/sample_impl.rs:58-69), device-
    coded via true division (blocks.encode_blocks_div)."""
    from .blocks import encode_blocks_div

    n = int(symbols.size)
    L = config.block_len
    b = max(1, math.ceil(n / L))
    counts = np.bincount(symbols, minlength=a).astype(np.uint64)
    if counts.sum() == 0:
        counts[0] = 1
    if counts.sum() >= 1 << 32:
        raise ConfigError("raw_total: corpus count exceeds u32 total_freq")
    c = counts.astype(np.uint32)
    cum = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
    total = int(counts.sum())

    pad_symbol = int(np.argmax(c))
    padded = np.full(b * L, pad_symbol, np.int32)
    padded[:n] = symbols
    rows = padded.reshape(b, L)

    # worst case ~5 bytes/symbol at 32-bit totals (+renorm waste) + flush
    capacity = -(-(6 * L + 8) // 4) * 4
    rows_per_chunk = max(1, config.chunk_symbols // L)
    c_dev, cum_dev = jnp.asarray(c), jnp.asarray(cum)
    payloads = []
    for start in range(0, b, rows_per_chunk):
        chunk = rows[start : start + rows_per_chunk]
        code, lengths = encode_blocks_div(
            jnp.asarray(chunk), c_dev, cum_dev, total, capacity=capacity)
        code_np, lengths_np = np.asarray(code), np.asarray(lengths)
        assert int(lengths_np.max()) <= capacity, "raw-total capacity bound"
        for i in range(chunk.shape[0]):
            payloads.append(code_np[i, : lengths_np[i]].tobytes())

    return fmt.pack(
        k=0,
        alphabet=a,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=c,
        per_block_tables=False,
        with_checksums=config.with_checksums,
    )


def decode(blob: bytes, *, verify_checksums: bool = True) -> np.ndarray:
    """Decompress a container back to the symbol array (rans16: the
    narrowest unsigned dtype covering the alphabet — uint8 for byte
    corpora, avoiding two GB-scale widening copies; planar: int32).

    Raises typed errors on malformed input (InvalidHeader, ChecksumMismatch,
    TruncatedStream semantics become zero-padded windows caught by CRC) —
    the reference panics in these situations (src/decoder.rs:33).
    """
    return _decode_container(fmt.unpack(blob, verify_checksums=verify_checksums))


def decode_range(
    blob: bytes, start: int, count: int, *, verify_checksums: bool = True
) -> np.ndarray:
    """Decode only symbols ``[start, start + count)`` of a container.

    Touches (and CRC-verifies) only the covering independent units —
    planar/adaptive blocks of ``block_len`` symbols, or rans16 groups of
    ``group_lanes * block_len`` symbols — realizing the per-block
    independence the container records (SURVEY.md §5 checkpoint/resume:
    any block is decodable in isolation).  The rest of the container is
    parsed (headers, lengths) but its payloads are never decoded.
    """
    import zlib

    cont = fmt.unpack(blob, verify_checksums=False)
    n = cont.n_symbols
    if start < 0 or count < 0 or start + count > n:
        raise ConfigError(
            f"range [{start}, {start + count}) outside [0, {n})")
    if count == 0:
        # avoid touching any unit (start == n would otherwise index one
        # block past the end — advisor r3)
        return np.zeros(0, np.int32)
    span = cont.block_len * (cont.group_lanes or 1)
    b0 = start // span
    b1 = max(b0 + 1, -(-(start + count) // span)) if count else b0 + 1
    if verify_checksums and cont.checksums is not None:
        for i in range(b0, b1):
            actual = zlib.crc32(cont.payloads[i])
            if actual != int(cont.checksums[i]):
                from .errors import ChecksumMismatch

                raise ChecksumMismatch(i, int(cont.checksums[i]), actual)
    if cont.profile == "rans16":
        return _decode_range_rans16(cont, start, count, b0, b1)
    sub = dataclasses.replace(
        cont,
        lengths=cont.lengths[b0:b1],
        payloads=cont.payloads[b0:b1],
        checksums=None,
        tables_c=(cont.tables_c[b0:b1] if cont.per_block_tables
                  else cont.tables_c),
        n_symbols=min(n, b1 * span) - b0 * span,
    )
    out = _decode_container(sub)
    lo = start - b0 * span
    return out[lo : lo + count]


def _decode_range_rans16(cont, start: int, count: int, b0: int, b1: int
                         ) -> np.ndarray:
    """Tile-level random access for rans16 containers.

    Per touched group, decodes only the STEP interval(s) the requested
    lanes need (via rans_codec.decode_tile_range, entering at the nearest
    sync point when the container carries them — CodecConfig.sync_tiles —
    and always stopping at the last needed tile).  A small read touches
    O(sync_tiles * tile * group_lanes) symbols instead of the whole
    group's ``group_lanes * block_len`` (64-128 MB at flagship geometry)."""
    from . import rans_codec

    g = cont.group_lanes
    L = cont.block_len
    span = L * g
    out = np.empty(count, np.int32)
    shared_tables = None if cont.per_block_tables else (
        rans_codec.decode_tables(np.asarray(cont.tables_c)))
    for bidx in range(b0, b1):
        gbase = bidx * span
        a = max(start, gbase)
        b = min(start + count, gbase + span)
        if b <= a:
            continue
        tc = np.asarray(cont.tables_c[bidx] if cont.per_block_tables
                        else cont.tables_c)
        tables = (shared_tables if shared_tables is not None
                  else rans_codec.decode_tables(tc))
        la, sa = divmod(a - gbase, L)
        lb, sbm = divmod(b - gbase - 1, L)
        # parse ONCE per group; the per-interval decode_tile_range calls
        # below reuse the parse and the table prep (advisor r4: this
        # previously re-parsed the same multi-MB payload up to 3x)
        parsed = rans_codec._parse_payload(
            cont.payloads[bidx], L, g, full=True)
        sync_t = parsed[3]
        if lb > la + 1:
            intervals = [(0, L, None)]           # middle lanes need it all
        elif lb == la:
            intervals = [(sa, sbm + 1, None)]
        elif sync_t:  # two adjacent lanes: their tail + head step spans
            intervals = [(sa, L, la), (0, sbm + 1, lb)]
        else:
            # no sync points: the tail interval would decode from tile 0
            # anyway, so one merged full pass does strictly less work
            # than tail + head separately (and compiles one geometry)
            intervals = [(0, L, None)]
        ps = np.arange(a, b)
        lanes = (ps - gbase) // L
        steps = (ps - gbase) % L
        for (s0, s1, only_lane) in intervals:
            rows, step0 = rans_codec.decode_tile_range(
                cont.payloads[bidx], tc, L, s0, s1, g,
                parsed=parsed, tables=tables)
            sel = (lanes == only_lane if only_lane is not None
                   else np.ones(ps.size, bool))
            out[ps[sel] - start] = rows[lanes[sel], steps[sel] - step0]
    return out


def _decode_container(cont: fmt.Container) -> np.ndarray:
    """Profile dispatch for an already-parsed container."""
    if cont.profile == "rans16":
        from . import rans_codec

        return rans_codec.decode(cont)
    if cont.per_block_tables:
        from .adaptive import decode_adaptive_container

        return decode_adaptive_container(cont)
    if cont.k == 0:  # raw-total container (FLAG_RAW_TOTAL)
        return _decode_raw(cont)
    b = cont.n_blocks
    L = cont.block_len
    n = cont.n_symbols

    cum = np.concatenate([[0], np.cumsum(cont.tables_c)]).astype(np.uint32)
    c_dev = jnp.asarray(cont.tables_c.astype(np.uint32))
    cum_dev = jnp.asarray(cum)

    # round capacity up so decode_blocks' compile cache hits across calls
    cap = -(-max(int(cont.lengths.max()), FLUSH_BYTES) // 1024) * 1024
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    out = np.empty(b * L, np.int32)
    for start in range(0, b, rows_per_chunk):
        stop = min(start + rows_per_chunk, b)
        code = _payload_matrix(cont, start, stop, cap)
        dec = decode_blocks(
            jnp.asarray(code), c_dev, cum_dev, k=cont.k, block_len=L
        )
        out[start * L : stop * L] = np.asarray(dec).reshape(-1)
    return out[:n]


def _payload_matrix(
    cont: fmt.Container, start: int, stop: int, cap: int
) -> np.ndarray:
    """Blocks [start, stop) as a zero-padded (rows, cap) uint8 matrix,
    assembled with vectorized numpy (one mask scatter) instead of a
    per-block Python loop — at GB scale the loop dominates end-to-end
    decode (round-1 verdict)."""
    lens = cont.lengths[start:stop]
    flat = np.frombuffer(
        b"".join(cont.payloads[start:stop]), np.uint8)
    rows = stop - start
    col = np.arange(cap, dtype=np.int64)
    mask = col[None, :] < lens[:, None]
    src = (np.concatenate([[0], np.cumsum(lens)])[:-1, None] + col[None, :])
    code = np.zeros((rows, cap), np.uint8)
    code[mask] = flat[src[mask]]
    return code


def _decode_raw(cont: fmt.Container) -> np.ndarray:
    """Decode a raw-total (arbitrary u32 total_freq) planar container."""
    from .blocks import decode_blocks_div

    b, L, n = cont.n_blocks, cont.block_len, cont.n_symbols
    cum = np.concatenate([[0], np.cumsum(cont.tables_c)]).astype(np.uint32)
    total = int(cont.tables_c.sum())
    c_dev, cum_dev = jnp.asarray(cont.tables_c), jnp.asarray(cum)
    cap = -(-max(int(cont.lengths.max()), FLUSH_BYTES) // 1024) * 1024
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    out = np.empty(b * L, np.int32)
    for start in range(0, b, rows_per_chunk):
        stop = min(start + rows_per_chunk, b)
        code = np.zeros((stop - start, cap), np.uint8)
        for i in range(start, stop):
            p = cont.payloads[i]
            code[i - start, : len(p)] = np.frombuffer(p, np.uint8)
        dec = decode_blocks_div(
            jnp.asarray(code), c_dev, cum_dev, total, block_len=L)
        out[start * L : stop * L] = np.asarray(dec).reshape(-1)
    return out[:n]


def decode_bytes(blob: bytes, **kw) -> bytes:
    """Like :func:`decode` but returns raw bytes (alphabet must be <= 256)."""
    sym = decode(blob, **kw)
    return sym.astype(np.uint8).tobytes()
