"""Per-block adaptive tables — the two-pass mode (BASELINE.md config 3).

The reference's model abstraction explicitly anticipates adaptive models
(README.md:4-6 "Agnostic for probability models"); its example only ships a
static table.  Here each block gets its own table fitted to its contents:

  pass 1: per-block histogram (one scatter-add per block row) and exact
          pow2 normalization — models/table.py:normalize_pow2 vmapped over
          blocks, all integer math, deterministic;
  pass 2: the same closed-form encode scan, but with per-block (c, cum)
          rows feeding each lane.

The container stores one table per block (format.py FLAG_PER_BLOCK_TABLES),
so any block remains independently decodable (SURVEY.md §5 resume
property).  Decode mirrors with the per-block masked-reduction sweep.

Per-block tables cost ``A * 2`` bytes of header per block and win when
block statistics drift (mixed binary corpora); the shared-table mode
(api.py) wins on homogeneous data.  ``encode_adaptive`` picks per block
geometry only — choosing between modes is the caller's call.

**Status (round 4): CONFORMANCE-ONLY.**  This planar path demonstrates
per-block tables under the byte-exact planar coder, but its decode sweep
is O(L*A) masked work per scan step — it is a correctness/conformance
artifact, not a throughput path.  The PRODUCT adaptive mode is rans16
``CodecConfig(per_group_tables=True)`` (rans_codec.py): per-group tables
at full kernel speed (scripts/adaptive_bench.py).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import format as fmt
from .blocks import FLUSH_BYTES, compact_emissions, default_capacity
from .errors import ConfigError
from .models.table import normalize_pow2
from .ops import lookup, u64
from .ops.transition import (
    decode_find_rfreq,
    flush_state,
    init_state,
    param_update_pow2,
)

_U32 = jnp.uint32

#: device-invocation chunk bound (symbols per call), as in api.py
_CHUNK_SYMBOLS = 1 << 24


@functools.partial(jax.jit, static_argnames=("alphabet", "k"))
def block_tables(symbols: jax.Array, *, alphabet: int, k: int) -> Tuple[jax.Array, jax.Array]:
    """Pass 1: per-block histogram + pow2 normalization.

    Returns ``(c (B, A) uint32, cum (B, A+1) uint32)``.
    """
    B, L = symbols.shape
    counts = jax.vmap(
        lambda row: jnp.zeros((alphabet,), _U32).at[row].add(1)
    )(symbols)
    c = jax.vmap(lambda cnt: normalize_pow2(cnt, k))(counts)
    cum = jnp.concatenate(
        [jnp.zeros((B, 1), _U32), jnp.cumsum(c, axis=1, dtype=_U32)], axis=1
    )
    return c, cum


@functools.partial(jax.jit, static_argnames="k")
def encode_scan_adaptive(
    symbols: jax.Array, c: jax.Array, cum: jax.Array, *, k: int
):
    """Pass 2: the encode scan with per-block tables (c (B, A), cum (B, A+1)).

    Table lookup per lane uses the same packed select-accumulate chain as
    the shared-table path, with per-block packed rows.
    """
    B, L = symbols.shape
    a_count = c.shape[1]
    packed = ((cum[:, :-1] & _U32(0xFFFF)) << 16) | ((c - 1) & _U32(0xFFFF))

    # per-block packed lookup: chain over the alphabet, per-block constants
    s = symbols.astype(jnp.int32)
    z = jnp.zeros(symbols.shape, _U32)
    for a in range(a_count):
        z = z | jnp.where(s == a, packed[:, a : a + 1], _U32(0))
    cs = (z & _U32(0xFFFF)) + 1
    cums = z >> 16

    def step(st, x):
        st, emit, n = param_update_pow2(st, x[0], x[1], k)
        return st, (emit.hi, emit.lo, n)

    st, (ehi, elo, en) = jax.lax.scan(step, init_state((B,)), (cs.T, cums.T))
    femit, fn = flush_state(st)
    ehi = jnp.concatenate([ehi.T, femit.hi[:, None]], axis=1)
    elo = jnp.concatenate([elo.T, femit.lo[:, None]], axis=1)
    en = jnp.concatenate([en.T, fn[:, None]], axis=1)
    pos = jnp.cumsum(en, axis=1) - en
    lengths = pos[:, -1] + en[:, -1]
    return ehi, elo, en, pos, lengths


@functools.partial(jax.jit, static_argnames=("k", "block_len"))
def decode_blocks_adaptive(
    code: jax.Array, c: jax.Array, cum: jax.Array, *, k: int, block_len: int
) -> jax.Array:
    """Decode with per-block tables: per-block masked-reduction sweep."""
    B, C = code.shape
    code32 = jnp.asarray(code)
    from .blocks import bytes_to_words_be

    code32 = bytes_to_words_be(code32)

    def step(carry, _):
        st, cursor = carry
        whi, _ = lookup.window_extract(code32, cursor - 8)
        rfreq = decode_find_rfreq(st, whi, k)
        # per-block sweep: masks use each block's own table row
        m_next = cum[:, 1:] <= rfreq[:, None]
        m_cur = cum[:, :-1] <= rfreq[:, None]
        idx = jnp.sum(m_next, axis=1).astype(jnp.int32)
        cum_s = jnp.sum(jnp.where(m_next, c, _U32(0)), axis=1, dtype=_U32)
        cum_n = jnp.sum(jnp.where(m_cur, c, _U32(0)), axis=1, dtype=_U32)
        st, _, n = param_update_pow2(st, cum_n - cum_s, cum_s, k)
        return (st, cursor + n), idx

    cursor0 = jnp.full((B,), 8, jnp.int32)
    (_, _), syms = jax.lax.scan(
        step, (init_state((B,)), cursor0), None, length=block_len
    )
    return syms.T


def encode_adaptive(
    data,
    *,
    alphabet: Optional[int] = None,
    k: int = 12,
    block_len: int = 512,
    with_checksums: bool = True,
) -> bytes:
    """One-call adaptive encode: per-block two-pass tables + container."""
    from .api import _as_symbols  # shared input validation

    symbols, a = _as_symbols(data, alphabet)
    if a > 1 << k:
        raise ConfigError(
            f"alphabet {a} cannot get nonzero frequencies under total 2**{k}"
        )
    n = int(symbols.size)
    L = block_len
    b = max(1, math.ceil(n / L))
    padded = np.zeros(b * L, np.int32)
    padded[:n] = symbols
    rows = padded.reshape(b, L)
    capacity = default_capacity(L, k)

    payloads, tables = [], []
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    for start in range(0, b, rows_per_chunk):
        chunk = jnp.asarray(rows[start : start + rows_per_chunk])
        c, cum = block_tables(chunk, alphabet=a, k=k)
        cap = capacity
        while True:
            ehi, elo, en, pos, lengths = encode_scan_adaptive(chunk, c, cum, k=k)
            lengths_np = np.asarray(lengths)
            if int(lengths_np.max()) <= cap:
                break
            cap *= 2
        code = np.asarray(compact_emissions(ehi, elo, en, pos, capacity=cap))
        c_np = np.asarray(c)
        for i in range(chunk.shape[0]):
            payloads.append(code[i, : lengths_np[i]].tobytes())
            tables.append(c_np[i])

    return fmt.pack(
        k=k,
        alphabet=a,
        block_len=L,
        n_symbols=n,
        payloads=payloads,
        tables_c=np.stack(tables),
        per_block_tables=True,
        with_checksums=with_checksums,
    )


def decode_adaptive(blob: bytes, *, verify_checksums: bool = True) -> np.ndarray:
    """Decode a per-block-tables container."""
    return decode_adaptive_container(
        fmt.unpack(blob, verify_checksums=verify_checksums))


def decode_adaptive_container(cont: fmt.Container) -> np.ndarray:
    """Decode an already-parsed per-block-tables container."""
    if not cont.per_block_tables:
        raise ConfigError("container has a shared table; use api.decode")
    b, L, n = cont.n_blocks, cont.block_len, cont.n_symbols
    cum_np = np.concatenate(
        [np.zeros((b, 1), np.uint32), np.cumsum(cont.tables_c, axis=1)], axis=1
    ).astype(np.uint32)

    cap = -(-max(int(cont.lengths.max()), FLUSH_BYTES) // 1024) * 1024
    rows_per_chunk = max(1, _CHUNK_SYMBOLS // L)
    out = np.empty(b * L, np.int32)
    for start in range(0, b, rows_per_chunk):
        stop = min(start + rows_per_chunk, b)
        code = np.zeros((stop - start, cap), np.uint8)
        for i in range(start, stop):
            p = cont.payloads[i]
            code[i - start, : len(p)] = np.frombuffer(p, np.uint8)
        dec = decode_blocks_adaptive(
            jnp.asarray(code),
            jnp.asarray(cont.tables_c[start:stop].astype(np.uint32)),
            jnp.asarray(cum_np[start:stop]),
            k=cont.k,
            block_len=L,
        )
        out[start * L : stop * L] = np.asarray(dec).reshape(-1)
    return out[:n]
