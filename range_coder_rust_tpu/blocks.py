"""Block-parallel batch encode/decode under ``jit`` (the planar profile).

The reference processes one stream sequentially — every emitted byte depends
on all prior symbols through ``(lower, range)`` (reference src/encoder.rs:24-37,
SURVEY.md §2).  The device answer is block parallelism: the input is
chunked into ``B`` independent blocks, each with its own coder state living
in one vector lane; a single ``lax.scan`` over symbol positions advances all
``B`` coders per step with the closed-form transition (ops/transition.py).
No data-dependent control flow and no dynamic shapes; data-dependent
accesses are reformulated (ops/lookup.py):

* table lookups: packed select-accumulate chain (encode) / masked-reduction
  sweep (decode);
* byte-stream compaction: one scatter of every emission's bytes to its
  start position (see :func:`compact_emissions`);
* decoder window: the 64-bit window is just bytes ``[cursor-8, cursor)`` of
  the block's stream (reference src/decoder.rs:27-35), re-extracted each
  step by a masked reduction over the code row.

Per-block payloads are byte-identical to the scalar golden encoder run with
the same table (tests/test_blocks.py), which pins the device path to the
reference semantics (src/range_coder.rs:53-92).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .ops import lookup, u64
from .ops.transition import (
    EMIT_MAX,
    decode_find_rfreq,
    decode_find_rfreq_div,
    flush_state,
    init_state,
    param_update_div,
    param_update_pow2,
)

_U32 = jnp.uint32
_U8 = jnp.uint8

#: Flush length: the final 64-bit lower bound, 8 bytes
#: (reference src/encoder.rs:40-46).
FLUSH_BYTES = 8


def default_capacity(block_len: int, k: int) -> int:
    """Worst-case per-block payload bytes.

    A symbol with ``c = 1`` consumes ``k`` bits of range; adversarial input
    can also trigger range-reduction waste, so the bound is intentionally
    loose: ``ceil(k/8)+1`` bytes per symbol plus the 8-byte flush, rounded
    up to a word multiple.  The encoder verifies at runtime that no block
    overflowed (host check in api.py); typical payloads are far below this.
    """
    cap = block_len * ((k + 7) // 8 + 1) + FLUSH_BYTES
    return -(-cap // 4) * 4


@functools.partial(jax.jit, static_argnames="k")
def encode_scan(
    symbols: jax.Array, c: jax.Array, cum: jax.Array, *, k: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Stage 1: advance all block coders over their symbols.

    Returns ``(ehi, elo, en, pos, lengths)``: per-transition emitted-low
    words and byte counts, (B, L+1) with the flush appended (reference
    src/encoder.rs:40-46), their exclusive prefix sums, and total lengths.
    """
    B, L = symbols.shape
    packed = lookup.pack_table(c, cum)
    cs, cums = lookup.packed_lookup(packed, symbols)  # (B, L), no gather

    def step(st, x):
        cc, cu = x
        st, emit, n = param_update_pow2(st, cc, cu, k)
        return st, (emit.hi, emit.lo, n)

    st, (ehi, elo, en) = jax.lax.scan(
        step, init_state((B,)), (cs.T, cums.T)
    )  # outputs (L, B)

    femit, fn = flush_state(st)
    ehi = jnp.concatenate([ehi.T, femit.hi[:, None]], axis=1)  # (B, L+1)
    elo = jnp.concatenate([elo.T, femit.lo[:, None]], axis=1)
    en = jnp.concatenate([en.T, fn[:, None]], axis=1)
    pos = jnp.cumsum(en, axis=1) - en  # exclusive prefix sum (B, L+1)
    lengths = pos[:, -1] + en[:, -1]
    return ehi, elo, en, pos, lengths


@functools.partial(jax.jit, static_argnames="capacity")
def compact_emissions(
    ehi: jax.Array,
    elo: jax.Array,
    en: jax.Array,
    pos: jax.Array,
    *,
    capacity: int,
) -> jax.Array:
    """Stage 2: materialize byte streams with one scatter.

    The emissions partition each block's output: transition ``i`` covers
    bytes ``[pos[i], pos[i] + en[i])``, and bytes past 8 within an emission
    are zero (ops/transition.py: the emission is the top ``n`` bytes of the
    64-bit lower bound, zero-padded).  So byte ``r < min(en[i], 8)`` of
    transition ``i`` goes to ``pos[i] + r`` — distinct targets, so the
    scatter is deterministic; everything else (and anything past
    ``capacity``) is dropped, leaving zeros.
    """
    B, L1 = en.shape
    r = jnp.arange(8, dtype=jnp.int32)
    sh = (24 - 8 * (r & 3)).astype(_U32)  # big-endian byte r of each word
    word = jnp.where(r < 4, ehi[..., None], elo[..., None])
    byte = ((word >> sh) & _U32(0xFF)).astype(_U8)        # (B, L1, 8)
    dst = jnp.where(r < en[..., None], pos[..., None] + r, capacity)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None, None],
                            dst.shape)
    return jnp.zeros((B, capacity), _U8).at[rows, dst].set(
        byte, mode="drop")


def encode_blocks(
    symbols: jax.Array,
    c: jax.Array,
    cum: jax.Array,
    *,
    k: int,
    capacity: int,
) -> Tuple[jax.Array, jax.Array]:
    """Encode ``(B, L)`` symbol indices into per-block byte streams.

    Two separately-jitted stages (scan, then compaction): fused into one
    program, XLA folds the scan-output transpose into the expansion as
    strided column reads — a ~100x slowdown; the stage boundary pins the
    (B, L+1) layout.  Intermediates stay on device.

    Arguments:
      symbols: ``(B, L)`` integer symbol indices in ``[0, A)``.
      c / cum: shared pow2-normalized table (models/table.py), uint32
        ``(A,)`` / ``(A+1,)`` with ``cum[A] == 2**k``.
      k: log2 of the total frequency (static).
      capacity: per-block output capacity ``C`` (static); overflowing blocks
        are detected via the returned lengths (``lengths[b] > C`` means the
        block must be re-encoded with a larger capacity — excess bytes are
        truncated, never written out of bounds).

    Returns ``(code, lengths)``: ``code (B, C) uint8`` (zeros past each
    block's length) and ``lengths (B,) int32`` including the 8 flush bytes.
    """
    ehi, elo, en, pos, lengths = encode_scan(symbols, c, cum, k=k)
    code = compact_emissions(ehi, elo, en, pos, capacity=capacity)
    return code, lengths


@functools.partial(jax.jit, static_argnames=())
def _wide_lookup(c: jax.Array, cum: jax.Array, symbols: jax.Array):
    """(c[s], cum[s]) for arbitrary u32 tables (values don't fit
    :func:`lookup.pack_table`'s 16-bit packing).

    One batched XLA gather over the whole (B, L) symbol block — amortized
    once per encode call, not per scan step, so the gather's fixed cost is
    immaterial; unlike a per-symbol select chain it keeps the traced
    program size independent of the alphabet (a 2^16-token alphabet
    previously emitted ~2A ops)."""
    s = symbols.astype(jnp.int32)
    return jnp.take(c, s, axis=0), jnp.take(cum, s, axis=0)


@jax.jit
def encode_scan_div(
    symbols: jax.Array, c: jax.Array, cum: jax.Array, total: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Arbitrary-total variant of :func:`encode_scan` — the reference
    contract allows ANY u32 ``total_freq`` (src/pmodel.rs:6-10); this path
    keeps the true u64/u32 division ``rpt = range / total``
    (src/range_coder.rs:38-40) via the digit-recurrence divide
    (ops/u64.divmod_u32) instead of the pow2 shift.  Byte-identical to the
    scalar golden coder for un-normalized tables."""
    B, L = symbols.shape
    cs, cums = _wide_lookup(c, cum[:-1], symbols)
    total = jnp.asarray(total, _U32)

    def step(st, x):
        cc, cu = x
        st, emit, n = param_update_div(st, cc, cu, total)
        return st, (emit.hi, emit.lo, n)

    st, (ehi, elo, en) = jax.lax.scan(
        step, init_state((B,)), (cs.T, cums.T)
    )
    femit, fn = flush_state(st)
    ehi = jnp.concatenate([ehi.T, femit.hi[:, None]], axis=1)
    elo = jnp.concatenate([elo.T, femit.lo[:, None]], axis=1)
    en = jnp.concatenate([en.T, fn[:, None]], axis=1)
    pos = jnp.cumsum(en, axis=1) - en
    lengths = pos[:, -1] + en[:, -1]
    return ehi, elo, en, pos, lengths


def encode_blocks_div(
    symbols: jax.Array,
    c: jax.Array,
    cum: jax.Array,
    total,
    *,
    capacity: int,
) -> Tuple[jax.Array, jax.Array]:
    """:func:`encode_blocks` for arbitrary (non-pow2) u32 totals."""
    ehi, elo, en, pos, lengths = encode_scan_div(symbols, c, cum, total)
    code = compact_emissions(ehi, elo, en, pos, capacity=capacity)
    return code, lengths


@functools.partial(jax.jit, static_argnames="block_len")
def decode_blocks_div(
    code: jax.Array,
    c: jax.Array,
    cum: jax.Array,
    total,
    *,
    block_len: int,
) -> jax.Array:
    """:func:`decode_blocks` for arbitrary (non-pow2) u32 totals.

    ``rfreq = (data - lower) / (range / total)`` with both true divides
    (reference examples/sample_impl.rs:29-30), then the same sweep search.
    """
    B, C = code.shape
    if C % 4:
        raise ValueError(f"capacity {C} must be a multiple of 4")
    code32 = bytes_to_words_be(code)
    total = jnp.asarray(total, _U32)

    def step(carry, _):
        st, cursor = carry
        whi, _ = lookup.window_extract(code32, cursor - 8)
        rfreq = decode_find_rfreq_div(st, whi, total)
        idx, cc, cu = lookup.sweep_find(c, cum, rfreq)
        st, _, n = param_update_div(st, cc, cu, total)
        return (st, cursor + n), idx

    cursor0 = jnp.full((B,), 8, jnp.int32)
    (_, _), syms = jax.lax.scan(
        step, (init_state((B,)), cursor0), None, length=block_len
    )
    return syms.T


def bytes_to_words_be(code: jax.Array) -> jax.Array:
    """(B, C) uint8 -> (B, C//4) uint32 big-endian words (C % 4 == 0)."""
    B, C = code.shape
    w = code.reshape(B, C // 4, 4).astype(_U32)
    return (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]


@functools.partial(jax.jit, static_argnames=("k", "block_len"))
def decode_blocks(
    code: jax.Array,
    c: jax.Array,
    cum: jax.Array,
    *,
    k: int,
    block_len: int,
) -> jax.Array:
    """Decode ``(B, C)`` per-block byte streams back to ``(B, L)`` symbols.

    The symbol count per block is ``block_len`` — like the reference, the
    payload carries no implicit EOF (examples/sample_impl.rs:113-120); the
    container (format.py) supplies it.  ``C`` must be a multiple of 4.
    """
    B, C = code.shape
    if C % 4:
        raise ValueError(f"capacity {C} must be a multiple of 4")
    code32 = bytes_to_words_be(code)

    def step(carry, _):
        st, cursor = carry
        # the 64-bit window is bytes [cursor-8, cursor) (src/decoder.rs:27-35)
        whi, _ = lookup.window_extract(code32, cursor - 8)
        rfreq = decode_find_rfreq(st, whi, k)
        idx, cc, cu = lookup.sweep_find(c, cum, rfreq)
        st, _, n = param_update_pow2(st, cc, cu, k)
        return (st, cursor + n), idx

    cursor0 = jnp.full((B,), 8, jnp.int32)  # primed window (src/decoder.rs:21)
    (_, _), syms = jax.lax.scan(
        step, (init_state((B,)), cursor0), None, length=block_len
    )
    return syms.T  # (B, L)
