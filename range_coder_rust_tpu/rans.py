"""Interleaved word-renormalized rANS — the fast device profile ("rans16").

Why this exists.  The reference coder (a carryless range coder,
/root/reference/src/range_coder.rs) is inherently encoder-emits-the-past /
decoder-consumes-the-future: the decoder's 8-byte window makes its byte
consumption at step ``t`` lag the encoder's emission by exactly 8 bytes, so
a lane-interleaved shared stream (kernels/interleave.py) can only be built
by a byte-granular permutation after encoding — a data-dependent byte
scatter over the whole stream.  rANS flips the
asymmetry: the encoder runs *backward* over the symbols, which makes the
halfwords it emits at step ``t`` exactly the halfwords the decoder refills
at step ``t``.  The interleaved stream can therefore be written directly by
the encoder and read directly by the decoder, both at a uniformly-
advancing cursor plus each lane's rank among the lanes that move a halfword.

This profile intentionally does NOT reproduce the reference's byte streams
(the planar profile, blocks.py, remains the byte-exact conformance path).
It reproduces the reference's *capabilities* — model-driven lossless coding
with the same pow2-normalized tables and the same compressed-size ballpark —
at device speed.  Round-trip exactness is property-tested; compressed size is
benchmarked against the reference-semantics scalar coder.

## The coder (fixed k = 16)

State ``x``: an unsigned integer in ``I = [2^32, 2^48)``.  Tables: the
standard pow2 layout (models/table.py): ``c[s] >= 1``, exclusive prefix
``cum[s]``, ``cum[A] = 2^16``.

Encode one symbol ``s`` (iterating t = L-1 .. 0):

    if x >= c[s] << 32:          # one u32 compare: x.hi >= c[s]
        emit halfword x & 0xFFFF  # u16, little-endian in the stream
        x >>= 16                  # now x < 2^32 <= c << 32
    q, r = divmod(x, c[s])        # q < 2^32 (exact; two 32-bit integer
                                  #  divisions on device)
    x = (q << 16) | (cum[s] + r)  # cum + r < 2^16; x back in I

Decode one symbol (iterating t = 0 .. L-1):

    slot = x & 0xFFFF
    s = largest s with cum[s] <= slot          # same search as the decoder
    x = c[s] * (x >> 16) + slot - cum[s]       # no division!
    if x < 2^32:
        x = (x << 16) | next_halfword          # refill, at most one

Correctness of the interval discipline: pre-step ``x in I``; the emit
branch leaves ``x in [c·2^16, 2^32)``; the no-emit branch has
``x in [2^32, c·2^32)``; both give ``q in [2^16, 2^32)`` so the update
lands back in ``[2^32, 2^48)``.  Decode inverts each step exactly, and
``c·(x>>16) >= 2^16`` guarantees a single refill restores the interval.
Rate loss vs entropy from the 16-bit renorm is ~2^-16 per renorm —
immaterial (verified by the size benchmarks).

## Interleaved group stream layout (profile "rans16")

``G = GROUP_LANES`` lanes per group; lane ``l`` encodes the group's
``l``-th length-``L`` segment.  Group stream bytes:

* preamble: lane ``l``'s final encoder state (= the decoder's initial
  state), 8 bytes little-endian, at ``[8l, 8l+8)``;
* then for step ``t = 0..L-1``: the halfwords (u16 LE) of every lane that
  refills at step ``t``, in flat lane order — written by the encoder at its
  (backward) step ``t``, consumed by the decoder at its step ``t``.

The encoder discovers region sizes back-to-front, so it writes the region
section right-aligned into its capacity buffer; the host (or caller) slides
it against the preamble when assembling the container.

This module is the executable spec: lane-vectorized NumPy uint64
implementations used as the oracle for the Pallas kernels and for size
accounting.  Hot-path device implementations live in kernels/rans_*.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: lanes per group, the default container geometry.  Each step of a
#: group is one serial dependency chain, so wider groups spread its
#: latency over more symbols; the cost is container state overhead
#: (6 B/lane preamble: +6 KB per 67M-symbol group = +0.0007 bits/sym).
#: Kernels and container parse are width-generic: streams written at
#: other widths still decode.
GROUP_LANES = 2048

#: halfwords per container tile: a tile is ``TILE_HALFWORDS // G`` steps,
#: so its region (at most one halfword per lane-step) never exceeds this.
#: A format constant — the per-tile size table and the sync points of
#: every container are counted in these tiles.
TILE_HALFWORDS = 65536


def tile_steps_for(group_lanes: int) -> int:
    """Steps per container tile for a group width."""
    return max(1, TILE_HALFWORDS // group_lanes)

#: table precision — the rans16 profile is specialized to 2^16 totals
K = 16

_LO16 = np.uint64(0xFFFF)
_ST_MIN = np.uint64(1) << np.uint64(32)  # 2^32, bottom of the state interval


def encode_lanes(
    symbols: np.ndarray, c: np.ndarray, cum: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lane-vectorized reference encoder.

    Arguments:
      symbols: (B, L) int array of symbol indices (B lanes in lock-step).
      c / cum: pow2 tables with ``cum[A] == 2**16`` (models/table.py).

    Returns ``(states, regions, counts)``:
      states: (B,) uint64 final states (the decoder's initial states);
      regions: list of L uint16 arrays — regions[t] = halfwords the decoder
        refills at step t, flat-lane-ordered;
      counts: (L,) int32 region sizes (halfwords).
    """
    B, L = symbols.shape
    c64 = c.astype(np.uint64)
    cum64 = cum.astype(np.uint64)
    x = np.full(B, _ST_MIN, np.uint64)
    regions: list[np.ndarray] = [None] * L  # type: ignore[list-item]
    counts = np.zeros(L, np.int32)
    for t in range(L - 1, -1, -1):
        s = symbols[:, t]
        cs = c64[s]
        emit = x >= (cs << np.uint64(32))
        if emit.any():
            regions[t] = (x[emit] & _LO16).astype(np.uint16)
            counts[t] = int(emit.sum())
            x = np.where(emit, x >> np.uint64(16), x)
        else:
            regions[t] = np.zeros(0, np.uint16)
        q = x // cs
        r = x - q * cs
        x = (q << np.uint64(16)) | (cum64[s] + r)
    return x, regions, counts


def decode_lanes(
    states: np.ndarray,
    halfwords: np.ndarray,
    block_len: int,
    c: np.ndarray,
    cum: np.ndarray,
) -> np.ndarray:
    """Lane-vectorized reference decoder (mirror of :func:`encode_lanes`).

    ``halfwords``: the concatenated region section (uint16, in stream
    order).  Returns (B, L) int32 symbols; asserts the end-state invariant
    (every lane returns to 2^32 — the encoder's initial state).
    """
    B = states.shape[0]
    c64 = c.astype(np.uint64)
    cum64 = cum.astype(np.uint64)
    cum_search = cum.astype(np.uint32)
    x = states.astype(np.uint64).copy()
    out = np.empty((B, block_len), np.int32)
    cursor = 0
    for t in range(block_len):
        slot = (x & _LO16).astype(np.uint32)
        s = np.searchsorted(cum_search, slot, side="right") - 1
        out[:, t] = s
        x = c64[s] * (x >> np.uint64(16)) + (slot.astype(np.uint64) - cum64[s])
        refill = x < _ST_MIN
        n = int(refill.sum())
        if n:
            h = halfwords[cursor : cursor + n].astype(np.uint64)
            cursor += n
            xr = x[refill]
            x[refill] = (xr << np.uint64(16)) | h
    assert np.all(x == _ST_MIN), "rans end-state invariant violated"
    return out


def build_group_stream(
    states: np.ndarray, regions, counts
) -> bytes:
    """Assemble one group's stream bytes (preamble + region section)."""
    out = bytearray(states.astype("<u8").tobytes())
    for t in range(len(counts)):
        out += regions[t].astype("<u2").tobytes()
    return bytes(out)


def split_group_stream(
    stream: bytes, n_lanes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`build_group_stream`: (states, halfwords)."""
    pre = 8 * n_lanes
    states = np.frombuffer(stream[:pre], dtype="<u8").astype(np.uint64)
    body = stream[pre:]
    if len(body) % 2:
        raise ValueError("rans16 region section must be halfword-aligned")
    return states, np.frombuffer(body, dtype="<u2").astype(np.uint16)


def roundtrip_group(symbols: np.ndarray, c, cum) -> Tuple[bytes, np.ndarray]:
    """Encode + decode one group of lanes; returns (stream, decoded)."""
    states, regions, counts = encode_lanes(symbols, c, cum)
    stream = build_group_stream(states, regions, counts)
    st2, hw = split_group_stream(stream, symbols.shape[0])
    dec = decode_lanes(st2, hw, symbols.shape[1], c, cum)
    return stream, dec
