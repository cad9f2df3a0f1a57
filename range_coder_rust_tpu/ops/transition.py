"""Closed-form per-symbol coder transition (the vector replacement for the
reference's renormalization loops).

The reference advances one symbol with ``param_update``
(src/range_coder.rs:53-92): interval math followed by two data-dependent
``while`` loops — all no-carry expansions (src/range_coder.rs:110-116), then
all range-reduction expansions (src/range_coder.rs:126-135) — each emitting
one byte per iteration.  Data-dependent loops are poison for SIMD lanes and
for XLA, so this module derives the *exact same* state transition in closed
form.  Derivation (proved against the scalar golden model in
tests/test_transition.py):

Let ``low' , rng'`` be the interval after the multiply/add step and
``up' = low' + rng'`` (no u64 overflow — carryless invariant, SURVEY.md §3).

* **No-carry loop count** ``n1``: the loop emits while the top byte of lower
  and upper agree; shifting left by 8 preserves agreement of the remaining
  bytes, so ``n1 = clz(low' ^ up') // 8`` — the number of leading bytes on
  which the two bounds agree (<= 7 since ``rng' > 0``).
* **Range-reduction loop count** ``n2``: with ``low1 = low' << 8*n1`` and
  ``rng1 = rng' << 8*n1``, the loop runs at all iff ``rng1 < 2^48``; its
  iteration ``j+1`` runs iff byte ``5-(j-1)`` of ``low1`` equals 0xFF
  (each iteration's next-condition ``(~l & (2^48-1)) < 2^40`` is exactly
  "bits 40..47 of l all ones").  Hence
  ``n2 = 1 + (count of consecutive 0xFF bytes of low1 from byte 5 down)``
  capped at 7, and the count is again a clz: ``clz(~low1 << 16) // 8``.
* **Emitted bytes**: every iteration of either loop emits the then-top byte
  of the running lower bound, which telescopes to *the top ``n1+n2`` bytes
  of ``low'``* (bytes shifted in from the right are zeros, covering the
  n1+n2 > 8 tail).  So the per-symbol emission is fully described by
  ``(low', n)`` — no byte buffer needed inside the hot loop.
* **Final state**: ``low2 = low1 << 8*n2``;
  ``rng2 = (~(low1 << 8*(n2-1)) & (2^48-1)) << 8`` when the reduction loop
  ran, else ``rng1``.

Everything is elementwise over uint32 limb arrays: one coder per vector lane
(the framework's "lane interleaving", SURVEY.md §2) with no cross-lane
dependencies.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import u64
from .u64 import U64

_U32 = jnp.uint32

#: Max bytes one transition can emit: n1 <= 7 and n2 <= 7 (SURVEY.md §3
#: invariant 3; mirrors core/rc64.py MAX_BYTES_PER_SYMBOL).
EMIT_MAX = 14

#: 2^48 — the range floor below which reduction renorm fires
#: (reference src/range_coder.rs:24).
_TOP16_INT = 1 << 48


class CoderState(NamedTuple):
    """Vector coder state: one (lower_bound, range) interval per lane
    (reference src/range_coder.rs:7-12)."""

    low: U64
    rng: U64


def init_state(shape: Tuple[int, ...] = ()) -> CoderState:
    """Fresh interval (0, 2^64-1) per lane (reference src/range_coder.rs:15-18)."""
    return CoderState(
        low=u64.from_int(0, shape), rng=u64.from_int((1 << 64) - 1, shape)
    )


def _lzb3(v: jax.Array) -> jax.Array:
    """Leading zero bytes of a uint32, capped at 3 (compare ladder — far
    cheaper on the VPU than a full bit-twiddling clz)."""
    return (
        (v < _U32(1 << 24)).astype(jnp.int32)
        + (v < _U32(1 << 16)).astype(jnp.int32)
        + (v < _U32(1 << 8)).astype(jnp.int32)
    )


def _lzb(a: U64) -> jax.Array:
    """Leading zero bytes of a u64 (7 for a == 0 — callers cap below 8)."""
    return jnp.where(a.hi == 0, 4 + _lzb3(a.lo), _lzb3(a.hi))


def _renorm(low_u: U64, rng_u: U64) -> Tuple[CoderState, U64, jax.Array]:
    """Shared closed-form renormalization: returns (state', emit_low, n)."""
    up = u64.add(low_u, rng_u)  # no overflow under the carryless invariant
    # x = low ^ up is nonzero (rng > 0), so the 7-cap of _lzb is exact
    n1 = _lzb(u64.bit_xor(low_u, up))  # 0..7
    low1 = u64.shl(low_u, 8 * n1)
    rng1 = u64.shl(rng_u, 8 * n1)

    # range-reduction loop count (reference src/range_coder.rs:126-135)
    need = u64.lt(rng1, u64.from_int(_TOP16_INT, low1.hi.shape))
    # consecutive 0xFF bytes of low1 from byte 5 down = leading zero bytes
    # of ~low1 << 16 (_lzb saturates at 7 for zero; the cap keeps <= 6)
    n_ff = _lzb(u64.shli(u64.bit_not(low1), 16))
    n_ff = jnp.minimum(n_ff, 6)
    n2 = jnp.where(need, 1 + n_ff, 0)

    low2 = u64.shl(low1, 8 * n2)
    mask48 = u64.from_int(_TOP16_INT - 1, low1.hi.shape)
    last_low = u64.shl(low1, 8 * (n2 - 1))  # lower at the loop's last iteration
    red_rng = u64.shl(u64.bit_and(u64.bit_not(last_low), mask48), 8)
    rng2 = u64.select(need, red_rng, rng1)

    n = (n1 + n2).astype(jnp.int32)
    return CoderState(low2, rng2), low_u, n


def param_update_pow2(
    state: CoderState, c: jax.Array, cum: jax.Array, k: int
) -> Tuple[CoderState, U64, jax.Array]:
    """One symbol with a power-of-two total frequency ``total = 2**k``.

    The flagship device mode: tables are normalized so the reference's hot
    u64 division ``rpt = range / total`` (src/range_coder.rs:38-40,:62)
    becomes a shift.  Returns ``(new_state, emit_low, n)`` where the stream
    bytes for this symbol are the top ``n`` bytes of ``emit_low``
    (zero-padded past byte 8).

    ``c``/``cum`` are uint32 with ``c >= 1`` and ``cum + c <= 2**k``
    (normalized-table contract, models/table.py); ``k <= 16`` so the
    multiplies are 64x16.
    """
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    rpt = u64.shri(state.rng, k)
    rng_u = u64.mul_u64_u32(rpt, c)  # = rpt * c_freq (src/range_coder.rs:65)
    low_u = u64.add(state.low, u64.mul_u64_u32(rpt, cum))  # :68 (carryless => no ovf)
    return _renorm(low_u, rng_u)


def param_update_div(
    state: CoderState, c: jax.Array, cum: jax.Array, total: jax.Array
) -> Tuple[CoderState, U64, jax.Array]:
    """One symbol with an arbitrary uint32 total frequency.

    Exact mirror of the reference semantics (``rpt = range / total`` via
    true u64/u32 division, src/range_coder.rs:38-40) for models whose totals
    are not normalized; slower than :func:`param_update_pow2` (digit-
    recurrence divide) but bit-identical to the scalar coder for any table.
    """
    rpt, _ = u64.divmod_u32(state.rng, total)
    rng_u = u64.mul_u64_u32(rpt, c)
    low_u = u64.add(state.low, u64.mul_u64_u32(rpt, cum))
    return _renorm(low_u, rng_u)


def decode_find_rfreq(
    state: CoderState, window: U64, k: int
) -> jax.Array:
    """The decoder's target cumulative value for pow2 totals.

    ``rfreq = (data - lower) / (range >> k)`` (reference
    examples/sample_impl.rs:29-30), clamped to ``2**k - 1`` exactly like the
    reference's binary search can never step past the last symbol
    (examples/sample_impl.rs:33-44).  uint32.
    """
    rpt = u64.shri(state.rng, k)
    dl = u64.sub(window, state.low)
    rfreq = u64.div_small_q(dl, rpt)
    return jnp.minimum(rfreq, _U32((1 << k) - 1))


def decode_find_rfreq_div(
    state: CoderState, window: U64, total: jax.Array
) -> jax.Array:
    """Arbitrary-total variant of :func:`decode_find_rfreq` (uint32 total).

    The quotient ``rfreq < total`` can exceed div_small_q's exactness bound
    when ``total`` is large, so big totals take a two-stage divide (16-bit
    quotient halves).  div_small_q clips its estimate at ``2^24 - 16`` and
    corrects by at most a handful of steps, so the single-stage path is only
    safe when every possible quotient (``<= total - 1``) stays below that —
    hence the threshold ``total >= 2^24 - 16`` (not 2^24: totals in
    [2^24-16, 2^24) have reachable quotients above the clip).  For such
    totals ``rpt = range/total < 2^40 * (1 + 2^-20)``, so ``rpt << 16``
    still cannot overflow u64 — the two cases exactly cover each other.
    """
    rpt, _ = u64.divmod_u32(state.rng, total)
    dl = u64.sub(window, state.low)
    # small-total path (quotient < 2^24 - 16)
    q_small = u64.div_small_q(dl, rpt)
    # big-total path: q1 = dl // (rpt << 16) < 2^16, then the remainder
    # over rpt gives the low 16 bits
    big = total >= _U32((1 << 24) - 16)
    rpt16 = u64.shl(rpt, 16)
    safe = u64.select(big, rpt16, u64.from_int(1 << 40, rpt.hi.shape))
    q1 = u64.div_small_q(dl, safe)
    rem1 = u64.sub(dl, u64.mul_u64_u32(safe, q1))
    q2 = u64.div_small_q(rem1, rpt)
    q_big = (q1 << _U32(16)) + q2
    rfreq = jnp.where(big, q_big, q_small)
    return jnp.minimum(rfreq, total - 1)


def flush_state(state: CoderState) -> Tuple[U64, jax.Array]:
    """Finalization: the 8 residual bytes of the lower bound
    (reference src/encoder.rs:40-46).  Returns (emit_low, n=8) shaped like
    one extra transition so the same compaction path handles it.
    """
    n = jnp.full(state.low.hi.shape, 8, jnp.int32)
    return state.low, n
