"""u64 arithmetic as (hi, lo) uint32 limb pairs — the device word type.

JAX runs with 32-bit integer types unless x64 mode is on, and the framework
keeps it off; the reference keeps its coding interval in
two ``u64`` registers (reference src/range_coder.rs:7-12).  This module gives
the framework an exact, fully vectorizable u64: every function operates
elementwise over arbitrarily-shaped uint32 arrays, works identically under
``jit`` / ``vmap`` / ``scan`` / Pallas, and is property-tested against NumPy
uint64 (tests/test_u64.py).

Only the operations the coder needs exist:

* add / sub / compares (carry- and borrow-propagating);
* logical ops and static or *dynamic* shifts (guarded so no hardware shift
  ever sees an amount >= the lane width, which XLA leaves undefined);
* ``clz`` — the renormalization loops of the reference
  (src/range_coder.rs:83-89) collapse into closed-form byte counts via
  count-leading-zeros (see ops/transition.py);
* 64x32 multiplies (low-64 and full 96-bit) built from 16-bit partial
  products — a u32 multiply is mod 2^32, so wide products are assembled
  the SWAR way;
* exact u64/u32 divmod (digit-recurrence; used by the arbitrary-total mode
  mirroring ``range/total`` at src/range_coder.rs:38-40) and a fast
  estimate-and-correct u64/u64 quotient for the decoder's
  ``(data - lower) / rpt`` (reference examples/sample_impl.rs:29-30).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


class U64(NamedTuple):
    """A u64 value as two uint32 limbs.  NamedTuple => a JAX pytree."""

    hi: jax.Array
    lo: jax.Array


# ---------------------------------------------------------------------------
# construction / host interop
# ---------------------------------------------------------------------------

def make(hi, lo) -> U64:
    return U64(jnp.asarray(hi, _U32), jnp.asarray(lo, _U32))


def from_int(x: int, shape: Tuple[int, ...] = ()) -> U64:
    """Broadcast a Python int (0 <= x < 2**64) to a U64 of ``shape``."""
    if not 0 <= x < 1 << 64:
        raise ValueError(f"{x} out of u64 range")
    return U64(
        jnp.full(shape, (x >> 32) & 0xFFFFFFFF, _U32),
        jnp.full(shape, x & 0xFFFFFFFF, _U32),
    )


def from_np(a: np.ndarray) -> U64:
    a = np.asarray(a, dtype=np.uint64)
    return U64(
        jnp.asarray((a >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(a.astype(np.uint32)),
    )


def to_np(a: U64) -> np.ndarray:
    hi = np.asarray(a.hi, dtype=np.uint64)
    lo = np.asarray(a.lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


# ---------------------------------------------------------------------------
# add / sub / compare
# ---------------------------------------------------------------------------

def add(a: U64, b: U64) -> U64:
    """(a + b) mod 2**64."""
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64(a.hi + b.hi + carry, lo)


def add_overflow(a: U64, b: U64) -> Tuple[U64, jax.Array]:
    """(a + b) mod 2**64 plus the carry out of bit 63 (bool).

    The carry flag is the vector analogue of the reference's
    ``overflowing_add`` checks (src/range_coder.rs:68-70, :139)."""
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    hi = a.hi + b.hi
    of1 = hi < a.hi
    hi2 = hi + carry
    of2 = hi2 < hi
    return U64(hi2, lo), jnp.logical_or(of1, of2)


def sub(a: U64, b: U64) -> U64:
    """(a - b) mod 2**64."""
    borrow = (a.lo < b.lo).astype(_U32)
    return U64(a.hi - b.hi - borrow, a.lo - b.lo)


def lt(a: U64, b: U64) -> jax.Array:
    return jnp.logical_or(
        a.hi < b.hi, jnp.logical_and(a.hi == b.hi, a.lo < b.lo)
    )


def ge(a: U64, b: U64) -> jax.Array:
    return jnp.logical_not(lt(a, b))


def eq(a: U64, b: U64) -> jax.Array:
    return jnp.logical_and(a.hi == b.hi, a.lo == b.lo)


def is_zero(a: U64) -> jax.Array:
    return jnp.logical_and(a.hi == 0, a.lo == 0)


def select(pred: jax.Array, a: U64, b: U64) -> U64:
    return U64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


# ---------------------------------------------------------------------------
# logical ops
# ---------------------------------------------------------------------------

def bit_and(a: U64, b: U64) -> U64:
    return U64(a.hi & b.hi, a.lo & b.lo)


def bit_or(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


def bit_xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def bit_not(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


# ---------------------------------------------------------------------------
# shifts
# ---------------------------------------------------------------------------
# XLA leaves shifts by >= lane width undefined; every dynamic shift below is
# guarded so hardware only ever sees amounts in [0, 31].

def _sll32(x: jax.Array, n: jax.Array) -> jax.Array:
    """x << n for int32 n of any value; 0 outside [0, 32)."""
    ok = jnp.logical_and(n >= 0, n < 32)
    amt = jnp.clip(n, 0, 31).astype(_U32)
    return jnp.where(ok, x << amt, _U32(0))


def _srl32(x: jax.Array, n: jax.Array) -> jax.Array:
    """x >> n (logical) for int32 n of any value; 0 outside [0, 32)."""
    ok = jnp.logical_and(n >= 0, n < 32)
    amt = jnp.clip(n, 0, 31).astype(_U32)
    return jnp.where(ok, x >> amt, _U32(0))


def shl(a: U64, n) -> U64:
    """a << n (mod 2**64) for dynamic n; 0 when n >= 64."""
    n = jnp.asarray(n, jnp.int32)
    lo = _sll32(a.lo, n)
    hi = _sll32(a.hi, n) | _srl32(a.lo, 32 - n) | _sll32(a.lo, n - 32)
    zero = n >= 64
    return U64(jnp.where(zero, _U32(0), hi), jnp.where(zero, _U32(0), lo))


def shr(a: U64, n) -> U64:
    """a >> n (logical) for dynamic n; 0 when n >= 64."""
    n = jnp.asarray(n, jnp.int32)
    hi = _srl32(a.hi, n)
    lo = _srl32(a.lo, n) | _sll32(a.hi, 32 - n) | _srl32(a.hi, n - 32)
    zero = n >= 64
    return U64(jnp.where(zero, _U32(0), hi), jnp.where(zero, _U32(0), lo))


def shli(a: U64, n: int) -> U64:
    """a << n for static Python int n."""
    if n == 0:
        return a
    if n >= 64:
        z = jnp.zeros_like(a.lo)
        return U64(z, z)
    if n >= 32:
        return U64(a.lo << _U32(n - 32) if n > 32 else a.lo, jnp.zeros_like(a.lo))
    return U64((a.hi << _U32(n)) | (a.lo >> _U32(32 - n)), a.lo << _U32(n))


def shri(a: U64, n: int) -> U64:
    """a >> n (logical) for static Python int n."""
    if n == 0:
        return a
    if n >= 64:
        z = jnp.zeros_like(a.lo)
        return U64(z, z)
    if n >= 32:
        return U64(jnp.zeros_like(a.hi), a.hi >> _U32(n - 32) if n > 32 else a.hi)
    return U64(a.hi >> _U32(n), (a.lo >> _U32(n)) | (a.hi << _U32(32 - n)))


# ---------------------------------------------------------------------------
# clz / popcount
# ---------------------------------------------------------------------------

def popcount32(x: jax.Array) -> jax.Array:
    x = x - ((x >> _U32(1)) & _U32(0x55555555))
    x = (x & _U32(0x33333333)) + ((x >> _U32(2)) & _U32(0x33333333))
    x = (x + (x >> _U32(4))) & _U32(0x0F0F0F0F)
    return (x * _U32(0x01010101)) >> _U32(24)


def clz32(x: jax.Array) -> jax.Array:
    """Count leading zeros of a uint32 (32 for x == 0)."""
    x = x | (x >> _U32(1))
    x = x | (x >> _U32(2))
    x = x | (x >> _U32(4))
    x = x | (x >> _U32(8))
    x = x | (x >> _U32(16))
    return (_U32(32) - popcount32(x)).astype(jnp.int32)


def clz(a: U64) -> jax.Array:
    """Count leading zeros of a u64 (64 for zero), int32."""
    return jnp.where(a.hi != 0, clz32(a.hi), 32 + clz32(a.lo))


# ---------------------------------------------------------------------------
# multiplies (16-bit partial products: a u32 multiply is mod 2^32)
# ---------------------------------------------------------------------------

def mul32_wide(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Full 32x32 -> 64 product as (hi, lo) uint32."""
    a0 = a & _U32(0xFFFF)
    a1 = a >> _U32(16)
    b0 = b & _U32(0xFFFF)
    b1 = b >> _U32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10
    mid_carry = (mid < p01).astype(_U32)  # overflow of the 2^16-weighted sum
    lo = p00 + (mid << _U32(16))
    lo_carry = (lo < p00).astype(_U32)
    hi = p11 + (mid >> _U32(16)) + (mid_carry << _U32(16)) + lo_carry
    return hi, lo


def mul_u64_u32(a: U64, b: jax.Array) -> U64:
    """(a * b) mod 2**64 for uint32 b."""
    b = jnp.asarray(b, _U32)
    hi_p, lo_p = mul32_wide(a.lo, b)
    return U64(hi_p + a.hi * b, lo_p)


def mul_u64_u32_wide(a: U64, b: jax.Array) -> Tuple[jax.Array, U64]:
    """Full (a * b) for uint32 b as (carry_limb, low64): a 96-bit result."""
    b = jnp.asarray(b, _U32)
    h0, l0 = mul32_wide(a.lo, b)
    h1, l1 = mul32_wide(a.hi, b)
    mid = h0 + l1
    carry = (mid < h0).astype(_U32)
    return h1 + carry, U64(mid, l0)


# ---------------------------------------------------------------------------
# division
# ---------------------------------------------------------------------------

def divmod_u32(a: U64, d: jax.Array) -> Tuple[U64, jax.Array]:
    """Exact (a // d, a % d) for uint32 d >= 1.

    Digit-recurrence: the high limb uses the hardware u32 divide; the
    remaining 64/32 step runs 32 exact shift-subtract iterations.  This is
    the general-total path mirroring ``range / total_freq``
    (reference src/range_coder.rs:38-40); the flagship pow2-total mode never
    calls it per symbol (division becomes ``shr``).
    """
    d = jnp.asarray(d, _U32)
    q_hi = a.hi // d
    r_hi = a.hi % d  # < d <= 2^32 - 1

    def body(i, carry):
        q_lo, rem = carry  # rem < d
        bit = (a.lo >> (_U32(31) - jnp.asarray(i, _U32))) & _U32(1)
        # rem2 = rem * 2 + bit, up to 2^33 - 1: track the carry-out bit.
        rem2 = (rem << _U32(1)) | bit
        rem2_hi = rem >> _U32(31)  # bit 32 of rem*2
        # subtract d if rem2 (33-bit) >= d
        geq = jnp.logical_or(rem2_hi != 0, rem2 >= d)
        rem3 = jnp.where(geq, rem2 - d, rem2)  # exact mod 2^32 even w/ borrow
        q_lo2 = (q_lo << _U32(1)) | geq.astype(_U32)
        return (q_lo2, rem3)

    q_lo, rem = jax.lax.fori_loop(
        0, 32, body, (jnp.zeros_like(a.lo), r_hi)
    )
    return U64(q_hi, q_lo), rem


#: Safety margin subtracted from the float quotient estimate, and the number
#: of fixed correction steps.  The f32 estimate built from clz-normalized
#: 24-bit mantissas has absolute error well below 1 for quotients < 2^24;
#: the margin guards against f32 division that is not correctly rounded.
_DIV_EST_MARGIN = 2
_DIV_FIX_STEPS = 5


def div_small_q(x: U64, y: U64) -> jax.Array:
    """floor(x / y) as uint32, exact, for quotients < 2**24 - 8.

    The decoder's hot division ``(data - lower) / rpt``
    (reference examples/sample_impl.rs:29-30): with total_freq <= 2^16 the
    quotient fits 17 bits.  Strategy: estimate from clz-normalized 24-bit
    mantissas in f32, subtract a safety margin so the estimate is a
    guaranteed underestimate, then run fixed exact correction steps
    (compare/subtract in u64).  y must be >= 1.
    """
    sx = clz(x)
    sy = clz(y)
    # top 24 bits of each operand as exact f32 mantissas (cast through i32:
    # values < 2^24, exact in an i32 -> f32 cast)
    mx = shr(shl(x, sx), 40).lo.astype(jnp.int32).astype(jnp.float32)
    my = shr(shl(y, sy), 40).lo.astype(jnp.int32).astype(jnp.float32)
    # x ~= mx * 2^(40 - sx), y ~= my * 2^(40 - sy)  (my truncated => q overestimates
    # by < 2^-23 relative; margin below swallows it)
    e = (sy - sx).astype(jnp.float32)
    q_f = jnp.floor((mx / my) * jnp.exp2(e))
    q_f = jnp.clip(q_f, 0.0, 16777200.0)  # < 2^24, exact in f32
    q = q_f.astype(jnp.int32).astype(_U32)
    q = jnp.where(q > _U32(_DIV_EST_MARGIN), q - _U32(_DIV_EST_MARGIN), _U32(0))
    # rem = x - q*y  (underestimate => q*y <= x fits u64, rem >= 0)
    rem = sub(x, mul_u64_u32(y, q))
    for _ in range(_DIV_FIX_STEPS):
        step_ok = ge(rem, y)
        q = q + step_ok.astype(_U32)
        rem = select(step_ok, sub(rem, y), rem)
    return q


# ---------------------------------------------------------------------------
# byte helpers
# ---------------------------------------------------------------------------

def byte(a: U64, i) -> jax.Array:
    """Byte ``i`` of a u64, 0 = most significant (dynamic i); 0 for i >= 8."""
    i = jnp.asarray(i, jnp.int32)
    return shr(a, 56 - 8 * i).lo & _U32(0xFF)
