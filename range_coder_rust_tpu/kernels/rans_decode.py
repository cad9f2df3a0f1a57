"""rans16 decode kernel (Pallas, Triton route).

One program per group, the ``G`` lanes as the block vector, the state in
registers and the ``L`` steps as a loop inside the program — the mirror of
kernels/rans_encode.py.  Per step, for every lane at once:

  1. ``slot = x & 0xFFFF``;
  2. the symbol: largest ``s`` with ``cum[s] <= slot``, by a binary
     search over the group's cum table (measured faster on an H100 than
     one gather from a 2^16-entry slot -> symbol table);
  3. ``x = c * (x >> 16) + slot - cum`` (no division);
  4. lanes with ``x < 2^32`` refill one halfword each.  The refilling
     lanes' halfwords are consecutive in the group's region section, in
     lane order (rans.py layout), so a lane's halfword sits at the
     stream cursor plus its exclusive rank among the refilling lanes.

The state ``x`` lives in ``[2^32, 2^48)`` as two u32 limbs (``hi``, ``lo``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .backend import PALLAS_BACKEND
from .rans_encode import TABLE_SIZE, num_warps

_U32 = jnp.uint32
_I32 = jnp.int32

def cum_rows(c) -> np.ndarray:
    """(A,) or (T, A) counts -> (T, TABLE_SIZE) u32 exclusive cum tables,
    padded with 2^16 (above every slot)."""
    c2 = np.atleast_2d(np.asarray(c, np.int64))
    T, a = c2.shape
    if a > TABLE_SIZE - 1:
        raise ValueError(f"alphabet {a} exceeds {TABLE_SIZE - 1} symbols")
    out = np.full((T, TABLE_SIZE), 1 << 16, np.uint32)
    out[:, :a] = np.cumsum(c2, axis=1) - c2
    return out


def _decode_kernel(stream_ref, off_ref, hi_ref, lo_ref, cum_ref, out_ref,
                   *, n_steps, lanes, per_group, search_iters, stream_len):
    g = pl.program_id(0)
    tab = g * TABLE_SIZE if per_group else 0

    def body(t, carry):
        xhi, xlo, base = carry
        slot = xlo & _U32(0xFFFF)
        # binary search over [0, 2^search_iters) — entries past the
        # alphabet hold 2^16, above every slot
        lo = jnp.zeros((lanes,), _I32)
        hi = jnp.full((lanes,), 1 << search_iters, _I32)
        for _ in range(search_iters):
            mid = (lo + hi) >> 1
            go = cum_ref[tab + mid] <= slot
            lo = jnp.where(go, mid, lo)
            hi = jnp.where(go, hi, mid)
        s = lo
        cum = cum_ref[tab + s]
        c = cum_ref[tab + s + 1] - cum

        # x = c * (x >> 16) + (slot - cum), c <= 2^16: two 16x32 products
        q = (xlo >> _U32(16)) | (xhi << _U32(16))
        p_lo = c * (q & _U32(0xFFFF))
        p_hi = c * (q >> _U32(16))
        nlo = (p_hi << _U32(16)) + p_lo
        nhi = (p_hi >> _U32(16)) + (nlo < p_lo).astype(_U32)
        d = nlo + (slot - cum)
        nhi = nhi + (d < nlo).astype(_U32)

        refill = nhi == 0
        r = refill.astype(_I32)
        idx = jnp.minimum(base + jnp.cumsum(r) - r, stream_len - 1)
        h = stream_ref[idx].astype(_U32)
        xhi = jnp.where(refill, d >> _U32(16), nhi)
        xlo = jnp.where(refill, (d << _U32(16)) | h, d)
        out_ref[pl.ds((g * n_steps + t) * lanes, lanes)] = s.astype(
            out_ref.dtype)
        return xhi, xlo, base + jnp.sum(r)

    jax.lax.fori_loop(
        0, n_steps, body,
        (hi_ref[pl.ds(g * lanes, lanes)], lo_ref[pl.ds(g * lanes, lanes)],
         off_ref[g]))


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "a_count", "out_dtype", "interpret"))
def rans_decode(stream, offsets, hi, lo, cum, *, n_steps: int, a_count: int,
                out_dtype, interpret: bool):
    """Decode every group's region section back to step-major symbols.

    Arguments:
      stream: (S,) uint16 — all groups' region sections, concatenated
        (S >= 1).
      offsets: (NG,) int32 — where group g's section starts in ``stream``.
      hi, lo: (NG, G) uint32 initial lane states.
      cum: (TABLE_SIZE,) shared or (NG, TABLE_SIZE) per-group cum tables
        (:func:`cum_rows`).
      n_steps: steps L to decode.
      a_count: alphabet size (sets the search depth).

    Returns (NG, L, G) symbols in ``out_dtype``.
    """
    NG, G = hi.shape
    if NG * n_steps * G >= 1 << 31:
        raise ValueError("one decode call is limited to < 2^31 symbols")
    kern = functools.partial(
        _decode_kernel, n_steps=n_steps, lanes=G, per_group=cum.ndim == 2,
        search_iters=max(0, (a_count - 1).bit_length()),
        stream_len=stream.shape[0])
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((NG * n_steps * G,), out_dtype),
        grid=(NG,),
        compiler_params=plt.CompilerParams(num_warps=num_warps(G),
                                           num_stages=1),
        backend=PALLAS_BACKEND,
        interpret=interpret,
        name="rans16_decode",
    )(stream, offsets, hi.reshape(-1), lo.reshape(-1), cum.reshape(-1))
    return out.reshape(NG, n_steps, G)
