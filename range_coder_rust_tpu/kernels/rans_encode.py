"""rans16 encode kernel (Pallas, Triton route).

One program per group.  The group's ``G`` lanes are the program's block
vector, the coder state stays in registers, and a loop inside the program
walks the ``L`` steps backward (t = L-1 .. 0) — rANS encodes in reverse, so
the halfwords emitted at step ``t`` are exactly those the decoder refills
at step ``t`` (rans.py).  Per step, for every lane at once:

  1. load the step's symbols (one contiguous row of the step-major input)
     and gather the symbol's packed table word ``cum | (c-1) << 16``;
  2. renorm: lanes with ``x >= c << 32`` (``x.hi >= c``) emit their low
     halfword and shift ``x >>= 16``;
  3. ``q, r = divmod(x, c)`` as two 32-bit integer divisions (base-2^16
     long division: ``x < c << 32`` after renorm, so each partial quotient
     is below 2^16);
  4. ``x = (q << 16) | (cum + r)``;
  5. rank the emitting lanes (``cumsum`` of the emit flags) and scatter
     their halfwords straight to their stream positions.

The state ``x`` lives in ``[2^32, 2^48)`` as two u32 limbs (``hi``, ``lo``).

Output layout: each group owns a private ``L * G``-halfword buffer (one
halfword per lane-step is the worst case, so it cannot overflow).  The
stream is written right-aligned and back to front, so after the loop the
group's region section — every step's halfwords in time order, each in
lane order — is the buffer's last ``sum(counts)`` halfwords.  Per-step
emission counts and the final states are returned for the container.

With ``sync_every = P > 0`` the kernel also records the lane states the
decoder holds before steps P, 2P, ... (tile-level random access).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .backend import PALLAS_BACKEND

_U32 = jnp.uint32
_I32 = jnp.int32

#: entries per symbol-table row: alphabets up to 1023 symbols (A + 1 cum
#: entries must fit, the rans16 API limit)
TABLE_SIZE = 1024


def symbol_words(c) -> np.ndarray:
    """(A,) or (T, A) counts -> (T, TABLE_SIZE) u32 packed per-symbol words
    ``cum[s] | ((c[s] - 1) & 0xFFFF) << 16`` — one gather gives a step
    both table values (``c == 2^16`` packs as 0xFFFF; zero-frequency
    symbols are never coded, their word is don't-care)."""
    c2 = np.atleast_2d(np.asarray(c, np.int64))
    T, a = c2.shape
    if a > TABLE_SIZE - 1:
        raise ValueError(f"alphabet {a} exceeds {TABLE_SIZE - 1} symbols")
    cum = np.cumsum(c2, axis=1) - c2
    out = np.zeros((T, TABLE_SIZE), np.uint32)
    out[:, :a] = (cum | (((c2 - 1) & 0xFFFF) << 16)).astype(np.uint32)
    return out


def num_warps(lanes: int) -> int:
    """Warps per program: 4 lanes per thread, between 4 and 16 warps (16
    warps measured fastest for both kernels at the 2048-lane default on
    an H100)."""
    return int(min(16, max(4, lanes // 128)))


def _encode_kernel(sym_ref, word_ref, buf_ref, cnt_ref, hi_ref, lo_ref,
                   *sync_refs, n_steps, lanes, per_group, sync_every,
                   n_sync):
    g = pl.program_id(0)
    cap = n_steps * lanes
    tab = g * TABLE_SIZE if per_group else 0
    end = (g + 1) * cap  # this group's buffer ends here

    def body(i, carry):
        xhi, xlo, used = carry
        t = n_steps - 1 - i
        s = sym_ref[pl.ds((g * n_steps + t) * lanes, lanes)].astype(_I32)
        w = word_ref[tab + s]
        cum = w & _U32(0xFFFF)
        c = (w >> _U32(16)) + _U32(1)

        # renorm: emit the low halfword where x >= c << 32
        emit = xhi >= c
        h = xlo & _U32(0xFFFF)
        xlo = jnp.where(emit, (xlo >> _U32(16)) | (xhi << _U32(16)), xlo)
        xhi = jnp.where(emit, xhi >> _U32(16), xhi)

        # q, r = divmod(x, c), x = xhi * 2^32 + xlo with xhi < c <= 2^16
        n1 = (xhi << _U32(16)) | (xlo >> _U32(16))
        q1 = jax.lax.div(n1, c)
        n2 = ((n1 - q1 * c) << _U32(16)) | (xlo & _U32(0xFFFF))
        q2 = jax.lax.div(n2, c)
        r = n2 - q2 * c
        # x' = (q << 16) | (cum + r), q = q1 << 16 | q2
        xhi = q1
        xlo = (q2 << _U32(16)) | (cum + r)

        e = emit.astype(_I32)
        n_emit = jnp.sum(e)
        pos = end - used - n_emit + (jnp.cumsum(e) - e)
        plt.store(buf_ref.at[pos], h.astype(jnp.uint16), mask=emit)
        cnt_ref[g * n_steps + t] = n_emit
        used = used + n_emit

        if sync_every:
            sync_hi_ref, sync_lo_ref = sync_refs

            # t >= 0, so rem/div are mod/floor-div (lax's forms lower
            # on the GPU; jnp's sign-correcting % and // do not)
            period = jnp.int32(sync_every)

            @pl.when(jnp.logical_and(jax.lax.rem(t, period) == 0, t > 0))
            def _():
                base = (g * n_sync + jax.lax.div(t, period) - 1) * lanes
                sync_hi_ref[pl.ds(base, lanes)] = xhi
                sync_lo_ref[pl.ds(base, lanes)] = xlo

        return xhi, xlo, used

    xhi0 = jnp.ones((lanes,), _U32)     # x = 2^32
    xlo0 = jnp.zeros((lanes,), _U32)
    xhi, xlo, _ = jax.lax.fori_loop(
        0, n_steps, body, (xhi0, xlo0, jnp.int32(0)))
    hi_ref[pl.ds(g * lanes, lanes)] = xhi
    lo_ref[pl.ds(g * lanes, lanes)] = xlo


@functools.partial(
    jax.jit, static_argnames=("sync_every", "interpret"))
def rans_encode(sym, words, *, sync_every: int = 0, interpret: bool):
    """Encode step-major symbols into per-group right-aligned regions.

    Arguments:
      sym: (NG, L, G) symbols, any integer dtype — ``sym[g, t, l]`` is
        lane ``l``'s symbol at step ``t`` (G a power of two).
      words: (TABLE_SIZE,) shared or (NG, TABLE_SIZE) per-group packed
        table words (:func:`symbol_words`).
      sync_every: record states before every ``sync_every``-th step (0 =
        off).
      interpret: Pallas interpret mode (backend.interpret_kernels).

    Returns ``(buf, counts, hi, lo[, sync_hi, sync_lo])``:
      buf: (NG, L * G) uint16 — group g's region section is its last
        ``counts[g].sum()`` halfwords;
      counts: (NG, L) int32 halfwords emitted at each step;
      hi, lo: (NG, G) uint32 final states (the decoder's initial states);
      sync_hi, sync_lo: (NG, n_sync, G) uint32 states before steps
        ``sync_every * (j + 1)``, with ``n_sync = (L - 1) // sync_every``.
    """
    NG, L, G = sym.shape
    if NG * L * G >= 1 << 31:
        raise ValueError("one encode call is limited to < 2^31 symbols")
    per_group = words.ndim == 2
    n_sync = (L - 1) // sync_every if sync_every else 0
    kern = functools.partial(
        _encode_kernel, n_steps=L, lanes=G, per_group=per_group,
        sync_every=sync_every if n_sync else 0, n_sync=n_sync)
    out_shape = [
        jax.ShapeDtypeStruct((NG * L * G,), jnp.uint16),
        jax.ShapeDtypeStruct((NG * L,), _I32),
        jax.ShapeDtypeStruct((NG * G,), _U32),
        jax.ShapeDtypeStruct((NG * G,), _U32),
    ]
    if n_sync:
        out_shape += [jax.ShapeDtypeStruct((NG * n_sync * G,), _U32)] * 2
    outs = pl.pallas_call(
        kern,
        out_shape=tuple(out_shape),
        grid=(NG,),
        compiler_params=plt.CompilerParams(num_warps=num_warps(G),
                                           num_stages=1),
        backend=PALLAS_BACKEND,
        interpret=interpret,
        name="rans16_encode",
    )(sym.reshape(-1), words.reshape(-1))
    buf, counts, hi, lo = outs[:4]
    res = (buf.reshape(NG, L * G), counts.reshape(NG, L),
           hi.reshape(NG, G), lo.reshape(NG, G))
    if n_sync:
        res += tuple(s.reshape(NG, n_sync, G) for s in outs[4:])
    return res
