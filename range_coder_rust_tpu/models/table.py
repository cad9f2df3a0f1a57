"""Array-native frequency tables — the device-path probability model.

The reference's ``FreqTable`` example model (examples/sample_impl.rs:1-70)
holds per-symbol ``(cum, c)`` plus ``total`` and builds them by counting and
an exclusive-prefix-sum fold (``calc_cum``, examples/sample_impl.rs:61-69).
Here the same model is arrays end-to-end:

* histogram build = one scatter-add (:func:`counts_from_data`);
* ``calc_cum`` = ``jnp.cumsum`` (:func:`cumulative`);
* ``find_index``'s binary search (examples/sample_impl.rs:33-44) =
  ``jnp.searchsorted`` (:func:`find_index`) or a direct rfreq->symbol lookup
  table (:func:`decode_lut`) for shared tables;
* plus the device-first addition: :func:`normalize_pow2`, which renormalizes
  counts to ``total = 2**k`` so the coder's hot division
  (reference src/range_coder.rs:38-40) becomes a shift
  (ops/transition.py:param_update_pow2).  Exact largest-remainder
  apportionment, all u32-limb integer math — deterministic across
  backends, every present symbol keeps ``c >= 1`` (zero-frequency symbols
  are undefined in the reference, src/pmodel.rs:16-18).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import TableError
from ..ops import u64

_U32 = jnp.uint32


class TableArrays(NamedTuple):
    """Device-side table: ``c[A]`` frequencies and ``cum[A+1]`` exclusive
    prefix sums with ``cum[A] == total``.  A JAX pytree."""

    c: jax.Array
    cum: jax.Array


@functools.partial(jax.jit, static_argnames="alphabet")
def counts_from_data(data: jax.Array, alphabet: int) -> jax.Array:
    """Histogram of symbol occurrences (vectorized ``add_alphabet_freq``,
    reference examples/sample_impl.rs:58-60).  uint32 (A,)."""
    return jnp.zeros((alphabet,), _U32).at[data.reshape(-1)].add(1)


def cumulative(counts: jax.Array) -> jax.Array:
    """Exclusive prefix sum with the total appended: ``calc_cum``
    (reference examples/sample_impl.rs:61-69).  uint32 (A+1,)."""
    return jnp.concatenate(
        [jnp.zeros((1,), _U32), jnp.cumsum(counts.astype(_U32), dtype=_U32)]
    )


@functools.partial(jax.jit, static_argnames="k")
def normalize_pow2(counts: jax.Array, k: int) -> jax.Array:
    """Rescale ``counts`` to sum exactly ``2**k``, keeping every nonzero
    count >= 1.  Exact integer largest-remainder apportionment.

    Steps (all vectorized, deterministic):
      1. ``base = clip(floor(counts * 2^k / total), 1)`` for present symbols
         (u64-limb multiply + exact divide — products reach 2^48);
      2. positive deficit -> +1 to the present symbols with the largest
         division remainders (ties broken by symbol index);
      3. negative deficit (min-1 clamps overshot) -> taken from the largest
         allocations first, never below 1.

    Requires ``2**k >=`` number of present symbols (else no assignment with
    all-nonzero frequencies exists) and ``sum(counts) < 2**31`` (int32 sort
    keys; x64 mode is off, so no 64-bit integers — callers with larger
    corpora prescale,
    see :func:`build_table_pow2`).  Validity is asserted host-side by
    :func:`build_table_pow2`.
    """
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    counts = counts.astype(_U32)
    a = counts.shape[0]
    target = _U32(1 << k)
    total = jnp.sum(counts, dtype=_U32)
    present = counts > 0

    # base = floor(counts * 2^k / total), remainder for step 2
    prod = u64.mul_u64_u32(u64.U64(jnp.zeros_like(counts), counts), target)
    q, r = u64.divmod_u32(prod, jnp.maximum(total, _U32(1)))
    base = jnp.where(present, jnp.maximum(q.lo, _U32(1)), _U32(0))

    # sum(base) <= 2^k + a, fits int32
    diff = (1 << k) - jnp.sum(base.astype(jnp.int32))

    # step 2: +1 to the `diff` present symbols with largest remainders.
    # Stable ascending argsort of the negated key = descending with ties
    # broken toward the smaller symbol index; absent symbols get key 0
    # (> any negated present key) so they sort last and are never bumped.
    key = jnp.where(present, -(r.astype(jnp.int32) + 1), 0)
    order = jnp.argsort(key)
    rank = jnp.zeros((a,), jnp.int32).at[order].set(jnp.arange(a, dtype=jnp.int32))
    bump = jnp.logical_and(present, rank < jnp.maximum(diff, 0)).astype(_U32)

    # step 3: take |diff| from the largest allocations first, floor 1
    surplus = jnp.where(base > 0, base - 1, _U32(0)).astype(jnp.int32)
    order_d = jnp.argsort(-(base.astype(jnp.int32) + 1))
    surplus_sorted = surplus[order_d]
    before = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(surplus_sorted)[:-1]]
    )
    need = jnp.maximum(-diff, 0)
    give_sorted = jnp.clip(need - before, 0, surplus_sorted)
    give = jnp.zeros((a,), jnp.int32).at[order_d].set(give_sorted)

    return (base + bump - give.astype(_U32)).astype(_U32)


def find_index(cum: jax.Array, rfreq: jax.Array) -> jax.Array:
    """Largest ``i`` with ``cum[i] <= rfreq`` — the reference's binary
    search (examples/sample_impl.rs:33-44) as a vectorized searchsorted.
    ``rfreq`` must be < total (= cum[-1])."""
    return (
        jnp.searchsorted(cum[1:], rfreq, side="right").astype(jnp.int32)
    )


def decode_lut(cum: jax.Array, k: int) -> jax.Array:
    """Direct rfreq -> symbol table of size ``2**k`` for pow2-total tables:
    turns the decoder's per-symbol search into one gather.  int32."""
    r = jnp.arange(1 << k, dtype=_U32)
    return find_index(cum, r)


def ideal_bits(c: jax.Array, total: int) -> jax.Array:
    """Per-symbol Shannon bound log2(total/c) — the vectorized
    ``ideal_code_length`` (reference src/pmodel.rs:14-40).  float32; inf for
    zero-frequency symbols (undefined per src/pmodel.rs:16-18)."""
    c_f = c.astype(jnp.float32)
    bits = jnp.log2(jnp.float32(total)) - jnp.log2(c_f)
    return jnp.where(c > 0, bits, jnp.float32(jnp.inf))


# ---------------------------------------------------------------------------
# host-side builder with validation
# ---------------------------------------------------------------------------

def normalize_pow2_np(counts: np.ndarray, k: int) -> np.ndarray:
    """Host-side NumPy twin of :func:`normalize_pow2` — bit-identical
    output (same largest-remainder apportionment, same tie-breaking), no
    device round trip.  The host entry points use this: a table build must
    not cost a device compile + transfer (the device version exists for the
    in-graph per-block adaptive path, adaptive.py).
    """
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    counts = counts.astype(np.uint64)
    a = counts.shape[0]
    total = int(counts.sum())
    present = counts > 0

    prod = counts * np.uint64(1 << k)
    q = (prod // max(total, 1)).astype(np.int64)
    r = (prod % max(total, 1)).astype(np.int64)
    base = np.where(present, np.maximum(q, 1), 0).astype(np.int64)
    diff = (1 << k) - int(base.sum())

    # +1 to the `diff` present symbols with largest remainders (ties to the
    # smaller index) — same key construction as the device version
    key = np.where(present, -(r + 1), 0)
    order = np.argsort(key, kind="stable")
    rank = np.empty(a, np.int64)
    rank[order] = np.arange(a)
    bump = (present & (rank < max(diff, 0))).astype(np.int64)

    # take |diff| from the largest allocations first, floor 1
    surplus = np.where(base > 0, base - 1, 0)
    order_d = np.argsort(-(base + 1), kind="stable")
    surplus_sorted = surplus[order_d]
    before = np.concatenate([[0], np.cumsum(surplus_sorted)[:-1]])
    need = max(-diff, 0)
    give_sorted = np.clip(need - before, 0, surplus_sorted)
    give = np.empty(a, np.int64)
    give[order_d] = give_sorted

    return (base + bump - give).astype(np.uint32)


class Pow2Table(NamedTuple):
    """A validated pow2-normalized table ready for the device coder."""

    c: np.ndarray  # (A,) uint32, sum == 2**k
    cum: np.ndarray  # (A+1,) uint32
    k: int

    @property
    def alphabet(self) -> int:
        return int(self.c.shape[0])

    def arrays(self) -> TableArrays:
        return TableArrays(jnp.asarray(self.c), jnp.asarray(self.cum))


def build_table_pow2(
    counts: np.ndarray | jax.Array, k: int
) -> Pow2Table:
    """Build + validate a pow2 table from raw counts (host entry point)."""
    counts_np = np.asarray(counts).astype(np.uint64)
    if counts_np.ndim != 1 or counts_np.shape[0] < 1:
        raise TableError("counts must be a 1-D array with >= 1 symbol")
    total = int(counts_np.sum())
    if total == 0:
        raise TableError("total_freq is zero: table has no counts")
    # normalize_pow2 needs sum < 2^31 (int32 sort keys); halve proportionally,
    # keeping present symbols >= 1 — sub-ulp effect on the final 2^k shares.
    while total >= 1 << 31:
        counts_np = np.maximum(counts_np >> np.uint64(1), (counts_np > 0))
        total = int(counts_np.sum())
    nnz = int((counts_np > 0).sum())
    if nnz > (1 << k):
        raise TableError(
            f"{nnz} present symbols cannot share total 2**{k}; raise k"
        )
    c = normalize_pow2_np(counts_np, k)
    assert int(c.sum()) == 1 << k, "normalization must be exact"
    assert np.all((counts_np == 0) | (c >= 1)), "present symbols keep c >= 1"
    cum = np.concatenate([[0], np.cumsum(c)]).astype(np.uint32)
    return Pow2Table(c=c, cum=cum, k=k)


def table_from_data_pow2(
    data: np.ndarray | jax.Array, alphabet: int, k: int
) -> Pow2Table:
    """Histogram ``data`` then normalize: the one-call host builder
    (all NumPy — no device compile/transfer on the table path)."""
    counts = np.bincount(
        np.asarray(data).reshape(-1), minlength=alphabet
    )
    if counts.shape[0] > alphabet:
        raise TableError(
            f"data contains symbol {counts.shape[0] - 1} >= alphabet {alphabet}"
        )
    return build_table_pow2(counts, k)
