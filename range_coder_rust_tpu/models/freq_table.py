"""Order-0 static frequency-table model (reference examples/sample_impl.rs:1-70).

The reference ships this as its example ``PModel`` implementation; here it is
a first-class model of the framework.  It keeps the exact reference
semantics — exclusive prefix sums (``calc_cum``,
examples/sample_impl.rs:61-69) and the largest-``i``-with-``cum[i] <= rfreq``
binary search (examples/sample_impl.rs:27-45) — and adds array-native
construction (histogram + cumsum) plus conversion to the device-path
:class:`~range_coder_rust_tpu.models.table.Pow2Table` (``to_pow2_table``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..errors import TableError
from ..pmodel import PModel


class FreqTable(PModel):
    """Static order-0 table: per-symbol ``c``/``cum`` plus ``total``
    (reference examples/sample_impl.rs:4-15)."""

    def __init__(self, alphabet_count: int) -> None:
        if alphabet_count < 1:
            raise TableError("alphabet_count must be >= 1")
        self._c = np.zeros(alphabet_count, dtype=np.uint64)
        self._cum = np.zeros(alphabet_count, dtype=np.uint64)
        self._total = 0

    # -- construction (reference examples/sample_impl.rs:48-69) -------------
    @property
    def alphabet_count(self) -> int:
        return int(self._c.shape[0])

    def add_alphabet_freq(self, index: int) -> None:
        """Count one occurrence (reference examples/sample_impl.rs:58-60)."""
        self._c[index] += 1

    def add_counts(self, data: Iterable[int] | np.ndarray) -> None:
        """Vectorized histogram accumulation (framework extension of
        ``add_alphabet_freq``; the device builder lives in models/table.py)."""
        arr = np.asarray(list(data) if not isinstance(data, np.ndarray) else data)
        self._c += np.bincount(
            arr.astype(np.int64), minlength=self.alphabet_count
        ).astype(np.uint64)

    def calc_cum(self) -> None:
        """Exclusive prefix sum into ``cum`` and total
        (reference examples/sample_impl.rs:61-69)."""
        cs = np.cumsum(self._c)
        self._cum[0] = 0
        self._cum[1:] = cs[:-1]
        self._total = int(cs[-1])
        if self._total == 0:
            raise TableError("total_freq is zero: table has no counts")
        if self._total >= 1 << 32:
            raise TableError(
                f"total_freq {self._total} exceeds u32 (reference trait "
                f"signatures fix frequencies to u32, src/pmodel.rs:6-10)"
            )

    @classmethod
    def from_counts(
        cls, counts: Sequence[int] | np.ndarray, *_, **__
    ) -> "FreqTable":
        t = cls(len(counts))
        t._c[:] = np.asarray(counts, dtype=np.uint64)
        t.calc_cum()
        return t

    @classmethod
    def from_data(cls, data: np.ndarray, alphabet_count: int) -> "FreqTable":
        t = cls(alphabet_count)
        t.add_counts(np.asarray(data))
        t.calc_cum()
        return t

    # -- PModel protocol (reference examples/sample_impl.rs:17-45) ----------
    def c_freq(self, index: int) -> int:
        return int(self._c[index])

    def cum_freq(self, index: int) -> int:
        return int(self._cum[index])

    def total_freq(self) -> int:
        return self._total

    def find_index(self, decoder) -> int:
        """Binary search for the largest ``i`` with ``cum[i] <= rfreq``
        (reference examples/sample_impl.rs:27-45)."""
        rfreq = (
            decoder.data() - decoder.range_coder.lower_bound
        ) // decoder.range_coder.range_par_total(self._total)
        left = 0
        right = self.alphabet_count - 1
        while left < right:
            mid = (left + right) // 2
            if self.cum_freq(mid + 1) <= rfreq:
                left = mid + 1
            else:
                right = mid
        return left

    # -- array views for the device path ------------------------------------
    def counts(self) -> np.ndarray:
        return self._c.copy()

    def cum_counts(self) -> np.ndarray:
        return self._cum.copy()
