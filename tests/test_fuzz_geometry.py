"""One randomized sweep CROSSING the rans16 geometry axes (VERDICT r4:
each axis was pinned by one deterministic test, but no single fuzz
crossed them — exactly the round-4 bug class: alphabet off-by-one,
histogram chunk divisor, group-width shadowing).

Axes per case: group_lanes x lane length (incl. non-tile-multiples that
force shrink, multi-tile lanes) x alphabet (non-pow2, leading/interior
zero-frequency symbols, single-symbol data) x partial last group x
per_group_tables x sync_tiles x group count.
Every case round-trips through the REAL container and spot-checks a
random decode_range slice.

RC_FUZZ_N overrides the case count (default 200, split over 8 shards so
failures localize and -x keeps the rest of the suite running).
"""

import os

import numpy as np
import pytest

from range_coder_rust_tpu import api, rans_codec
from range_coder_rust_tpu import format as fmt
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu.rans import tile_steps_for

N_CASES = int(os.environ.get("RC_FUZZ_N", "200"))
SHARDS = 8


def _draw_case(rng):
    g = int(rng.choice([128, 256, 512, 1024]))
    ts = tile_steps_for(g)
    # lane length: usually sub-tile (fast under interpret), sometimes a
    # small tile multiple (multi-tile size tables + sync sections)
    if rng.random() < 0.75 or ts > 128:
        L = int(rng.integers(1, min(ts, 112) + 1))
    else:
        L = ts * int(rng.integers(2, 4))
    a = int(rng.choice([2, 3, 5, 17, 129, 255, 256, 257, 511, 777, 1023,
                        int(rng.integers(2, 1024))]))
    pgt = bool(rng.random() < 0.2)
    sync = int(rng.choice([0, 1, 3, 16]))
    # group count / partial tail: up to ~2.2 groups of data
    span = g * L
    shape = rng.random()
    if shape < 0.15:
        n = int(rng.integers(1, min(span, 400) + 1))  # tiny (forces shrink)
    elif shape < 0.55:
        n = span * int(rng.integers(1, 3)) - int(rng.integers(0, span // 2))
    else:
        n = span * int(rng.integers(1, 3)) + int(rng.integers(1, span))
    n = max(1, n)
    # symbol distribution: sub-ranges force leading/trailing zero-freq
    # tables; two disjoint ranges force INTERIOR zero-freq symbols
    kind = rng.random()
    if kind < 0.15 or a < 4:
        lo = int(rng.integers(0, a))
        data = np.full(n, lo, np.int64)  # single-symbol corpus
    elif kind < 0.55:
        lo = int(rng.integers(0, a))
        hi = int(rng.integers(lo + 1, a + 1))
        data = rng.integers(lo, hi, size=n)
    else:
        w1 = int(rng.integers(1, max(2, a // 3)))
        lo2 = int(rng.integers(w1, a))
        data = np.where(rng.random(n) < 0.5,
                        rng.integers(0, w1, size=n),
                        rng.integers(lo2, a, size=n))
    return g, L, a, pgt, sync, data.astype(np.int64)


@pytest.mark.parametrize("shard", range(SHARDS))
def test_fuzz_geometry(shard):
    import gc

    import jax

    rng = np.random.default_rng(0xF0220 + shard)
    per = -(-N_CASES // SHARDS)
    for case in range(per):
        if case % 8 == 0:
            # every case is a distinct geometry -> a distinct compiled
            # executable (~350 mmap regions each, never evicted); without
            # periodic eviction ~150 cases exhaust vm.max_map_count and
            # XLA's next LLVM JIT mmap fails ("Cannot allocate memory"),
            # taking the process down.  Reuse across cases is nil, so
            # clearing costs nothing.
            jax.clear_caches()
            gc.collect()
        g, L, a, pgt, sync, data = _draw_case(rng)
        n = data.size
        label = (f"shard={shard} case={case} g={g} L={L} a={a} "
                 f"pgt={pgt} sync={sync} n={n}")
        try:
            if pgt:
                blob = rans_codec.encode(
                    data, alphabet=a, block_len=L, per_group_tables=True,
                    sync_tiles=sync, group_lanes=g)
            else:
                t = table_from_data_pow2(data, a, 16)
                blob = rans_codec.encode(
                    data, alphabet=a, table=t, block_len=L,
                    sync_tiles=sync, group_lanes=g)
            cont = fmt.unpack(blob)
            out = rans_codec.decode(cont)
        except Exception as e:  # pragma: no cover - failure context
            raise AssertionError(f"{label}: {type(e).__name__}: {e}") from e
        np.testing.assert_array_equal(out, data, err_msg=label)
        if n > 2:
            s0 = int(rng.integers(0, n - 1))
            cnt = int(rng.integers(1, min(n - s0, 300) + 1))
            got = api.decode_range(blob, s0, cnt)
            np.testing.assert_array_equal(
                got, data[s0 : s0 + cnt], err_msg=f"{label} range "
                f"[{s0}, {s0 + cnt})")
