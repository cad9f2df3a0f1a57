"""Many-slice random-access read benchmark on a GPU.

    python scripts/slice_bench.py [MB] [N_SLICES]

Measures `api.decode_range` on many small random reads from one flagship
rans16 container carrying lane-state sync points (CodecConfig(sync_tiles=16)
— SURVEY.md §5 checkpoint/resume; the reference has no random access at
all, the caller re-decodes from byte 0: /root/reference/src/decoder.rs:14-54).
Each slice is verified against the source corpus.

Reads land at uniformly random offsets, so successive slices hit different
(sync-window, tile-span) geometries: the first few pay a one-time compile
each (cached on disk thereafter); the steady state is the warm number.
Within a call, the payload is parsed once and the tables reused.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import card_name_and_power_limit, make_corpus  # noqa: E402

t0 = time.time()


def log(msg):
    print(f"[{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main():
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_slices = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    slice_sym = int(os.environ.get("RC_SLICE_SYM", "1024"))
    n = mb << 20
    if not 0 < slice_sym < n:
        sys.exit(f"RC_SLICE_SYM={slice_sym} must be in (0, {n})")
    if n_slices < 1:
        sys.exit("N_SLICES must be >= 1")

    import jax
    import numpy as np

    from range_coder_rust_tpu import api
    from range_coder_rust_tpu.kernels.backend import require_gpu
    from range_coder_rust_tpu.utils.compile_cache import use_compile_cache

    dev = require_gpu()
    use_compile_cache()
    card = card_name_and_power_limit()
    log(f"device: {dev} ({card})")

    data = make_corpus(n)
    cfg = api.CodecConfig(profile="rans16", sync_tiles=16)
    t_enc = time.time()
    blob = api.encode(data, alphabet=256, config=cfg)
    t_enc = time.time() - t_enc
    log(f"container: {len(blob)/2**20:.1f} MB from {mb} MB "
        f"(encode {t_enc:.1f}s)")

    rng = np.random.default_rng(0xC0)
    starts = rng.integers(0, n - slice_sym, size=n_slices)
    walls = []
    for i, s in enumerate(starts):
        t1 = time.time()
        out = api.decode_range(blob, int(s), slice_sym)
        walls.append(time.time() - t1)
        assert np.array_equal(out, data[s : s + slice_sym]), f"slice {i}"
        log(f"slice {i:3d} @ {int(s):>12,}: {walls[-1]*1e3:7.1f} ms")

    # drop the compile-heavy head, keeping at least one slice
    warm = sorted(walls[min(4, len(walls) - 1):])
    med = warm[len(warm) // 2]
    print(json.dumps({
        "metric": "random-access slice reads (rans16, sync_tiles=16)",
        "corpus_mb": mb,
        "slice_symbols": slice_sym,
        "n_slices": n_slices,
        "container_mb": len(blob) / 2**20,
        "cold_first_slice_s": walls[0],
        "warm_median_s": med,
        "warm_min_s": min(warm),
        "warm_slices_per_s": 1.0 / med,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
