""">= 4 GB chunked-container round trip on a GPU (BASELINE config 4: one
encode call is capped at 2^31 symbols, so larger inputs go through
rans_codec._encode_chunked).  Exercises it end to end through
api.encode/api.decode: slab-appended groups, one container, one decode,
byte equality.  Prints one JSON line with the card's name and power
limit.

    python scripts/big_corpus.py [GB]    (default 4)
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
    gb = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    import jax
    import numpy as np

    from range_coder_rust_tpu import api, rans_codec
    from range_coder_rust_tpu.kernels.backend import require_gpu
    from range_coder_rust_tpu.utils.compile_cache import use_compile_cache

    dev = require_gpu()
    use_compile_cache()
    card = card_name_and_power_limit()
    n = gb << 30
    assert n >= (1 << 31), "below the chunked threshold; use bench.py"
    log(f"device {dev} ({card}); synthesizing {gb} GB corpus")
    data = make_corpus(n, seed=0xB16)
    log("corpus built")

    cfg = api.CodecConfig(k=16, block_len=32768, profile="rans16",
                          with_checksums=False)
    t1 = time.time()
    blob = api.encode(data, alphabet=256, config=cfg)
    enc_s = time.time() - t1
    log(f"encoded: {len(blob)} B ({8 * len(blob) / n:.4f} bits/sym) "
        f"in {enc_s:.1f}s")
    t1 = time.time()
    out = api.decode(blob)
    dec_s = time.time() - t1
    ok = np.array_equal(out, data)
    log(f"decoded in {dec_s:.1f}s; round trip {'OK' if ok else 'FAILED'}")
    print(json.dumps({
        "metric": ">=4GB chunked container round trip",
        "ok": bool(ok),
        "corpus_gb": gb,
        "container_bytes": len(blob),
        "bits_per_symbol": 8 * len(blob) / n,
        "n_slabs": -(-n // rans_codec._SLAB_SYMBOLS),
        "encode_wall_s": enc_s,
        "decode_wall_s": dec_s,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
