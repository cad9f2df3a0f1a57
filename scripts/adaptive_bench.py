"""Adaptive-coding bench on a mixed corpus (BASELINE config: adaptive).

The adaptive rans16 mode (CodecConfig(per_group_tables=True)) is the
product path: one order-0 table per group of ``GROUP_LANES * L`` symbols,
two-pass (device histogram, then the same kernels with per-group tables).
This bench times its device chain on device-resident data, plus the
real container's bits/sym and the end-to-end api seconds.  It runs on a
GPU only and prints the card's name and power limit with its numbers.

The planar adaptive path (adaptive.py) is conformance-only: its O(L*A)
masked sweep per scan step demonstrates per-block tables under the
byte-exact planar coder; the rans16 mode covers the product use case.

Prints one JSON line.  Usage:
    python scripts/adaptive_bench.py   (env: RC_ADAPT_MB default 256,
                                        RC_ADAPT_L default 32, RC_ADAPT_G,
                                        RC_ADAPT_REPS default 3)
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import card_name_and_power_limit, timed_best  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mixed_corpus(n: int, seed: int = 5) -> np.ndarray:
    """Segments of very different statistics, shuffled at 64 KB scale."""
    rng = np.random.default_rng(seed)
    segs = []
    per = 64 << 10
    kinds = ["zipf", "uniform", "skew", "runs"]
    for i in range(n // per):
        kind = kinds[i % 4]
        if kind == "zipf":
            r = np.arange(1, 257)
            p = 1.0 / r**1.3
            p /= p.sum()
            segs.append(rng.choice(256, size=per, p=p))
        elif kind == "uniform":
            segs.append(rng.integers(0, 256, per))
        elif kind == "skew":
            base = rng.integers(0, 200)
            segs.append((base + rng.geometric(0.3, per)) % 256)
        else:
            vals = rng.integers(0, 256, per // 64)
            segs.append(np.repeat(vals, 64))
    return np.concatenate(segs)[:n].astype(np.uint8)


def main():
    import jax
    import jax.numpy as jnp

    from range_coder_rust_tpu import api, rans_codec
    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu.kernels.backend import (
        interpret_kernels, require_gpu)
    from range_coder_rust_tpu.kernels.rans_encode import symbol_words
    from range_coder_rust_tpu.models.table import (
        build_table_pow2, table_from_data_pow2)
    from range_coder_rust_tpu.utils.compile_cache import use_compile_cache

    dev = require_gpu()
    use_compile_cache()
    interp = interpret_kernels()
    card = card_name_and_power_limit()
    mb = int(os.environ.get("RC_ADAPT_MB", "256"))
    L = int(os.environ.get("RC_ADAPT_L", "32"))  # 2048-lane groups -> 64 KB
    reps = int(os.environ.get("RC_ADAPT_REPS", "3"))
    G = int(os.environ.get("RC_ADAPT_G", str(rans_codec.G)))
    n = mb << 20
    data = mixed_corpus(n)
    NG = n // (G * L)
    log(f"device: {dev} ({card}); {mb} MB mixed corpus, {NG} groups x {G} "
        f"x {L} (adaptive rans16, {G * L >> 10} KB tables)")

    # --- per-group tables: device histogram -> host normalize ----------
    data_dev = jax.block_until_ready(jax.device_put(data, dev))
    np.asarray(rans_codec._histogram_groups(
        data_dev, alphabet=256, n_groups=NG))  # compile + warm
    t0 = time.perf_counter()
    counts = np.asarray(rans_codec._histogram_groups(
        data_dev, alphabet=256, n_groups=NG)).astype(np.uint64)
    hist_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables_c = np.stack([build_table_pow2(c, 16).c for c in counts])
    table_s = time.perf_counter() - t0
    log(f"tables: device histogram {hist_s:.3f}s, host normalize "
        f"{table_s:.2f}s ({NG} tables)")

    # --- real container (also the decode inputs) ------------------------
    cfg = api.CodecConfig(
        profile="rans16", block_len=L, per_group_tables=True,
        group_lanes=None if G == rans_codec.G else G)
    blob = api.encode(data, alphabet=256, config=cfg)
    bits = 8 * len(blob) / n
    cont = fmt.unpack(blob)
    assert np.array_equal(api.decode(blob), data), "adaptive round trip"
    log(f"container: {bits:.4f} bits/sym (round trip OK)")

    # --- device-resident batches, as the api path batches them ----------
    gpc = rans_codec._groups_per_call(L, G)
    words = jnp.asarray(symbol_words(tables_c))
    cum = rans_codec.decode_tables(tables_c)
    rows = data.reshape(NG * G, L)
    enc_in, dec_in = [], []
    for s in range(0, NG, gpc):
        e = min(s + gpc, NG)
        parsed = [rans_codec._parse_payload(p, L, G)
                  for p in cont.payloads[s:e]]
        stream, offsets = rans_codec._stage_stream([r for _, _, r in parsed])
        hi, lo = rans_codec._states_from6([p6 for _, p6, _ in parsed], G)
        enc_in.append((jax.device_put(rows[s * G:e * G], dev), words[s:e],
                       int(stream.size)))
        dec_in.append((tuple(jax.device_put(x, dev) for x in
                             (stream[0], offsets, hi, lo)), cum[s:e]))

    def enc_all():
        outs = []
        for x, w, tot in enc_in:
            buf, cnt, _, _ = rans_codec._encode_device(
                x, w, group_lanes=G, interpret=interp)
            outs.append(rans_codec._compact(
                buf, cnt.sum(axis=1), out_len=rans_codec._bucket(tot)))
        return outs

    def dec_all():
        return [rans_codec._decode_device(
            *args, c, n_steps=L, a_count=256, out_dtype=np.uint8,
            interpret=interp) for args, c in dec_in]

    block = jax.block_until_ready
    block(enc_all())
    got = block(dec_all())
    assert np.array_equal(np.concatenate([np.asarray(x) for x in got]),
                          data), "device round trip"
    enc_t = timed_best(enc_all, block, reps)
    dec_t = timed_best(dec_all, block, reps)
    log(f"adaptive rans16 device encode {n / 1e9 / enc_t:.3f} GB/s, decode "
        f"{n / 1e9 / dec_t:.3f} GB/s ({card})")

    # --- end to end through api -----------------------------------------
    t0 = time.perf_counter()
    blob2 = api.encode(data, alphabet=256, config=cfg)
    e2e_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    api.decode(blob2)
    e2e_dec = time.perf_counter() - t0

    # shared-table bound for the size comparison
    ts = table_from_data_pow2(data, 256, 16)
    p = np.bincount(data, minlength=256) / n
    nz = ts.c > 0
    shared_bits = float(-(p[nz] * np.log2(
        ts.c[nz].astype(float) / 65536.0)).sum())

    print(json.dumps({
        "metric": "adaptive rans16 encode+decode GB/s/card (mixed corpus)",
        "value": n / 1e9 / (enc_t + dec_t),
        "encode_gbps_device": n / 1e9 / enc_t,
        "decode_gbps_device": n / 1e9 / dec_t,
        "bits_per_symbol": bits,
        "bits_per_symbol_shared_table_bound": shared_bits,
        "group_kb": G * L >> 10,
        "n_groups": NG,
        "table_build_s": {"device_histogram": hist_s,
                          "host_normalize": table_s},
        "e2e_encode_s": e2e_enc,
        "e2e_decode_s": e2e_dec,
        "corpus_mb": mb,
        "block_len": L,
        "group_lanes": G,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
