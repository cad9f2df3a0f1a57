"""Benchmark: encode+decode throughput of the coder on one GPU.

Prints ONE JSON line:
  {"metric": "encode+decode GB/s/card", "value": N, "unit": "GB/s",
   "vs_baseline": R, ..., "device": {...}}

The reference publishes no numbers (BASELINE.md), so the baseline is
measured here: the C++ scalar golden coder (byte-identical semantics to the
Rust crate) timed on a sample of the same corpus on the host CPU.
``vs_baseline`` is the device GB/s divided by the scalar coder's GB/s.

Profiles:
  rans16 (default) — interleaved word-renormalized rANS (rans.py), one
    Pallas kernel per direction (kernels/rans_*.py).  Device numbers time
    the device chain on device-resident data (step-major transpose +
    encode kernel + stream compaction; decode kernel + transpose to the
    narrow output dtype); container bits/sym uses the real container
    bytes (api.encode).  e2e numbers are bytes in -> bytes out through
    api.encode / api.decode, host work and transfers included.
  planar — the byte-exact block-parallel range coder (blocks.py).

Corpus: Zipf(1.2) bytes from a seed.  Round-trip equality and
compressed-size-vs-scalar are asserted, not just timed.  The run fails
when JAX finds no GPU; the card's name and power limit are printed with
the numbers.

Env knobs: RC_BENCH_MB (corpus MB, default 256), RC_BENCH_REPS (default
3), RC_BENCH_L (lane/block length, default 32768 rans16 / 512 planar),
RC_BENCH_PROFILE (rans16|planar), RC_BENCH_K (planar k, default 16),
RC_BENCH_E2E_MB (end-to-end api slice, default = corpus size).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_corpus(n_bytes: int, seed: int = 0xC0) -> np.ndarray:
    """Zipf(1.2)-distributed bytes as uint8 — skewed like real text and
    binary mixes.  Built in chunks, so a GB-scale corpus never exists as a
    wider dtype."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.2
    cdf = np.cumsum(p / p.sum())
    # inverse-CDF table at 2^-20 resolution: one gather per byte
    lut = np.minimum(np.searchsorted(
        cdf, (np.arange(1 << 20) + 0.5) / (1 << 20)), 255).astype(np.uint8)
    out = np.empty(n_bytes, np.uint8)
    step = 1 << 24
    for i in range(0, n_bytes, step):
        m = min(step, n_bytes - i)
        out[i:i + m] = lut[rng.integers(0, 1 << 20, m, dtype=np.uint32)]
    return out


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` for the card(s)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def timed_best(fn, block, reps, groups=3):
    """Best group-average seconds per rep: within a group all reps are
    dispatched back to back with one final block; the best of ``groups``
    group-averages rides out host noise."""
    best = None
    for _ in range(groups):
        t0 = time.perf_counter()
        outs = [fn() for _ in range(reps)]
        block(outs)
        dt = (time.perf_counter() - t0) / reps
        best = dt if best is None else min(best, dt)
    return best


def main() -> None:
    profile = os.environ.get("RC_BENCH_PROFILE", "rans16")
    mb = int(os.environ.get("RC_BENCH_MB", "256"))
    reps = int(os.environ.get("RC_BENCH_REPS", "3"))
    k = int(os.environ.get("RC_BENCH_K", "16"))
    e2e_mb = int(os.environ.get("RC_BENCH_E2E_MB", str(mb)))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import jax.numpy as jnp

    from range_coder_rust_tpu import api
    from range_coder_rust_tpu.kernels.backend import require_gpu
    from range_coder_rust_tpu.models.table import table_from_data_pow2
    from range_coder_rust_tpu.native import golden
    from range_coder_rust_tpu.utils.compile_cache import use_compile_cache

    dev = require_gpu()
    use_compile_cache()
    card = card_name_and_power_limit()
    log(f"device: {dev} kind={dev.device_kind} card: {card} "
        f"profile={profile}")

    default_l = "32768" if profile == "rans16" else "512"
    L = int(os.environ.get("RC_BENCH_L", default_l))
    n = mb << 20
    data = make_corpus(n)
    log(f"corpus: {mb} MB, L={L}, k={k}")
    t = table_from_data_pow2(data, 256, k)

    # --- scalar baseline (C++ golden, reference semantics) -----------------
    sample = data[: min(n, 4 << 20)]
    t0 = time.perf_counter()
    ref_code = golden.encode(sample, t.c, t.cum[:-1], 1 << k)
    ref_enc_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_dec = golden.decode(ref_code, sample.size, t.c, t.cum[:-1], 1 << k)
    ref_dec_t = time.perf_counter() - t0
    assert np.array_equal(ref_dec.astype(np.int64), sample.astype(np.int64))
    base_gbps = sample.size / 1e9 / (ref_enc_t + ref_dec_t)
    ref_bits = 8 * len(ref_code) / sample.size
    log(f"scalar C++ baseline: {base_gbps:.3f} GB/s, {ref_bits:.4f} bits/sym "
        f"on {sample.size >> 20} MB sample")

    if profile == "rans16":
        enc_t, dec_t, cont_bits, compiles = bench_rans16(jax, jnp, data, L,
                                                         reps)
    else:
        enc_t, dec_t, cont_bits, compiles = bench_planar(
            jax, jnp, dev, data, t, L, k, reps)

    gbps = n / 1e9 / (enc_t + dec_t)
    log(f"device encode {n / 1e9 / enc_t:.3f} GB/s, decode "
        f"{n / 1e9 / dec_t:.3f} GB/s, combined {gbps:.3f} GB/s ({card})")
    log(f"bits/sym (container-inclusive): ours {cont_bits:.4f} vs scalar "
        f"stream {ref_bits:.4f}")

    # --- end-to-end api.encode/decode (bytes in, bytes out) ----------------
    e2e_n = min(n, e2e_mb << 20)
    cfg = (api.CodecConfig(k=16, block_len=L, profile=profile)
           if profile == "rans16" else api.CodecConfig(k=k, block_len=L))
    e2e_data = data[:e2e_n]
    blob = api.encode(e2e_data, alphabet=256, config=cfg)  # compile/warm
    api.decode(blob)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        blob = api.encode(e2e_data, alphabet=256, config=cfg)
        enc_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt = api.decode(blob)
        runs.append((enc_wall, time.perf_counter() - t0))
    assert np.array_equal(rt, e2e_data), "api round trip failed"
    e2e_enc_t, e2e_dec_t = min(runs, key=lambda r: r[0] + r[1])
    e2e_gbps = e2e_n / 1e9 / (e2e_enc_t + e2e_dec_t)
    e2e_gbps_mean = e2e_n / 1e9 / (sum(r[0] + r[1] for r in runs)
                                   / len(runs))
    log(f"end-to-end api ({e2e_n >> 20} MB, host work + transfers): "
        f"encode {e2e_n / 1e9 / e2e_enc_t:.3f} GB/s, decode "
        f"{e2e_n / 1e9 / e2e_dec_t:.3f} GB/s, combined {e2e_gbps:.3f} GB/s "
        f"(mean {e2e_gbps_mean:.3f}) ({card})")

    print(json.dumps({
        "metric": "encode+decode GB/s/card",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / base_gbps,
        "profile": profile,
        "encode_gbps": n / 1e9 / enc_t,
        "decode_gbps": n / 1e9 / dec_t,
        "e2e_gbps": e2e_gbps,
        "e2e_gbps_mean": e2e_gbps_mean,
        "e2e_encode_gbps": e2e_n / 1e9 / e2e_enc_t,
        "e2e_decode_gbps": e2e_n / 1e9 / e2e_dec_t,
        "e2e_mb": e2e_n >> 20,
        "corpus_mb": mb,
        "lane_len": L,
        "compile_s": compiles,
        "bits_per_symbol_container": cont_bits,
        "scalar_bits_per_symbol": ref_bits,
        "size_vs_scalar": cont_bits / ref_bits,
        "baseline_gbps_scalar_cpp": base_gbps,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


def bench_rans16(jax, jnp, data, L, reps):
    """Device-resident timing of the rans16 device chain, per direction,
    with the same batching and programs the api path runs."""
    from range_coder_rust_tpu import api, rans_codec
    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu.kernels.backend import interpret_kernels
    from range_coder_rust_tpu.kernels.rans_encode import symbol_words

    interp = interpret_kernels()
    G = rans_codec.G
    n = data.size
    L = rans_codec._shrink_lane_len(n, L)
    ng = max(1, n // (G * L))
    nfit = ng * G * L
    rows = data[:nfit].reshape(ng * G, L)
    blob = api.encode(data[:nfit], alphabet=256,
                      config=api.CodecConfig(profile="rans16", block_len=L))
    cont_bits = 8 * len(blob) / nfit
    cont = fmt.unpack(blob)
    tc = np.asarray(cont.tables_c)
    words = jnp.asarray(symbol_words(tc)[0])
    cum = rans_codec.decode_tables(tc)
    gpc = rans_codec._groups_per_call(L)
    bounds = [(s, min(s + gpc, ng)) for s in range(0, ng, gpc)]

    enc_in, dec_in = [], []
    for s, e in bounds:
        enc_in.append(jax.device_put(rows[s * G:e * G]))
        parsed = [rans_codec._parse_payload(p, L, G)
                  for p in cont.payloads[s:e]]
        stream, offsets = rans_codec._stage_stream([r for _, _, r in parsed])
        hi, lo = rans_codec._states_from6([p6 for _, p6, _ in parsed], G)
        dec_in.append(tuple(jax.device_put(x) for x in
                            (stream[0], offsets, hi, lo)))
    totals = [sum(len(r) // 2 for _, _, r in
                  (rans_codec._parse_payload(p, L, G)
                   for p in cont.payloads[s:e])) for s, e in bounds]

    def enc_all():
        outs = []
        for x, tot in zip(enc_in, totals):
            buf, counts, _, _ = rans_codec._encode_device(
                x, words, group_lanes=G, interpret=interp)
            outs.append(rans_codec._compact(
                buf, counts.sum(axis=1), out_len=rans_codec._bucket(tot)))
        return outs

    def dec_all():
        return [rans_codec._decode_device(
            *args, cum, n_steps=L, a_count=256, out_dtype=np.uint8,
            interpret=interp) for args in dec_in]

    block = jax.block_until_ready
    t0 = time.perf_counter()
    block(enc_all())
    enc_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = block(dec_all())
    dec_first = time.perf_counter() - t0
    assert np.array_equal(np.concatenate([np.asarray(x) for x in got]),
                          data[:nfit]), "device round trip failed"
    enc_t = timed_best(enc_all, block, reps)
    dec_t = timed_best(dec_all, block, reps)
    scale = n / nfit
    return enc_t * scale, dec_t * scale, cont_bits, {
        "encode_first_s": enc_first, "decode_first_s": dec_first,
        "groups": ng, "device_calls": len(bounds)}


def bench_planar(jax, jnp, dev, data, t, L, k, reps):
    """Planar path timing (the api default profile)."""
    from range_coder_rust_tpu.blocks import (
        decode_blocks, default_capacity, encode_blocks)

    n = data.size
    B = n // L
    rows = data[: B * L].reshape(B, L)
    c = jax.device_put(jnp.asarray(t.c), dev)
    cum = jax.device_put(jnp.asarray(t.cum), dev)
    cap = default_capacity(L, k)
    syms = jax.device_put(jnp.asarray(rows.astype(np.int32)), dev)

    t0 = time.perf_counter()
    code, lengths = encode_blocks(syms, c, cum, k=k, capacity=cap)
    jax.block_until_ready((code, lengths))
    enc_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = decode_blocks(code, c, cum, k=k, block_len=L)
    jax.block_until_ready(dec)
    dec_compile = time.perf_counter() - t0
    assert np.array_equal(np.asarray(dec), rows), "round trip failed"
    lengths_np = np.asarray(lengths)
    assert int(lengths_np.max()) <= cap, "capacity overflow"
    # container-inclusive: payloads + 4B length + 4B CRC per block
    cont_bits = 8 * (int(lengths_np.sum()) + 8 * B) / (B * L)

    block = jax.block_until_ready
    enc_t = timed_best(
        lambda: encode_blocks(syms, c, cum, k=k, capacity=cap), block, reps)
    dec_t = timed_best(
        lambda: decode_blocks(code, c, cum, k=k, block_len=L), block, reps)
    scale = n / (B * L)
    return enc_t * scale, dec_t * scale, cont_bits, {
        "encode_first_s": enc_compile, "decode_first_s": dec_compile}


if __name__ == "__main__":
    main()
