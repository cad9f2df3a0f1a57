"""Smoke test of the coder's main path on an NVIDIA GPU.

Runs the user entry points (``api.encode`` / ``api.decode`` /
``api.decode_range``) at deployment sizes on one card, with the kernels
compiled for the card (never interpreted), and checks every result
against the repository's own oracles:

  1. device     — JAX's devices and the card's name and power limit;
  2. rans16     — 1 GB of Zipf(1.2) bytes (bench.make_corpus, from
                  ``--seed``), shared table, block_len 32768:
                  bit-exact round trip; two sampled groups' payloads equal
                  payloads built by the NumPy spec (rans.py); each jitted
                  program's compile time and memory_analysis();
  3. adaptive   — 256 MB, per-group tables, block_len 64: bit-exact;
  4. sync       — 256 MB with sync_tiles=128: one decode_range slice from
                  the middle equals the input;
  5. planar     — the api default, 64 MB, block_len 512: bit-exact;
                  sampled blocks equal the C++ golden coder's streams.

``--four-cards`` runs only the sharded path on four cards — sharded rans16
and sharded planar over a 1-D mesh — and compares it with the same
kernels on one card.

Each phase prints its seconds and result.  The last line of standard
output is one JSON object, ``{"ok": true, "device": {...}}``, printed only
when every phase passed; otherwise the script exits non-zero.  It exits
non-zero with no result when JAX finds no GPU.

Usage: ``python chip_smoke.py [--four-cards] [--seed N]``
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

MB = 1 << 20


class Smoke:
    """Runs phases, prints one line per phase, remembers failures."""

    def __init__(self):
        self.failed = []

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return None
        print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s: {result}",
              flush=True)
        return result


def phase_device(jax):
    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"devices: {devs}", flush=True)
    print(f"device_kind: {devs[0].device_kind}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    return smi


def compile_report(jax, jnp, L, ng, total, g):
    """AOT-compile the three rans16 programs at the 1 GB call's shapes:
    compile seconds and memory_analysis() each."""
    from range_coder_rust_tpu import rans_codec
    from range_coder_rust_tpu.kernels.backend import interpret_kernels

    interp = interpret_kernels()
    sds = jax.ShapeDtypeStruct
    progs = {
        "encode": rans_codec._encode_device.lower(
            sds((ng * g, L), jnp.uint8), sds((1024,), jnp.uint32),
            group_lanes=g, interpret=interp),
        "compact": rans_codec._compact.lower(
            sds((ng, L * g), jnp.uint16), sds((ng,), jnp.int32),
            out_len=rans_codec._bucket(total)),
        "decode": rans_codec._decode_device.lower(
            sds((max(total, 1),), jnp.uint16), sds((ng,), jnp.int32),
            sds((ng, g), jnp.uint32), sds((ng, g), jnp.uint32),
            sds((1024,), jnp.uint32), n_steps=L, a_count=256,
            out_dtype=np.uint8, interpret=interp),
    }
    out = {}
    for name, lowered in progs.items():
        t0 = time.perf_counter()
        compiled = lowered.compile()
        secs = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        print(f"  {name}: compile {secs:.2f} s, memory_analysis: {ma}",
              flush=True)
        out[name] = round(secs, 2)
    return out


def spec_payload(rows, t, L, tile):
    """A v2 group payload built by the NumPy spec encoder (rans.py)."""
    from range_coder_rust_tpu import rans

    states, regions, counts = rans.encode_lanes(rows, t.c, t.cum)
    sizes = counts.reshape(L // tile, tile).sum(axis=1).astype("<u4")
    region = np.concatenate(
        [r for r in regions if r.size] or [np.zeros(0, np.uint16)])
    pre6 = states.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6]
    return (np.uint32(len(sizes)).tobytes() + sizes.tobytes()
            + pre6.tobytes() + region.astype("<u2").tobytes())


def phase_rans16(jax, jnp, data):
    from range_coder_rust_tpu import api, rans, rans_codec
    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu.models.table import build_table_pow2

    g = rans.GROUP_LANES
    cfg = api.CodecConfig(profile="rans16", block_len=32768)
    t0 = time.perf_counter()
    blob = api.encode(data, alphabet=256, config=cfg)
    enc_s = time.perf_counter() - t0
    cont = fmt.unpack(blob)
    L = cont.block_len
    t0 = time.perf_counter()
    out = api.decode(blob)
    dec_s = time.perf_counter() - t0
    if not np.array_equal(out, data):
        raise AssertionError("1 GB rans16 round trip is not bit-exact")
    ng = cont.n_blocks
    tile, _ = rans_codec._tile_geometry(L, g)
    t = build_table_pow2(cont.tables_c.astype(np.uint64), 16)
    pad = np.uint8(np.argmax(t.c))  # the encoder pads the last group
    checked = sorted({0, ng // 2, ng - 1})
    for gi in checked:
        rows = data[gi * g * L:(gi + 1) * g * L]
        rows = np.concatenate(
            [rows, np.full(g * L - rows.size, pad, np.uint8)]).reshape(g, L)
        if spec_payload(rows, t, L, tile) != cont.payloads[gi]:
            raise AssertionError(f"group {gi} payload differs from rans.py")
    total = sum(len(p) for p in cont.payloads)  # bound for the report
    calls = -(-ng // rans_codec._groups_per_call(L, g))
    compiles = compile_report(jax, jnp, L, -(-ng // calls),
                              (total - ng * (4 + 4 * (L // tile) + 6 * g))
                              // 2, g)
    return {"encode_s": round(enc_s, 2), "decode_s": round(dec_s, 2),
            "groups": ng, "spec_groups_checked": checked,
            "bits_per_symbol": round(8 * len(blob) / data.size, 4),
            "compile_s": compiles}


def phase_adaptive(data):
    from range_coder_rust_tpu import api

    cfg = api.CodecConfig(profile="rans16", block_len=64,
                          per_group_tables=True)
    t0 = time.perf_counter()
    blob = api.encode(data, alphabet=256, config=cfg)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = api.decode(blob)
    dec_s = time.perf_counter() - t0
    if not np.array_equal(out, data):
        raise AssertionError("per-group rans16 round trip is not bit-exact")
    return {"encode_s": round(enc_s, 2), "decode_s": round(dec_s, 2),
            "bits_per_symbol": round(8 * len(blob) / data.size, 4)}


def phase_sync(data):
    from range_coder_rust_tpu import api

    cfg = api.CodecConfig(profile="rans16", block_len=32768, sync_tiles=128)
    blob = api.encode(data, alphabet=256, config=cfg)
    start, count = data.size // 2 - 4096, 1 << 16
    t0 = time.perf_counter()
    got = api.decode_range(blob, start, count)
    rng_s = time.perf_counter() - t0
    if not np.array_equal(got, data[start:start + count]):
        raise AssertionError("decode_range slice differs from the input")
    return {"slice": [start, count], "decode_range_s": round(rng_s, 3)}


def phase_planar(data):
    from range_coder_rust_tpu import api
    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu.native import golden

    L = 512
    cfg = api.CodecConfig(block_len=L)
    t0 = time.perf_counter()
    blob = api.encode(data, alphabet=256, config=cfg)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = api.decode(blob)
    dec_s = time.perf_counter() - t0
    if not np.array_equal(out, data):
        raise AssertionError("planar round trip is not bit-exact")
    cont = fmt.unpack(blob)
    c = cont.tables_c.astype(np.uint32)
    cum = np.concatenate([[0], np.cumsum(c)[:-1]]).astype(np.uint32)
    picks = np.random.default_rng(7).choice(cont.n_blocks - 1, 8,
                                            replace=False)
    for b in picks:
        want = golden.encode(data[b * L:(b + 1) * L], c, cum, 1 << cont.k)
        if want != bytes(cont.payloads[b]):
            raise AssertionError(f"planar block {b} differs from golden")
    return {"encode_s": round(enc_s, 2), "decode_s": round(dec_s, 2),
            "golden_blocks_checked": len(picks)}


def phase_four_cards(jax, jnp, data, L=32768, planar_bytes=64 * MB):
    """Sharded rans16 (lanes of ``L`` steps) and sharded planar (the first
    ``planar_bytes``) over 4 cards vs the same kernels on one card."""
    from range_coder_rust_tpu import api, rans, rans_codec
    from range_coder_rust_tpu.blocks import default_capacity, encode_blocks
    from range_coder_rust_tpu.kernels.backend import interpret_kernels
    from range_coder_rust_tpu.kernels.rans_encode import symbol_words
    from range_coder_rust_tpu.models.table import build_table_pow2
    from range_coder_rust_tpu.parallel import (
        block_sharding, default_mesh, make_sharded_codec,
        make_sharded_rans16, replicated)

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = default_mesh(devs)
    sh, rep = block_sharding(mesh), replicated(mesh)
    res = {}

    # rans16: groups sharded over the cards
    g = rans.GROUP_LANES
    ng = data.size // (g * L)
    rows = data[: ng * g * L].reshape(ng * g, L)
    t = build_table_pow2(np.bincount(rows.reshape(-1), minlength=256)
                         .astype(np.uint64), 16)
    words = jnp.asarray(symbol_words(t.c)[0])
    cum = rans_codec.decode_tables(t.c)
    enc, dec = make_sharded_rans16(mesh, block_len=L, a_count=256)
    t0 = time.perf_counter()
    buf, counts, hi, lo = jax.block_until_ready(
        enc(jax.device_put(rows, sh), jax.device_put(words, rep)))
    res["rans16_encode_4_s"] = round(time.perf_counter() - t0, 3)
    cards = {s.device.id for s in counts.addressable_shards}
    if len(cards) != 4:
        raise AssertionError(f"rans16 shards landed on cards {cards}")
    one = jax.devices()[0]
    buf1, counts1, hi1, lo1 = rans_codec._encode_device(
        jax.device_put(rows, one), jax.device_put(words, one),
        group_lanes=g, interpret=interpret_kernels())
    for a, b in ((counts, counts1), (hi, hi1), (lo, lo1)):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError("sharded rans16 encode differs from 1 card")
    totals = np.asarray(counts1).sum(axis=1)
    b4, b1 = np.asarray(buf), np.asarray(buf1)
    for gi, n in enumerate(totals):
        if not np.array_equal(b4[gi, b4.shape[1] - n:],
                              b1[gi, b1.shape[1] - n:]):
            raise AssertionError(f"sharded rans16 stream of group {gi}")
    blob = api.encode(rows.reshape(-1), alphabet=256,
                      config=api.CodecConfig(profile="rans16", block_len=L))
    from range_coder_rust_tpu import format as fmt

    parsed = [rans_codec._parse_payload(p, L, g)
              for p in fmt.unpack(blob).payloads]
    stream, offsets = rans_codec._stage_stream(
        [r for _, _, r in parsed], n_rows=4)
    hi_p, lo_p = rans_codec._states_from6([p6 for _, p6, _ in parsed], g)
    t0 = time.perf_counter()
    out = jax.block_until_ready(dec(
        *(jax.device_put(x, sh) for x in (stream, offsets, hi_p, lo_p)),
        jax.device_put(cum, rep)))
    res["rans16_decode_4_s"] = round(time.perf_counter() - t0, 3)
    if not np.array_equal(np.asarray(out).transpose(0, 2, 1).reshape(
            ng * g, L), rows):
        raise AssertionError("sharded rans16 decode is not bit-exact")
    res["rans16_groups"] = ng

    # planar: blocks sharded over the cards
    k, Lp = 16, 512
    pdata = data[:planar_bytes].reshape(-1, Lp)
    tp = build_table_pow2(np.bincount(pdata.reshape(-1), minlength=256)
                          .astype(np.uint64), k)
    cap = default_capacity(Lp, k)
    penc, pdec = make_sharded_codec(mesh, k=k, block_len=Lp, capacity=cap)
    c_d, cum_d = jnp.asarray(tp.c), jnp.asarray(tp.cum)
    t0 = time.perf_counter()
    code4, len4 = jax.block_until_ready(penc(
        jax.device_put(pdata, sh), jax.device_put(c_d, rep),
        jax.device_put(cum_d, rep)))
    res["planar_encode_4_s"] = round(time.perf_counter() - t0, 3)
    if len({s.device.id for s in code4.addressable_shards}) != 4:
        raise AssertionError("planar shards did not land on 4 cards")
    code1, len1 = encode_blocks(jax.device_put(pdata, one), c_d, cum_d, k=k,
                                capacity=cap)
    if not (np.array_equal(np.asarray(code4), np.asarray(code1))
            and np.array_equal(np.asarray(len4), np.asarray(len1))):
        raise AssertionError("sharded planar encode differs from 1 card")
    pout = pdec(code4, jax.device_put(c_d, rep), jax.device_put(cum_d, rep))
    if not np.array_equal(np.asarray(pout), pdata):
        raise AssertionError("sharded planar decode is not bit-exact")
    res["planar_blocks"] = pdata.shape[0]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on 4 cards")
    ap.add_argument("--seed", type=int, default=0xC0)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX's platform is {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from range_coder_rust_tpu.utils.compile_cache import use_compile_cache

    print(f"compile cache: {use_compile_cache()}", flush=True)
    smoke = Smoke()
    smoke.phase("device", lambda: phase_device(jax))
    from bench import make_corpus

    t0 = time.perf_counter()
    data = make_corpus(1024 * MB, args.seed)
    print(f"corpus: {data.size} Zipf(1.2) bytes, seed {args.seed}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if args.four_cards:
        smoke.phase("four_cards", lambda: phase_four_cards(jax, jnp, data))
    else:
        smoke.phase("rans16_1GB", lambda: phase_rans16(jax, jnp, data))
        smoke.phase("adaptive_256MB", lambda: phase_adaptive(data[:256 * MB]))
        smoke.phase("sync_decode_range_256MB",
                    lambda: phase_sync(data[:256 * MB]))
        smoke.phase("planar_64MB", lambda: phase_planar(data[:64 * MB]))
    if smoke.failed:
        print(f"failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
