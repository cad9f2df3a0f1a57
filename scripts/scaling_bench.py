"""Weak-scaling measurement of the planar codec on a virtual CPU mesh —
CPU timings of the partitioning overhead, not device numbers (the
four-card device path is ``python chip_smoke.py --four-cards``).

Geometry per the round-2 verdict: >= 64 MB of symbols PER DEVICE so every
timing is seconds-scale, not dispatch noise.  The N virtual devices share
this host's physical cores (os.cpu_count() of them), so raw weak-scaling
wall time necessarily grows ~N/cores; the scaling-relevant quantities are

* ``efficiency_vs_core_limit[N] = t(1) * N / cores_used(N) / t(N)`` —
  the weak-scaling time normalized by the unavoidable core
  oversubscription; near 1.0 means partitioning adds no work.
* ``overhead_vs_unsharded_same_work``: the SAME total corpus, one device
  unsharded vs 8 devices sharded — directly the cost XLA's partitioning
  adds (target <= 1.1).  The hot loop has no collectives by design
  (parallel/dist.py): blocks are independent, tables replicated.

Prints one JSON object; with RC_SCALE_OUT set, also merges it into that
file (so sections and the multihost record accumulate).
Usage: python scripts/scaling_bench.py
Env: RC_SCALE_MB_PER_DEV (default 64), RC_SCALE_L (default 4096),
RC_SCALE_REPS (default 2), RC_SCALE_SECTIONS (comma list of
weak,samework,stages; default all — the timings are contention-sensitive
on a host with few cores, so sections can be rerun individually on a quiet
box).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# pin the CPU backend through jax.config too, in case anything imported
# jax before the environment variable was set
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from range_coder_rust_tpu.models.table import table_from_data_pow2
from range_coder_rust_tpu.parallel.dist import default_mesh, make_sharded_codec


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_n(n_dev: int, blocks_per_dev: int, L: int, k: int, reps: int):
    """Returns (total_s, enc_s, dec_s, n_symbols) best-of-reps."""
    devs = jax.devices()[:n_dev]
    mesh = default_mesh(devs)
    B = blocks_per_dev * n_dev
    rng = np.random.default_rng(42)
    ranks = np.arange(1, 257)
    p = 1.0 / ranks**1.2
    p /= p.sum()
    data = rng.choice(256, size=(B, L), p=p).astype(np.int32)
    t = table_from_data_pow2(data, 256, k)
    cap = -(-(3 * L + 8) // 4) * 4
    enc, dec = make_sharded_codec(mesh, k=k, block_len=L, capacity=cap)
    c, cum = jnp.asarray(t.c), jnp.asarray(t.cum)
    syms = jnp.asarray(data)

    code, lengths = enc(syms, c, cum)
    out = dec(code, c, cum)
    jax.block_until_ready((code, lengths, out))
    assert np.array_equal(np.asarray(out), data), "sharded round trip failed"

    best = ebest = dbest = None
    for _ in range(reps):
        t0 = time.time()
        code, lengths = enc(syms, c, cum)
        jax.block_until_ready((code, lengths))
        te = time.time() - t0
        t0 = time.time()
        out = dec(code, c, cum)
        jax.block_until_ready(out)
        td = time.time() - t0
        ebest = te if ebest is None else min(ebest, te)
        dbest = td if dbest is None else min(dbest, td)
        best = te + td if best is None else min(best, te + td)
    return best, ebest, dbest, B * L


def bench_control(n_dev: int, blocks_per_dev: int, L: int, reps: int):
    """Partitioning-floor control: a trivial memory-bound elementwise op
    over the SAME array geometry, sharded the same way — any overhead the
    virtual CPU mesh's scheduling adds shows up here with zero algorithm
    in the loop."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    devs = jax.devices()[:n_dev]
    mesh = default_mesh(devs)
    B = blocks_per_dev * n_dev
    x = jnp.asarray(np.arange(B * L, dtype=np.int32).reshape(B, L))
    sh = NamedSharding(mesh, P("blocks"))
    f = jax.jit(lambda v: (v * 3 + 1) ^ (v >> 5),
                in_shardings=sh, out_shardings=sh)
    y = jax.block_until_ready(f(x))
    best = None
    for _ in range(reps):
        t0 = time.time()
        for _i in range(8):
            y = f(y)
        jax.block_until_ready(y)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return best


def decode_stage_table(blocks_total: int, L: int, k: int, reps: int):
    """Per-stage 8-dev-sharded vs 1-dev-unsharded decode timings (VERDICT
    r4 item 7: the 1.94x decode overhead was hand-waved as 'partition
    bookkeeping + oversubscription' with no stage numbers).  Stages:

      to_words   — (B, C) u8 -> (B, C/4) u32 big-endian repack (layout)
      scan       — the lock-step symbol scan on pre-packed words (kernel)
      transpose  — (L, B) scan output -> (B, L) result layout

    Each stage is timed under the SAME sharding in both configs, so the
    table attributes the sharded/unsharded ratio stage by stage.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from range_coder_rust_tpu.blocks import (
        bytes_to_words_be, decode_find_rfreq, encode_blocks, init_state,
        lookup, param_update_pow2)

    rng = np.random.default_rng(42)
    ranks = np.arange(1, 257)
    p = 1.0 / ranks**1.2
    p /= p.sum()
    data = rng.choice(256, size=(blocks_total, L), p=p).astype(np.int32)
    t = table_from_data_pow2(data, 256, k)
    cap = -(-(3 * L + 8) // 4) * 4
    c, cum = jnp.asarray(t.c), jnp.asarray(t.cum)
    code, _ = encode_blocks(jnp.asarray(data), c, cum, k=k, capacity=cap)
    code = jax.block_until_ready(code)
    B, C = code.shape

    def scan_only(code32, c, cum):
        def step(carry, _):
            st, cursor = carry
            whi, _ = lookup.window_extract(code32, cursor - 8)
            rfreq = decode_find_rfreq(st, whi, k)
            idx, cc, cu = lookup.sweep_find(c, cum, rfreq)
            st, _, n = param_update_pow2(st, cc, cu, k)
            return (st, cursor + n), idx

        cursor0 = jnp.full((code32.shape[0],), 8, jnp.int32)
        (_, _), syms = jax.lax.scan(
            step, (init_state((code32.shape[0],)), cursor0), None,
            length=L)
        return syms  # (L, B) — transpose timed separately

    table = {}
    for n_dev in (1, 8):
        mesh = default_mesh(jax.devices()[:n_dev])
        shard = NamedSharding(mesh, P("blocks"))
        shard_t = NamedSharding(mesh, P(None, "blocks"))
        repl = NamedSharding(mesh, P())
        code_d = jax.device_put(code, shard)
        f_words = jax.jit(bytes_to_words_be, in_shardings=shard,
                          out_shardings=shard)
        code32 = jax.block_until_ready(f_words(code_d))
        f_scan = jax.jit(scan_only, in_shardings=(shard, repl, repl),
                         out_shardings=shard_t)
        syms = jax.block_until_ready(
            f_scan(code32, jax.device_put(c, repl),
                   jax.device_put(cum, repl)))
        f_tr = jax.jit(lambda s: s.T, in_shardings=shard_t,
                       out_shardings=shard)
        jax.block_until_ready(f_tr(syms))

        stages = {}
        for name, fn, arg in (
                ("to_words", f_words, code_d),
                ("scan", lambda x: f_scan(x, c, cum), code32),
                ("transpose", f_tr, syms)):
            best = None
            for _ in range(reps):
                t0 = time.time()
                jax.block_until_ready(fn(arg))
                dt = time.time() - t0
                best = dt if best is None else min(best, dt)
            stages[name] = round(best, 3)
        table[f"{n_dev}dev"] = stages
        log(f"decode stages {n_dev} dev: {stages}")
    ratios = {s: round(table["8dev"][s] / table["1dev"][s], 3)
              for s in table["1dev"]}
    table["ratio_8v1"] = ratios
    log(f"decode stage ratios 8dev/1dev: {ratios}")
    return table


def main():
    L = int(os.environ.get("RC_SCALE_L", "4096"))
    k = 16
    mb_per_dev = int(os.environ.get("RC_SCALE_MB_PER_DEV", "64"))
    reps = int(os.environ.get("RC_SCALE_REPS", "2"))
    sections = set(os.environ.get(
        "RC_SCALE_SECTIONS", "weak,samework,stages").split(","))
    bpd = (mb_per_dev << 20) // L
    cores = os.cpu_count() or 1

    path = os.environ.get("RC_SCALE_OUT")
    out = {}
    if path and os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.update({
        "metric": "weak-scaling (virtual 8-device CPU mesh)",
        "mb_per_device": mb_per_dev,
        "host_cores": cores,
        "note": ("virtual devices share this host's physical cores, so "
                 "weak-scaling wall time grows ~N/cores by construction; "
                 "the partitioning-cost signal is "
                 "overhead_vs_unsharded_same_work (hot loop has no "
                 "collectives — the block axis is embarrassingly "
                 "parallel)"),
        "block_len": L,
        "blocks_per_device": bpd,
    })

    if "weak" in sections:
        results = {}
        # weak scaling: per-device work fixed at mb_per_dev
        for n in (1, 2, 4, 8):
            dt, _e, _d, n_sym = bench_n(n, bpd, L, k, reps)
            results[n] = {"time_s": round(dt, 2), "symbols": n_sym,
                          "mb_per_s": round(n_sym / dt / 1e6, 1)}
            log(f"{n} dev: {dt:.2f} s for {n_sym >> 20} M syms (weak, "
                f"{min(n, cores)}/{cores} cores busy)")
        t1 = results[1]["time_s"]
        for n, r in results.items():
            # ideal weak time on this host: t(1) * (devices / cores used)
            ideal = t1 * n / min(n, cores)
            r["efficiency_vs_core_limit"] = round(ideal / r["time_s"], 3)
        out["weak_scaling"] = results

    if "samework" in sections:
        # same TOTAL work: 1 device unsharded vs 8 devices sharded,
        # stage-attributed (VERDICT r3 item 5)
        dt1, e1, d1, n_sym = bench_n(1, bpd * 8, L, k, reps)
        dt8, e8, d8, _ = bench_n(8, bpd, L, k, reps)
        overhead = dt8 / dt1
        log(f"8-dev sharded vs 1-dev unsharded, same {n_sym >> 20} M "
            f"syms: {overhead:.3f}x (encode {e8 / e1:.3f}x, decode "
            f"{d8 / d1:.3f}x)")

        # control: the same sharding with a trivial op — the virtual-mesh
        # scheduling floor on this oversubscribed host
        c1 = bench_control(1, bpd * 8, L, reps)
        c8 = bench_control(8, bpd, L, reps)
        control = c8 / c1
        log(f"control (trivial sharded op, same geometry): {control:.3f}x")
        out["overhead_vs_unsharded_same_work"] = round(overhead, 4)
        out["overhead_encode"] = round(e8 / e1, 4)
        out["overhead_decode"] = round(d8 / d1, 4)
        out["overhead_control_trivial_op"] = round(control, 4)

    if "stages" in sections:
        # per-stage decode attribution (smaller corpus: the scan stage is
        # timed per stage, and 8x64 MB of scan at CPU speed takes hours)
        stage_blocks = max(8, ((8 << 20) // L) // 8 * 8)
        out["decode_stage_table"] = decode_stage_table(
            stage_blocks, L, k, reps)

    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
