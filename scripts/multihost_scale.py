"""2-process multihost rans16 scaling record with gather-byte accounting
(multihost correctness is pinned at toy scale by the tests; this
measures the gather's byte ratio at a larger group count).

Parent mode (default): spawns 2 real processes (the multi-process path of
tests/test_multihost.py — jax.distributed over localhost, 2 virtual CPU
devices each), waits, and prints their merged JSON (also written to
``RC_SCALE_OUT`` under "multihost_2proc" when that is set).

Worker mode (argv: worker PORT NPROC PID OUTDIR): encodes its contiguous
group range of a shared corpus through the standard local device pipeline
(rans_codec.encode_groups under CPU interpret — the kernels are the same
program hardware runs), ordered-gathers the trimmed payload bytes, round
trips its share, and records:

  * local encode/decode wall seconds (CPU interpret — NOT a throughput
    claim; device throughput comes from bench.py on a GPU),
  * gather wall seconds,
  * gathered bytes / compressed payload bytes (the round-3 design
    all-gathered capacity-padded rows at ~2x; trimmed gathering should
    sit at ~nproc * max-process-total / total ~ 1.0 for balanced shards).

Usage: python scripts/multihost_scale.py   (env: RC_MH_GROUPS_PER_PROC,
default 32; RC_MH_L, default 64; RC_MH_G, default 1024)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(port: str, nproc: int, pid: int, outdir: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")

    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu import rans_codec
    from range_coder_rust_tpu.models.table import table_from_data_pow2
    from range_coder_rust_tpu.parallel import multihost as mh

    mh.initialize(f"localhost:{port}", nproc, pid)

    gpp = int(os.environ.get("RC_MH_GROUPS_PER_PROC", "32"))
    L = int(os.environ.get("RC_MH_L", "64"))
    G = int(os.environ.get("RC_MH_G", "1024"))
    NG = gpp * nproc
    n = NG * G * L

    # every process derives the same corpus + table deterministically
    rng = np.random.default_rng(7)
    ranks = np.arange(1, 257)
    p = 1.0 / ranks**1.2
    p /= p.sum()
    data = rng.choice(256, size=n, p=p).astype(np.int32).reshape(NG * G, L)
    t = table_from_data_pow2(data, 256, 16)

    lo, hi = mh.local_group_range(NG)
    t0 = time.time()
    local_payloads = rans_codec.encode_groups(
        data[lo * G : hi * G], t, L, 0, G)
    enc_s = time.time() - t0

    lens_local = np.array([len(p_) for p_ in local_payloads], np.int32)
    t0 = time.time()
    from jax.experimental import multihost_utils

    lengths_all = np.asarray(multihost_utils.process_allgather(
        lens_local, tiled=True)).astype(np.int32)
    payloads = mh.gather_payload_bytes(local_payloads, lengths_all)
    gather_s = time.time() - t0

    # DCN byte accounting: gather_payload_bytes moves nproc buffers padded
    # to the largest per-process total, plus the tiny lengths vector
    per = lengths_all.shape[0] // nproc
    proc_tot = lengths_all.reshape(nproc, per).sum(axis=1)
    gathered = int(nproc * proc_tot.max()) + lengths_all.nbytes
    compressed = int(lengths_all.sum())

    t0 = time.time()
    local = mh.decode_multihost_rans16(payloads, t.c, block_len=L,
                                       group_lanes=G)
    dec_s = time.time() - t0
    assert np.array_equal(local, data[lo * G : hi * G]), "mh round trip"

    if pid == 0:
        blob = mh.assemble_container(
            payloads, k=16, alphabet=256, block_len=L, n_symbols=n,
            tables_c=t.c, profile="rans16", group_lanes=G)
        # byte-parity with the single-process product container
        solo = rans_codec.encode(data.reshape(-1), alphabet=256, table=t,
                                 block_len=L, group_lanes=G)
        rec = {
            "processes": nproc,
            "groups": NG,
            "group_lanes": G,
            "block_len": L,
            "symbols_total": n,
            "mb_total": round(n / 1e6, 1),
            "encode_wall_s_proc0": round(enc_s, 2),
            "gather_wall_s": round(gather_s, 2),
            "decode_wall_s_proc0": round(dec_s, 2),
            "gathered_bytes": gathered,
            "compressed_bytes": compressed,
            "gather_byte_ratio": round(gathered / compressed, 4),
            "container_byte_identical_to_single_process": blob == solo,
            "note": ("CPU-interpret walls (same kernel program the GPU "
                     "compiles, not a throughput claim); the trimmed-byte "
                     "ordered gather moves ~1.0x the compressed bytes"),
        }
        with open(os.path.join(outdir, "mh_record.json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"WORKER_OK {pid}", flush=True)


def main() -> None:
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    outdir = tempfile.mkdtemp(prefix="mh_scale_")
    nproc = 2
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", port,
             str(nproc), str(pid), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)
    ]
    ok = True
    for p in procs:
        out, _ = p.communicate(timeout=3600)
        tail = out.decode(errors="replace").strip().splitlines()[-8:]
        print("\n".join(tail), flush=True)
        ok &= p.returncode == 0
    if not ok:
        sys.exit("multihost scale run failed")
    with open(os.path.join(outdir, "mh_record.json")) as f:
        rec = json.load(f)
    path = os.environ.get("RC_SCALE_OUT")
    if path:
        merged = {}
        if os.path.exists(path):
            with open(path) as f:
                merged = json.load(f)
        merged["multihost_2proc"] = rec
        with open(path, "w") as f:
            json.dump(merged, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5])
    else:
        main()
