"""Multi-host (multi-process) path: 2 JAX processes x 2 virtual CPU
devices encode a shared corpus as one global mesh; process 0's container
must be byte-identical to the single-process one, and must decode.

This is the single-machine simulation of SURVEY.md §7 step 7 (multi-host
via ``jax.distributed.initialize`` — SURVEY.md §4 "subprocess-spawned ...
for multi-process paths").
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_container(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_NUM_CPU_DEVICES")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), "2", str(pid), str(outdir)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_OK {pid}" in out
    return {
        "planar": (outdir / "container.bin").read_bytes(),
        "rans16": (outdir / "container_rans16.bin").read_bytes(),
    }


def _expected_corpus():
    rng = np.random.default_rng(42)
    return rng.integers(0, 32, size=(16, 128)).astype(np.int32)


def test_multihost_container_decodes(multihost_container):
    from range_coder_rust_tpu.api import decode

    data = _expected_corpus()
    out = decode(multihost_container["planar"])
    assert np.array_equal(out.reshape(16, 128), data)


def test_multihost_matches_single_process(multihost_container):
    import jax.numpy as jnp

    from range_coder_rust_tpu.blocks import default_capacity, encode_blocks
    from range_coder_rust_tpu.models.table import table_from_data_pow2
    from range_coder_rust_tpu.parallel.multihost import assemble_container

    data = _expected_corpus()
    B, L, k, A = 16, 128, 12, 32
    t = table_from_data_pow2(data, A, k)
    cap = default_capacity(L, k)
    code, lengths = encode_blocks(
        jnp.asarray(data), jnp.asarray(t.c), jnp.asarray(t.cum), k=k, capacity=cap
    )
    blob = assemble_container(
        np.asarray(code),
        np.asarray(lengths),
        k=k,
        alphabet=A,
        block_len=L,
        n_symbols=B * L,
        tables_c=t.c,
    )
    assert blob == multihost_container["planar"]


def test_multihost_rans16_matches_single_process(multihost_container):
    """The flagship rans16 profile over the multi-process path: the 2-process
    container (group axis sharded over processes, trimmed-byte ordered
    gather) must be byte-identical to the single-process product path
    and must decode (VERDICT r3 item 3)."""
    from range_coder_rust_tpu import rans, rans_codec
    from range_coder_rust_tpu import format as fmt
    from range_coder_rust_tpu.api import decode
    from range_coder_rust_tpu.models.table import table_from_data_pow2

    G = rans.GROUP_LANES
    L16, NGROUPS = 8, 2
    rng2 = np.random.default_rng(43)
    data16 = rng2.integers(0, 64, size=(NGROUPS * G, L16)).astype(np.int32)
    t16 = table_from_data_pow2(data16, 64, 16)
    blob = rans_codec.encode(
        data16.reshape(-1), alphabet=64, table=t16, block_len=L16)
    assert blob == multihost_container["rans16"]
    out = decode(multihost_container["rans16"])
    assert np.array_equal(out, data16.reshape(-1))
