"""One process of the multi-host test (spawned by tests/test_multihost.py).

Simulates one host: 2 virtual CPU devices, joined to the global process
group over the jax.distributed coordinator.
Usage: python multihost_worker.py PORT NPROC PID OUTDIR
"""

import os
import sys

port, nproc, pid, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

# pin the platform via config as well: if anything imported jax before
# this script ran, the environment variable alone is read too late
jax.config.update("jax_platforms", "cpu")

from range_coder_rust_tpu.models.table import table_from_data_pow2  # noqa: E402
from range_coder_rust_tpu.parallel import multihost as mh  # noqa: E402

mh.initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, jax.devices()

# every host derives the same corpus + table deterministically (no broadcast)
B, L, k, A = 16, 128, 12, 32
rng = np.random.default_rng(42)
data = rng.integers(0, A, size=(B, L)).astype(np.int32)
t = table_from_data_pow2(data, A, k)

mesh = mh.global_mesh()
lo, hi = mh.local_block_range(B, mesh)
payloads, lengths_all = mh.encode_multihost(
    data[lo:hi], t.c, t.cum, k=k, n_blocks=B, mesh=mesh
)

if jax.process_index() == 0:
    blob = mh.assemble_container(
        payloads,
        k=k,
        alphabet=A,
        block_len=L,
        n_symbols=B * L,
        tables_c=t.c,
    )
    with open(os.path.join(outdir, "container.bin"), "wb") as f:
        f.write(blob)

# ---- rans16 leg: the flagship profile over the same multi-process path
from range_coder_rust_tpu import rans  # noqa: E402

G = rans.GROUP_LANES
L16 = 8
NGROUPS = 2
rng2 = np.random.default_rng(43)
data16 = rng2.integers(0, 64, size=(NGROUPS * G, L16)).astype(np.int32)
t16 = table_from_data_pow2(data16, 64, 16)
glo, ghi = mh.local_group_range(NGROUPS, mesh)
payloads16 = mh.encode_multihost_rans16(
    data16[glo * G : ghi * G], t16, block_len=L16, n_groups=NGROUPS)

# round-trip this process's share through the multihost decoder
local = mh.decode_multihost_rans16(payloads16, t16.c, block_len=L16)
assert np.array_equal(local, data16[glo * G : ghi * G]), "rans16 mh decode"

if jax.process_index() == 0:
    blob16 = mh.assemble_container(
        payloads16,
        k=16,
        alphabet=64,
        block_len=L16,
        n_symbols=NGROUPS * G * L16,
        tables_c=t16.c,
        profile="rans16",
        group_lanes=G,
    )
    with open(os.path.join(outdir, "container_rans16.bin"), "wb") as f:
        f.write(blob16)

print(f"WORKER_OK {pid}", flush=True)
