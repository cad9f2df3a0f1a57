"""Multi-host orchestration: N JAX processes, one global mesh, ordered gather.

The reference has no distribution at all — its only "transport" is an
in-process ``VecDeque`` append/pop (reference src/encoder.rs:35,
src/decoder.rs:33; SURVEY.md §2 "communication backend: NONE").  This module
is the multi-process answer mandated by SURVEY.md §5/§7 step 7:

* processes join via :func:`initialize` (``jax.distributed``);
* the block axis is sharded over ONE global 1-D mesh spanning every card
  of every host — the coder math is elementwise over blocks (blocks.py), so
  the hot loop still has **zero** communication;
* the two real collectives ride outside the hot loop, exactly as planned in
  SURVEY.md §2: per-block compressed lengths are all-gathered so every host
  knows the container offsets, and the fixed-capacity payload rows are
  gathered (NVLink within a host, the network across hosts) so process 0
  can assemble
  the container in block order;
* container assembly itself (trim rows by length, pack) is host-side and
  identical to the single-host path (format.py) — byte-for-byte the same
  container regardless of process count, which is what the tests pin.

On GPUs run one process per card: each process joins with
``initialize(..., local_device_ids=[card])`` so it owns exactly one
device.  The same code runs as N local CPU processes
(``jax.distributed.initialize`` + ``--xla_force_host_platform_device_count``),
which is how tests/test_multihost.py exercises the multi-process path on
one machine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.experimental import multihost_utils

from .. import format as fmt
from ..blocks import default_capacity
from .dist import AXIS, block_sharding, default_mesh, make_sharded_codec, replicated


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    **kw,
) -> None:
    """Join the process group (thin wrapper over ``jax.distributed``).

    Nothing detects a GPU cluster, so every process passes the
    coordinator (``host:port`` of process 0), the process count and its
    own id.  With one process per card, pass ``local_device_ids=[i]``
    (forwarded to ``jax.distributed.initialize``) so process ``i`` owns
    card ``i`` only.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def global_mesh() -> jax.sharding.Mesh:
    """1-D mesh over every device of every process."""
    return default_mesh(jax.devices())


def local_block_range(n_blocks: int, mesh: Optional[jax.sharding.Mesh] = None
                      ) -> Tuple[int, int]:
    """The [start, stop) rows of the global block axis this process owns.

    Blocks are laid out contiguously in mesh-device order, so a process's
    rows are those of its addressable devices.  ``n_blocks`` must divide
    evenly over the mesh (pad the corpus to a multiple — api.py's padding
    rule applies globally).
    """
    mesh = mesh or global_mesh()
    devs = list(mesh.devices.flat)
    n_dev = len(devs)
    if n_blocks % n_dev:
        raise ValueError(f"{n_blocks} blocks not divisible by {n_dev} devices")
    per = n_blocks // n_dev
    mine = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError("mesh devices of one process must be contiguous")
    return mine[0] * per, (mine[0] + len(mine)) * per


def encode_multihost(
    local_rows: np.ndarray,
    c: np.ndarray,
    cum: np.ndarray,
    *,
    k: int,
    n_blocks: int,
    capacity: Optional[int] = None,
    mesh: Optional[jax.sharding.Mesh] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode this process's block rows as part of the global batch.

    Arguments:
      local_rows: ``(B_local, L)`` int32 — exactly the rows
        :func:`local_block_range` assigns this process.
      c / cum: the shared pow2 table (replicated to every host by value —
        table build is deterministic, so hosts agree without a broadcast).
      n_blocks: global block count ``B`` (must shard evenly).

    Returns ``(code, lengths)`` **fully replicated on every host** as NumPy:
    ``code (B, C) uint8`` and ``lengths (B,) int32`` in global block order —
    the ordered gather.  Process 0 (or any process) can then assemble the
    container with :func:`assemble_container`.
    """
    mesh = mesh or global_mesh()
    L = int(local_rows.shape[1])
    cap = capacity if capacity is not None else default_capacity(L, k)

    enc, _ = make_sharded_codec(mesh, k=k, block_len=L, capacity=cap)

    sharding = block_sharding(mesh)
    syms = jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_rows, np.int32), (n_blocks, L)
    )
    repl = replicated(mesh)
    c_g = jax.make_array_from_process_local_data(repl, np.asarray(c, np.uint32))
    cum_g = jax.make_array_from_process_local_data(repl, np.asarray(cum, np.uint32))

    code, lengths = enc(syms, c_g, cum_g)

    # the ordered gather: lengths first (tiny), then TRIMMED payload bytes
    # — round 3 all-gathered the capacity-padded (B, C) rows, ~2x the
    # compressed bytes of unnecessary cross-process traffic (VERDICT r3 item 3)
    lengths_all = np.asarray(
        multihost_utils.process_allgather(lengths, tiled=True)
    ).astype(np.int32)
    code_local = _local_rows(code)
    lens_local = _local_rows(lengths)
    local_payloads = [
        code_local[i, : int(l)].tobytes()
        for i, l in enumerate(lens_local)
    ]
    payloads = gather_payload_bytes(local_payloads, lengths_all)
    return payloads, lengths_all


def _local_rows(arr: jax.Array) -> np.ndarray:
    """This process's contiguous row-shard of a block-sharded array."""
    shards = sorted(
        (s for s in arr.addressable_shards), key=lambda s: s.index[0].start
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def gather_payload_bytes(
    local_payloads, lengths_all: np.ndarray
) -> list:
    """Ordered all-gather of variable-length payload BYTES.

    Every process holds the payloads of its contiguous unit range; the
    global per-unit ``lengths_all`` (already all-gathered — bytes, tiny)
    tell every process how to split the gathered byte stream.  The gather moves
    each process's CONCATENATED TRIMMED bytes padded only to the largest
    per-process total (balanced shards => negligible padding), not
    capacity-padded rows.  Returns the global payload list (replicated).
    """
    nproc = jax.process_count()
    per = lengths_all.shape[0] // nproc
    proc_tot = lengths_all.reshape(nproc, per).sum(axis=1)
    max_tot = int(proc_tot.max())
    buf = np.zeros(max_tot, np.uint8)
    cat = b"".join(bytes(p) for p in local_payloads)
    buf[: len(cat)] = np.frombuffer(cat, np.uint8)
    rows = np.asarray(
        multihost_utils.process_allgather(buf))          # (nproc, max_tot)
    if rows.ndim == 1:  # single process: allgather returns the buffer
        rows = rows[None, :]
    payloads = []
    for p in range(nproc):
        offs = np.concatenate(
            [[0], np.cumsum(lengths_all.reshape(nproc, per)[p])])
        for i in range(per):
            payloads.append(rows[p, offs[i] : offs[i + 1]].tobytes())
    return payloads


def local_group_range(n_groups: int, mesh: Optional[jax.sharding.Mesh] = None
                      ) -> Tuple[int, int]:
    """The [start, stop) rans16 groups this process owns (contiguous,
    even split over processes — the group analogue of
    :func:`local_block_range`)."""
    nproc = jax.process_count()
    if n_groups % nproc:
        raise ValueError(f"{n_groups} groups not divisible by {nproc} processes")
    per = n_groups // nproc
    pid = jax.process_index()
    return pid * per, (pid + 1) * per


def encode_multihost_rans16(
    local_rows: np.ndarray,
    table,
    *,
    block_len: int,
    n_groups: int,
    group_lanes: int = None,
    sync_tiles: int = 0,
) -> list:
    """Encode this process's rans16 groups; ordered-gather ALL payloads.

    ``local_rows``: ``(per_process_groups * GROUP_LANES, L)`` — exactly
    the rows of :func:`local_group_range`'s group range.  Each process
    runs the standard local device pipeline (rans_codec.encode_groups —
    groups are fully independent coder units, so the group axis is the
    cross-process data-parallel axis with zero hot-loop communication); the only
    collectives are the per-group payload lengths and the trimmed payload
    bytes.  Returns the COMPLETE global payload list on every process —
    process 0 (or any) packs the container, byte-identical to the
    single-process api output (tests/test_multihost.py).
    """
    from .. import rans_codec

    local_payloads = rans_codec.encode_groups(
        local_rows, table, block_len, sync_tiles, group_lanes)
    lens_local = np.array([len(p) for p in local_payloads], np.int32)
    lengths_all = np.asarray(multihost_utils.process_allgather(
        lens_local, tiled=True)).astype(np.int32)
    return gather_payload_bytes(local_payloads, lengths_all)


def decode_multihost_rans16(
    payloads, table_c: np.ndarray, *, block_len: int,
    group_lanes: int = None,
) -> np.ndarray:
    """Decode this process's group range of a global payload list (the
    mirror of :func:`encode_multihost_rans16`; every process holds the
    replicated payload list after the gather, or parsed it from a
    container) — returns this process's ``(local_groups * G, L)`` rows.

    ``table_c``: (A,) shared counts, or (NG, A) per-group counts for
    ADAPTIVE containers — per-group tables are sliced to this process's
    group range alongside the payloads (advisor r4: an unsliced 2-D
    table paired process 1+'s groups with process 0's tables)."""
    from .. import rans_codec

    lo, hi = local_group_range(len(payloads))
    tc = np.asarray(table_c)
    if tc.ndim == 2:
        tc = tc[lo:hi]
    return rans_codec.decode_groups(payloads[lo:hi], tc, block_len,
                                    group_lanes)


def assemble_container(
    payloads,
    lengths: np.ndarray = None,
    *,
    k: int,
    alphabet: int,
    block_len: int,
    n_symbols: int,
    tables_c: np.ndarray,
    with_checksums: bool = True,
    profile: str = "planar",
    group_lanes: int = 0,
) -> bytes:
    """Pack the gathered payloads into the standard container —
    byte-identical to the single-host api.py output for the same corpus.

    ``payloads``: list of per-unit payload bytes (the gather output), or
    a legacy ``(B, C)`` padded code matrix with ``lengths`` to trim by."""
    if not isinstance(payloads, list):
        code = payloads
        payloads = [code[i, : int(lengths[i])].tobytes()
                    for i in range(code.shape[0])]
    return fmt.pack(
        k=k,
        alphabet=alphabet,
        block_len=block_len,
        n_symbols=n_symbols,
        payloads=payloads,
        tables_c=np.asarray(tables_c, np.uint32),
        per_block_tables=False,
        with_checksums=with_checksums,
        profile=profile,
        group_lanes=group_lanes,
    )
