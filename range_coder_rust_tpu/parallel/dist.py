"""Sharded block-parallel codec over a device mesh.

Design (SPMD, scaling-book recipe): pick a 1-D mesh over all devices, shard
the block axis ``B`` across it, replicate the frequency table, and let XLA
insert the collectives.  The coder's math is purely elementwise over the
block axis (blocks.py), so partitioning introduces **zero** communication in
the hot loop — the only collectives are the table broadcast (replicated
sharding) and the host gather of per-block lengths/payloads for container
assembly, the XLA-native analogue of the reference's in-process byte
appends (src/encoder.rs:35; SURVEY.md §2 'communication backend').

Works identically on one GPU, the cards of one host (all joined by NVLink,
so a 1-D mesh over the block axis is the whole layout), or N virtual CPU
devices (``--xla_force_host_platform_device_count``) — the mesh is the only
degree of freedom.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..blocks import compact_emissions, decode_blocks, encode_scan

#: the single mesh axis name: blocks are the unit of data parallelism
AXIS = "blocks"


def default_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (AXIS,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (= blocks) split across the mesh; trailing dims replicated."""
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def make_sharded_codec(
    mesh: Mesh, *, k: int, block_len: int, capacity: int
) -> Tuple[Callable, Callable]:
    """Jitted (encode, decode) with explicit input/output shardings.

    encode(symbols (B, L) int32, c (A,), cum (A+1,)) -> (code (B, C) u8,
    lengths (B,) i32); decode(code (B, C) u8, c, cum) -> symbols (B, L).
    ``B`` must be a multiple of the mesh size for even sharding.
    """
    shard_b = block_sharding(mesh)
    repl = replicated(mesh)

    enc_scan = jax.jit(
        functools.partial(encode_scan.__wrapped__, k=k),
        in_shardings=(shard_b, repl, repl),
        out_shardings=(shard_b,) * 5,
    )
    enc_compact = jax.jit(
        functools.partial(compact_emissions.__wrapped__, capacity=capacity),
        in_shardings=(shard_b,) * 4,
        out_shardings=shard_b,
    )

    def enc(symbols, c, cum):
        ehi, elo, en, pos, lengths = enc_scan(symbols, c, cum)
        return enc_compact(ehi, elo, en, pos), lengths
    dec = jax.jit(
        functools.partial(decode_blocks.__wrapped__, k=k, block_len=block_len),
        in_shardings=(shard_b, repl, repl),
        out_shardings=shard_b,
    )
    return enc, dec


def make_sharded_rans16(
    mesh: Mesh, *, block_len: int, a_count: int,
    group_lanes: Optional[int] = None, per_group_tables: bool = False
) -> Tuple[Callable, Callable]:
    """Mesh-sharded rans16 kernels: groups are the data-parallel axis.

    Groups are fully independent coder units (exactly like planar blocks),
    so the partitioning is communication-free; the Pallas kernels run
    per-shard under ``shard_map`` (XLA cannot split a pallas_call by
    itself).  Outputs are bit-identical to the single-device kernels —
    container assembly downstream is unchanged, which is what makes the
    sharded container byte-identical (tests/test_parallel.py).

    With G = ``group_lanes`` (default rans.GROUP_LANES):

    encode(rows (NG*G, L) any-int, words) -> (buf (NG, L*G) u16,
           counts (NG, L) i32, hi (NG, G) u32, lo (NG, G) u32)
    decode(stream (n_dev, S) u16, offsets (NG,) i32, hi, lo, cum)
      -> (NG, L, G) symbols

    ``words`` (kernels.rans_encode.symbol_words) and ``cum``
    (rans_codec.decode_tables) are the kernels' tables: one row,
    replicated, or one row per group, sharded with the groups.  Decode's
    ``stream`` row ``d`` holds the region sections of device ``d``'s
    groups and ``offsets`` are row-local (rans_codec._stage_stream with
    ``n_rows = n_dev``).  ``NG`` must be a multiple of the mesh size.
    """
    from .. import rans, rans_codec
    from ..kernels.backend import interpret_kernels
    from ..kernels.rans_decode import rans_decode

    g = group_lanes or rans.GROUP_LANES
    interp = interpret_kernels(mesh.devices.flat[0].platform)
    # per-group (adaptive) tables ride the group axis with their groups;
    # a shared table is replicated
    t_spec = P(AXIS) if per_group_tables else P()
    out_dtype = rans_codec._narrow_dtype(a_count)

    def enc_local(rows, words):
        return rans_codec._encode_device(rows, words, group_lanes=g,
                                         interpret=interp)

    # check_vma=False: pallas_call out_shapes carry no varying-mesh-axis
    # metadata, and the kernels touch no collectives anyway
    enc = jax.jit(jax.shard_map(
        enc_local, mesh=mesh,
        in_specs=(P(AXIS), t_spec),
        out_specs=(P(AXIS),) * 4,
        check_vma=False,
    ))

    def dec_local(stream, offsets, hi, lo, cum):
        return rans_decode(
            stream.reshape(-1), offsets, hi, lo, cum,
            n_steps=block_len, a_count=a_count, out_dtype=out_dtype,
            interpret=interp)

    dec = jax.jit(jax.shard_map(
        dec_local, mesh=mesh,
        in_specs=(P(AXIS),) * 4 + (t_spec,),
        out_specs=P(AXIS),
        check_vma=False,
    ))
    return enc, dec
