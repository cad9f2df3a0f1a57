"""Multi-card / multi-host scaling: device meshes, sharded codecs, ordered
gather.  The reference has no parallelism at all (SURVEY.md §2: single
thread, in-process VecDeque transport); this package is the framework's
SPMD answer — blocks sharded over a ``jax.sharding.Mesh``, tables
replicated, compressed lengths all-gathered, assembly in block order.
"""

from .dist import (
    block_sharding,
    default_mesh,
    make_sharded_codec,
    make_sharded_rans16,
    replicated,
)
from . import multihost

__all__ = [
    "default_mesh",
    "block_sharding",
    "replicated",
    "make_sharded_codec",
    "make_sharded_rans16",
    "multihost",
]
