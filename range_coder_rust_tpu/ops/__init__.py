"""Device-side primitive ops: u32-limb u64 arithmetic and the closed-form
per-symbol coder transition.

JAX's integer types are 32-bit (x64 mode stays off); the reference's 64-bit coder state
(reference src/range_coder.rs:7-12) is therefore carried as ``(hi, lo)``
uint32 limb pairs (:mod:`~range_coder_rust_tpu.ops.u64`), and the reference's
two data-dependent renormalization ``while`` loops (src/range_coder.rs:83-89)
are replaced by a *closed-form* transition (:mod:`~range_coder_rust_tpu.ops.transition`)
— count-leading-zero arithmetic instead of loops — so the per-symbol step is
a fixed DAG of vector ops that XLA can fuse and pipeline.
"""

from . import u64
from .transition import (
    CoderState,
    EMIT_MAX,
    decode_find_rfreq,
    flush_state,
    init_state,
    param_update_pow2,
)

__all__ = [
    "u64",
    "CoderState",
    "EMIT_MAX",
    "init_state",
    "param_update_pow2",
    "decode_find_rfreq",
    "flush_state",
]
