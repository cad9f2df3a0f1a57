"""range_coder_rust_tpu — a GPU lossless entropy-coding framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the Rust crate
``diegodox/range_coder_rust``: a carryless, 64-bit, model-agnostic range
coder (reference README.md:4-6).  The reference's 5-name public surface
(``RangeCoder``, ``Encoder``, ``Decoder``, ``PModel``, ``error`` —
reference src/lib.rs:1-13) is reproduced here as the scalar streaming API,
and the framework adds the device data plane on top:

* :mod:`~range_coder_rust_tpu.ops` — u32-limb u64 arithmetic, the
  closed-form per-symbol transition (clz-based renormalization), exact
  multiply-shift division;
* :mod:`~range_coder_rust_tpu.models` — array-native frequency tables
  (histogram + exclusive scan), per-block adaptive tables, normalization;
* :mod:`~range_coder_rust_tpu.blocks` — block-parallel batch encode/decode
  under ``jit`` (vmap over blocks, scan over symbols);
* :mod:`~range_coder_rust_tpu.kernels` — Pallas TPU kernels for the hot path;
* :mod:`~range_coder_rust_tpu.format` — the container format (the reference
  has none: framing/length/tables are the caller's job there,
  examples/sample_impl.rs:113-120);
* :mod:`~range_coder_rust_tpu.parallel` — multi-chip/multi-host scaling via
  ``jax.sharding.Mesh`` + ``shard_map``.
"""

from . import errors
from .core.decoder import Decoder
from .core.encoder import Encoder
from .core.rc64 import MASK64, MAX_BYTES_PER_SYMBOL, TOP8, TOP16, RangeCoder
from .models.freq_table import FreqTable
from .pmodel import PModel

__version__ = "0.1.0"

__all__ = [
    "RangeCoder",
    "Encoder",
    "Decoder",
    "PModel",
    "FreqTable",
    "errors",
    "MASK64",
    "TOP8",
    "TOP16",
    "MAX_BYTES_PER_SYMBOL",
    "__version__",
]
