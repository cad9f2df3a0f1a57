"""Pallas kernels for the rans16 profile (Triton route).

The rans16 profile (rans.py) interleaves ``G`` lanes per group into one
halfword stream in decode order, so each direction is one serial loop over
steps with every lane of the group advancing together.  Each kernel runs
one program per group: the group's lanes are the block vector, the state
stays in registers, and the emitting/refilling lanes find their stream
positions by a prefix sum over the block.

Modules: backend.py (the one place that picks compiled vs interpret
mode), rans_encode.py / rans_decode.py (the kernels).
"""

from .backend import interpret_kernels

__all__ = ["interpret_kernels"]
