"""The one place that decides how the rans16 kernels run.

The kernels are Pallas kernels for the Triton route (``backend="triton"``):

* on a GPU they are compiled for the card, never interpreted;
* on the CPU they run in Pallas interpret mode — the same kernel program,
  evaluated by XLA:CPU, which is how the test suite checks them;
* on any other platform there is no kernel, and asking for one raises.

Every caller (the codec, the sharded wrappers, the benchmark and the
scripts) resolves the mode here, so no path can fall back to the
interpreter on an accelerator without saying so.
"""

from __future__ import annotations

from typing import Optional

import jax

from ..errors import ConfigError

#: the Pallas route every rans16 kernel names
PALLAS_BACKEND = "triton"


def interpret_kernels(platform: Optional[str] = None) -> bool:
    """True when the kernels must run in interpret mode on ``platform``
    (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise ConfigError(
        f"the rans16 kernels run on 'gpu' (compiled) or 'cpu' (interpret "
        f"mode); platform {platform!r} has no kernel")


def require_gpu() -> jax.Device:
    """The first GPU device, or a ConfigError: measuring paths call this so
    they never report a CPU or interpreter number as a device number."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise ConfigError(
            f"a GPU is required, JAX found platform {dev.platform!r}")
    return dev
