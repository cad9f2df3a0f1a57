"""Root conftest: run the tests on a virtual 8-device CPU mesh.

The tests use the CPU backend, with the Pallas kernels in interpret mode,
so sharding paths can be exercised without N real cards (SURVEY.md §4).
``JAX_PLATFORMS`` defaults to ``cpu``; set it to ``cuda`` to run the
``gpu``-marked tests on a card.  The platform is also pinned through
``jax.config``, which works even if something imported jax first
(backend initialization is lazy).  XLA_FLAGS is read at CPU client init,
which is where the 8 virtual devices come from.
"""

import os

os.environ.setdefault("RCTPU_TESTS", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
