"""Test-dir conftest: make the package importable from a source checkout.

Backend selection (CPU, 8 virtual devices) happens in the repo-root
conftest.py.  Tests marked ``gpu`` skip unless JAX's platform is a GPU;
the decision is made here, in a fixture, when each test runs — never at
import time, so every pytest-xdist worker collects the same tests.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pytest


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables_between_modules():
    """Free XLA:CPU JIT executables at module boundaries.

    Every distinct program geometry the suite compiles leaves ~350 mmap
    regions behind in the LLVM JIT (measured), and jax caches executables
    for the process lifetime — a many-geometry run (this suite compiles
    hundreds) walks into ``vm.max_map_count`` and the next compile dies
    with "LLVM compilation error: Cannot allocate memory" followed by a
    segfault.  Clearing the caches fully reclaims the maps (2121 -> 547
    measured); cross-module geometry reuse is small, so the recompile
    cost is negligible next to the safety margin.
    """
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests where JAX finds no GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU, JAX's platform is {platform!r}; on the "
                    "card run JAX_PLATFORMS=cuda python -m pytest -m gpu "
                    "tests/")
