"""Test configuration: run on CPU with a virtual 8-device mesh.

Mirrors the reference CI strategy (.travis.yml: same numerics under OpenMP /
different BLAS backends) — here: same numerics on CPU-jax, single-device vs
sharded over a virtual mesh. Tests marked ``gpu`` need the card: they skip
here and run on a GPU machine with ``TREEQP_TEST_GPU=1 pytest -m gpu``.
"""

import os

ON_GPU = os.environ.get("TREEQP_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REFERENCE_DIR = "/root/reference"


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never while a test module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with TREEQP_TEST_GPU=1 -m gpu on one)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite accumulates hundreds of distinct XLA CPU programs;
    past ~100 modules' worth the CPU client reproducibly crashes inside
    backend_compile (segfault/abort in XLA, not an OOM — RSS stays ~5 GB).
    Dropping the executable caches at module boundaries keeps the compile
    arena bounded; within-module caching (the part that matters for test
    speed) is unaffected."""
    yield
    jax.clear_caches()

