"""Test configuration: run JAX on a local virtual 8-device CPU mesh.

Tests exercise the distributed code paths without an accelerator by
running the CPU platform with 8 virtual devices.  float64 is enabled so
numerical parity tests against scipy/sklearn can compare at tight
tolerances; library code is dtype-explicit, so this does not change the
device execution path.

Tests marked ``gpu`` need a card and skip elsewhere; run them on a
machine with one as ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(``JAX_PLATFORMS`` picks the platform; it defaults to the CPU).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from muscle_synergies_tpu.utils.platform import enable_compile_cache  # noqa: E402

jax.config.update(
    "jax_platforms", os.environ.get("JAX_PLATFORMS", "").strip() or "cpu"
)
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: repeated test runs skip XLA compiles.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Free compiled executables between test modules.

    Every live XLA:CPU executable holds mmap'd JIT code sections; the
    full suite compiles enough distinct programs that the process
    crosses ``vm.max_map_count`` (~65k mappings) late in the run, at
    which point LLVM's section allocator mmap fails and the compiler
    SIGSEGVs (observed at ~96% of the suite, in whatever test compiles
    next).  Dropping the jit caches per module bounds the live count;
    the persistent disk cache above makes any cross-module recompiles
    cheap reloads.
    """
    yield
    jax.clear_caches()


def pytest_report_header():
    return f"jax devices: {jax.device_count()} x {jax.devices()[0].platform}"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (full-scale geometry, multi-process "
        "rendezvous); always part of the suite, marked for selection",
    )
    config.addinivalue_line(
        "markers",
        "gpu: compiles for and runs on a GPU; skips without one (see the "
        "module docstring for the command)",
    )
