"""Test configuration: force CPU with 8 virtual devices BEFORE jax imports.

Distributed tests (SURVEY.md section 4.3) run against a virtual 8-device CPU
mesh, and the Pallas kernels run in the interpreter (ops/route.py). Tests
marked ``gpu`` need the card: their ``gpu_device`` fixture skips them on
the CPU. ``python chip_smoke.py`` runs them on the GPU in-process: JAX is
already imported (and on the GPU) there, so this file leaves the backend
alone.

THE SUPPORTED FULL-SUITE COMMAND IS

    python tests/run_suite.py

(fresh interpreter per test file, 2 parallel workers). A monolithic
single-process `pytest tests/` run intermittently crashed the XLA CPU
compiler in past rounds (aborts/segfaults at varying tests — giant
differentiated-scan programs pushing compiler recursion); two
mitigations are now in place: per-file process isolation (run_suite.py,
the contract) and jax.checkpoint rematerialization on the AD scan body
(integrator/wavefront.path_trace_fixed), which shrinks the transposed
program by O(bounces). The stack-limit lift below remains as
belt-and-braces for single-file runs.
"""

import os
import resource
import sys

# XLA's CPU backend compiles on the calling thread and recurses deeply on
# large linearized-scan programs (the differentiated 32-bounce wavefront);
# under the default 8 MB stack the compiler intermittently segfaulted
# ~65% into the suite (observed 3x: faulthandler dump inside
# backend_compile_and_load during test_nan_audit / test_parity; round 2:
# twice more in the megakernel guided/grad compiles WITH a 512 MB soft
# limit). The hard limit is unlimited in this image — lift the soft limit
# all the way so the main thread's stack can grow as far as the compiler
# recurses (the box has 125 GB; an unbounded main-thread stack is safe).
_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _soft != _hard:
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))

# A process that imported JAX before pytest (chip_smoke.py on the card)
# keeps its backend; otherwise the tests run on the CPU.
_ON_GPU = "jax" in sys.modules
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: OPT-IN via SPT_TEST_COMPILE_CACHE=<dir>.
# It makes re-runs much faster (pallas interpret-mode kernels and
# scan-transpose adjoints dominate suite time), but the cache WRITE path
# (compilation_cache.put_executable_and_time serializing a huge CPU
# executable) segfaulted the interpreter once this round — an
# intermittent crash in a fresh-cache run is worse than a slower suite,
# so default off and enable it only for local iteration.
# The CLI enables the repo cache (utils/compile_cache.py) when the tests
# call it in-process; jax_enable_compilation_cache keeps that off too.
_cache_dir = os.environ.get("SPT_TEST_COMPILE_CACHE", "")
if _cache_dir:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
elif not _ON_GPU:
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cornell_box():
    from small_pathtracer_tpu.scene.presets import get_scene

    return get_scene("cornell_box")


@pytest.fixture(scope="session")
def camera():
    from small_pathtracer_tpu.camera.pinhole import make_camera

    return make_camera()


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, so every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return dev
