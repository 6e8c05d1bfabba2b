"""Pytest config: run the suite hermetically on a virtual 8-device CPU mesh.

Multi-device sharding tests use 8 virtual CPU devices (SURVEY.md §4's
implication row).  Tests marked ``gpu`` need the compiled Triton kernels:
they skip on the CPU, and run on a machine with an NVIDIA GPU with

    RDT_TEST_GPU=1 python -m pytest -m gpu tests/

(``chip_smoke.py`` runs the same checks in its last phase).
"""

import hashlib
import os

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raymarchdenoiser.backend import enable_compile_cache

ON_GPU = os.environ.get("RDT_TEST_GPU") == "1"
if not ON_GPU:
    # config.update after import (before backend init) wins over any
    # platform preset in the environment
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: the unrolled stencil graphs are compile-heavy;
# cache across pytest processes so only the first run pays.  The CPU suite
# keys its subdirectory by the host's CPU feature set: XLA:CPU executables
# are feature-specific, and loading one produced on a different machine can
# crash the process.
if ON_GPU:
    enable_compile_cache()
else:
    try:
        _flags = [l for l in open("/proc/cpuinfo") if l.startswith("flags")][0]
    except Exception:
        _flags = "unknown"
    enable_compile_cache(
        "cpu_" + hashlib.sha1(_flags.encode()).hexdigest()[:10])


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's default backend is a GPU
    (decided here, at run time, never while modules are imported)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernels); run "
                    "RDT_TEST_GPU=1 python -m pytest -m gpu tests/ on the card")


@pytest.fixture(scope="session")
def cornell_frame(tmp_path_factory):
    """The 500×500 Cornell G-buffer fixture (the reference dataset's shape
    and ``render/<scene>/<frame>/`` PNG layout), rendered by the package's
    own raymarcher and loaded back from disk."""
    from raymarchdenoiser.io.dataset import load_frame
    from raymarchdenoiser.io.generate import write_cornell_fixture

    root = str(tmp_path_factory.mktemp("render"))
    write_cornell_fixture(root)
    return load_frame(root, "cornell", 1)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
