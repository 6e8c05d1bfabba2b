"""Where the program runs: the route choice and the compile cache, in one place.

The only kernel this package writes by hand is the sphere-tracing march
(``ops/pallas/march_triton.py``, Pallas through Triton).  It runs compiled on
an NVIDIA GPU; everywhere else the march is the plain jnp loop of
``ops/raymarch.py``.  Every other stage is plain jnp code that XLA compiles
for whichever device it runs on.  Interpret mode is never chosen here: only
a test that passes ``interpret=True`` to a kernel wrapper runs it.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def march_route(platform: Optional[str] = None) -> str:
    """``"triton"`` on a GPU, ``"jnp"`` on the CPU; any other platform is an
    error (there is no silent fallback that hides which device ran)."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "jnp"
    raise RuntimeError(
        f"no march route for platform {platform!r}: this package runs on an "
        f"NVIDIA GPU ('gpu') or, for tests, on the CPU ('cpu')")


def compile_cache_dir(subdir: Optional[str] = None) -> str:
    """The persistent compile cache directory.

    ``$JAX_COMPILATION_CACHE_DIR`` when it is set (used as it is);
    otherwise the fixed ``.jax_cache/`` of the checkout, optionally with a
    ``subdir`` (the CPU test suite keys one by the host's CPU features)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    return os.path.join(path, subdir) if subdir else path


def enable_compile_cache(subdir: Optional[str] = None) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    and cache every compiled program that took a second or more."""
    path = compile_cache_dir(subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
