"""Multi-host initialization (SURVEY.md §5 distributed-backend row).

The reference is single-process/single-GPU; scaling here goes through
``jax.distributed`` for several hosts: each host calls :func:`initialize`
before any jax computation, then builds the global ('data','y','x') mesh
over *all* devices with ``parallel.mesh.make_mesh`` — `shard_map` +
ppermute halos then run over NCCL (NVLink within a host, the network
across hosts).

Ordering contract: :func:`initialize` must run before anything touches the
XLA backend (``jax.devices()``, ``jax.process_count()``, any computation).
It therefore never calls backend-initializing APIs itself — the
already-initialized check reads ``jax.distributed``'s client state directly.
A subprocess test (tests/test_parallel_units.py) asserts this ordering.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def _distributed_client_active() -> bool:
    """Whether jax.distributed.initialize already ran in this process.

    Reads the distributed global state directly — unlike
    ``jax.process_count()``, this does NOT initialize the XLA backend (after
    which a later ``jax.distributed.initialize`` would raise).
    """
    try:
        from jax._src.distributed import global_state
        return global_state.client is not None
    except ImportError:  # pragma: no cover - future jax refactor
        return False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or the standard env vars.

    On a cluster whose scheduler JAX recognizes,
    ``jax.distributed.initialize()`` autodetects; explicit args cover manual
    bring-up (a single GPU host needs them):
      COORDINATOR_ADDRESS host:port, NUM_PROCESSES, PROCESS_ID.
    Must be called before any jax computation or device query.  Idempotent:
    a second call in an initialized process is a no-op.

    Raises whatever ``jax.distributed.initialize`` raises when explicit
    coordinator configuration (args or env) is present — misconfigured pods
    must fail loudly, not degrade to single-process.  Without any
    configuration, a failed autodetect falls back to single-process (the
    dev-machine path) and the error is re-raised only if the environment
    names a coordinator.
    """
    if _distributed_client_active():
        return  # already initialized
    kw = {}
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        kw["coordinator_address"] = addr
    n = num_processes or os.environ.get("NUM_PROCESSES")
    if n:
        kw["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get("PROCESS_ID")
    if pid is not None:
        kw["process_id"] = int(pid)
    if kw:
        # explicit configuration: errors propagate
        jax.distributed.initialize(**kw)
        return
    try:
        jax.distributed.initialize()
    except Exception:
        # no coordinator configured anywhere: single-process dev environment
        pass


def runtime_info() -> dict:
    """Process/device topology summary for logs and failure triage."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }
