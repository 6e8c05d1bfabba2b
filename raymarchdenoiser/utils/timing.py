"""Timing / profiling / metrics utilities.

Equivalents of the reference's observability (SURVEY.md §5):

* per-test wall-clock (``src/test.cu:33-38``)      -> :class:`Timer`, :func:`time_fn`
* ``printGPUProperties`` (``src/utils.cpp:5-16``)  -> :func:`print_device_properties`
* ``build/out.csv`` dumps (tile.ipynb cell 199)    -> :class:`CsvDump`
* cuda-gdb / nvprof                                -> :func:`trace` (jax.profiler)
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable

import jax


class Timer:
    """Wall-clock timer that syncs outstanding device work on exit.

    Dispatch under jax is async: without a sync the timer would measure
    enqueue time, not compute.  On ``__exit__`` the timer blocks on the
    result registered via :meth:`sync`, or — if none was registered — on all
    live jax arrays (which transitively covers any in-flight computation).
    """

    def __init__(self):
        self.ms = 0.0
        self._out = None

    def sync(self, out):
        """Register the computation result to block on at exit; returns it."""
        self._out = out
        return out

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            if self._out is not None:
                jax.block_until_ready(self._out)
            else:
                jax.block_until_ready(jax.live_arrays())
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def time_fn(fn: Callable, *args, repeats: int = 10, warmup: int = 1, **kw):
    """Median-free simple timing: mean seconds/call after warmup, synced."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats, out


def mpix_per_s(height: int, width: int, seconds: float) -> float:
    return height * width / seconds / 1e6


def print_device_properties() -> dict:
    """Device introspection (reference printGPUProperties parity)."""
    info = []
    for d in jax.devices():
        entry = {
            "id": d.id,
            "platform": d.platform,
            "kind": getattr(d, "device_kind", "?"),
        }
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except Exception:
            pass
        if "bytes_limit" in stats:
            entry["hbm_bytes"] = stats["bytes_limit"]
        info.append(entry)
        print(f"device {entry['id']}: {entry['kind']} ({entry['platform']})"
              + (f", HBM {entry.get('hbm_bytes', 0) / 2**30:.1f} GiB"
                 if "hbm_bytes" in entry else ""))
    return {"devices": info}


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/rdt_trace"):
    """jax.profiler trace context (view with xprof/perfetto/tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class CsvDump:
    """Pipe-separated benchmark dump (the notebook's build/out.csv format)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def row(self, label: str, ms: float, **extra):
        with open(self.path, "a") as f:
            cells = [label, f"{ms:.4f}"] + [f"{k}={v}" for k, v in extra.items()]
            f.write("|".join(cells) + "\n")


def write_metrics_json(path: str, metrics: dict) -> None:
    """Structured metrics output (SURVEY.md §5 metrics row)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True)
