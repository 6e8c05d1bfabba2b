"""Weak-scaling harness for the sharded SVGF pipeline (BASELINE.md config 5).

Weak scaling: per-device tile size is held constant while devices are added
(the global image grows), so ideal scaling keeps time/step flat.  Efficiency
at N devices = t(1) / t(N).

On several GPUs this measures the halo exchange and gradient psum (NCCL)
against compute; on the virtual CPU mesh it only validates the harness and
the collective layout.

CLI: ``python -m raymarchdenoiser.parallel.scaling --tile 256``
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SVGFParams
from .mesh import make_mesh, factor2
from .sharded import svgf_spatial_sharded


def _inputs(H, W, seed=0):
    rng = np.random.default_rng(seed)
    color = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    variance = jnp.asarray((0.02 * rng.random((H, W))).astype(np.float32))
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = jnp.asarray((0.3 + 0.5 * rng.random((H, W))).astype(np.float32))
    return color, variance, jnp.asarray(n), depth


def time_sharded_step(n_devices: int, tile: int = 256, iterations: int = 5,
                      backward: bool = True, chain: int = 8) -> float:
    """Seconds per fwd(+bwd) SVGF step at ``tile``^2 pixels per device."""
    mesh = make_mesh(n_devices)
    _, gy, gx = mesh.devices.shape
    H, W = tile * gy, tile * gx
    color, variance, normal, depth = _inputs(H, W)
    params = SVGFParams(iterations=iterations)

    def step(c):
        if backward:
            def loss(c):
                oc, ov = svgf_spatial_sharded(c, variance, normal, depth,
                                              mesh=mesh, params=params)
                return jnp.sum(oc ** 2) + jnp.sum(ov)
            return jax.grad(loss)(c)
        oc, _ = svgf_spatial_sharded(c, variance, normal, depth,
                                     mesh=mesh, params=params)
        return oc

    def make_chain(n):
        @jax.jit
        def f(c):
            return jnp.sum(jax.lax.fori_loop(0, n, lambda i, y: step(y), c))
        return f

    lo, hi = make_chain(2), make_chain(2 + chain)
    float(lo(color))
    float(hi(color))
    slopes = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(lo(color))
        t1 = time.perf_counter()
        float(hi(color))
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / chain)
    return sorted(slopes)[1]


def weak_scaling(device_counts: Sequence[int], tile: int = 256,
                 iterations: int = 5, backward: bool = True) -> List[Dict]:
    """Measure each device count; returns rows with efficiency vs the first."""
    rows = []
    t1: Optional[float] = None
    for n in device_counts:
        t = time_sharded_step(n, tile, iterations, backward)
        if t1 is None:
            t1 = t
        mpix = n * tile * tile / t / 1e6
        rows.append({
            "devices": n,
            "mesh": factor2(n),
            "tile": tile,
            "sec_per_step": t,
            "mpix_per_s": mpix,
            "weak_efficiency": t1 / t,
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--cpu", type=int, metavar="N", default=0,
                    help="force an N-device virtual CPU backend")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)

    avail = len(jax.devices())
    counts = args.devices or [n for n in (1, 2, 4, 8, 16) if n <= avail]
    rows = weak_scaling(counts, args.tile, args.iterations,
                        backward=not args.fwd_only)
    on_cpu = jax.devices()[0].platform == "cpu"
    for r in rows:
        if on_cpu:
            # virtual CPU mesh: all "devices" share one host's cores, so
            # efficiency numbers say nothing about a GPU mesh — this run only
            # validates that the sharded program runs at every mesh shape
            r["validates"] = "layout-only"
            r["caveat"] = ("virtual CPU mesh shares one host's cores; "
                           "weak_efficiency does NOT predict GPU scaling")
        print(json.dumps(r))


if __name__ == "__main__":
    main()
