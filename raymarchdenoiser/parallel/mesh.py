"""Device-mesh construction for spatial (tile) sharding.

The reference's only parallelism is a single GPU's 2-D thread-block grid over
the image (src/test.cu:70-71).  Here the *image extent* is split across
devices: a ('data', 'y', 'x') mesh where 'y'/'x' shard image rows/cols (the
inter-device version of the CUDA block grid) and 'data' shards frames or
Monte-Carlo samples.  Halo exchange between neighbouring tiles
(parallel/halo.py, ``ppermute``, which XLA lowers to NCCL on GPUs) replaces
the block-local shared-memory halo load (src/filter.cu:70-84).  The mesh
follows the algorithm, not a wiring topology: the GPUs of a host reach each
other all to all over NVLink at one rate.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SPATIAL_AXES = ("y", "x")
AXES = ("data", "y", "x")


def factor2(n: int) -> Tuple[int, int]:
    """Near-square factorization n = a*b with a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    data: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """('data', 'y', 'x') mesh over ``n_devices`` (default: all devices).

    Spatial axes get a near-square factorization of n_devices/data so the
    halo perimeter (bytes exchanged per level) is minimized for a fixed tile
    area.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if n_devices % data:
        raise ValueError(f"n_devices={n_devices} not divisible by data={data}")
    spatial = n_devices // data
    gy, gx = factor2(spatial)
    dev_array = np.asarray(devices).reshape(data, gy, gx)
    return Mesh(dev_array, AXES)


def gbuffer_pspec() -> P:
    """PartitionSpec for planar (C, H, W) planes: shard H on 'y', W on 'x'."""
    return P(None, "y", "x")


def plane_pspec() -> P:
    """PartitionSpec for (H, W) planes."""
    return P("y", "x")


def shard_plane(mesh: Mesh, x: jax.Array) -> jax.Array:
    spec = plane_pspec() if x.ndim == 2 else gbuffer_pspec()
    return jax.device_put(x, NamedSharding(mesh, spec))
