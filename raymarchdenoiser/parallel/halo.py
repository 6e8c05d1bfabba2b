"""Halo exchange for spatially sharded image tiles (use inside shard_map).

The inter-device analogue of the reference's cooperative shared-memory halo
load (``cacheTile``, src/filter.cu:66-84): where a CUDA block re-reads its
halo from global memory, mesh neighbors exchange boundary strips with
``jax.lax.ppermute`` (NCCL send/recv between GPUs, over NVLink on one
host).  Non-existent neighbors (image border) contribute zeros — exactly the
reference's dropped-tap ``inRange`` semantics (src/filter.cu:37-38), so
border normalization stays correct.

À-trous levels dilate the footprint (spacing 2^level), so the exchanged halo
width is ``radius * 2^level`` — the "footprint grows with depth" problem the
notebook models for shared memory (tile.ipynb cells 197-200) moved to the
mesh (SURVEY.md §5 long-context row).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def _axis_shift_perm(axis_name: str, shift: int):
    """ppermute permutation sending shard i -> i+shift along the axis ring
    (non-cyclic: edge shards receive zeros)."""
    n = lax.axis_size(axis_name)
    return [(i, i + shift) for i in range(n) if 0 <= i + shift < n]


def _exchange_axis(x: jax.Array, halo: int, axis_name: str, spatial_axis: int) -> jax.Array:
    """Pad the local tile with ``halo`` elements from the neighbors along one
    spatial axis.  Zero-filled at the global image border (edge shards).

    Supports ``halo`` larger than the local extent via multi-hop ppermutes
    (hop k fetches the k-away neighbor's adjacent chunk) — needed when a deep
    à-trous level's dilated footprint exceeds the per-device tile.
    """
    if halo == 0:
        return x
    if lax.axis_size(axis_name) == 1:
        # single-shard axis: both neighbors are the global border, so the
        # exchanged halo is all zeros — a plain zero-pad, no degenerate
        # self-permutes or concat copies
        pad = [(0, 0)] * x.ndim
        pad[spatial_axis] = (halo, halo)
        return jnp.pad(x, pad)
    L = x.shape[spatial_axis]

    def tail(v, n):  # last n elements along spatial_axis
        idx = [slice(None)] * v.ndim
        idx[spatial_axis] = slice(L - n, L)
        return v[tuple(idx)]

    def head(v, n):
        idx = [slice(None)] * v.ndim
        idx[spatial_axis] = slice(0, n)
        return v[tuple(idx)]

    before, after = [], []
    remaining, k = halo, 1
    while remaining > 0:
        take = min(L, remaining)
        from_before = lax.ppermute(x, axis_name, _axis_shift_perm(axis_name, k))
        from_after = lax.ppermute(x, axis_name, _axis_shift_perm(axis_name, -k))
        before.insert(0, tail(from_before, take))  # farthest chunk first
        after.append(head(from_after, take))
        remaining -= take
        k += 1
    return jnp.concatenate(before + [x] + after, axis=spatial_axis)


def exchange_rows(x: jax.Array, halo: int, axis_name: str = "y") -> jax.Array:
    """Pad local tile with ``halo`` rows from the y-neighbors -> (..., H+2h, W)."""
    return _exchange_axis(x, halo, axis_name, x.ndim - 2)


def exchange_cols(x: jax.Array, halo: int, axis_name: str = "x") -> jax.Array:
    """Pad local tile with ``halo`` cols from the x-neighbors -> (..., H, W+2h)."""
    return _exchange_axis(x, halo, axis_name, x.ndim - 1)


def exchange_halo2d(
    x: jax.Array, halo: int, axes: Tuple[str, str] = ("y", "x")
) -> jax.Array:
    """Full 2-D halo (rows, then cols including corners) -> (..., H+2h, W+2h)."""
    return exchange_cols(exchange_rows(x, halo, axes[0]), halo, axes[1])


def tile_origin(local_shape: Tuple[int, int],
                axes: Tuple[str, str] = ("y", "x")) -> Tuple[jax.Array, jax.Array]:
    """Global (row0, col0) of this device's tile (traced scalars)."""
    ry = lax.axis_index(axes[0]) * local_shape[0]
    cx = lax.axis_index(axes[1]) * local_shape[1]
    return ry, cx
