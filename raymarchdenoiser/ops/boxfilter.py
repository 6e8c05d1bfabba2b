"""Iterated box (average) filter — reference-parity and fast-float modes.

This is the JAX realization of the only compute the reference actually ships:
``filterKernelBaseline`` (``src/filter.cu:13-58``) and ``filterKernelTiled``
(``src/filter.cu:60-158``): a ``depth``-level iterated (2r+1)^2 uniform
average over uint8 RGB with border clamping via dropped taps.

Two modes:

* :func:`box_filter_u8` — **bit-exact** reproduction of the reference
  semantics on uint8, including the float accumulate / truncating
  ``(unsigned char)`` cast per level, and (optionally) the baseline kernel's
  grayscale quirk of writing ``acum.x`` into all three channels
  (``src/filter.cu:50-53``).  Used for golden parity tests.
* :func:`box_filter` — float planar fast path using a separable running-sum
  formulation; this is what production code should call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .common import shift2d, valid_mask, tap_offsets


@functools.partial(jax.jit, static_argnames=("radius", "depth", "grayscale_quirk"))
def box_filter_u8(
    img: jax.Array, radius: int = 2, depth: int = 1, grayscale_quirk: bool = False
) -> jax.Array:
    """Reference-exact iterated average filter on interleaved uint8 (H, W, 3).

    ``grayscale_quirk=True`` matches ``filterKernelBaseline`` (writes the
    averaged *red* channel into x/y/z, ``src/filter.cu:50-53``); ``False``
    matches ``filterKernelTiled`` (``src/filter.cu:151-155``).  Quantization
    to uint8 happens after *every* level, like the reference's per-level
    ``uchar4`` store into the ping-pong buffers (``src/filter.cu:24-25``).
    """
    H, W, C = img.shape
    offs = tap_offsets(radius)
    norm = sum(valid_mask(H, W, dy, dx) for dy, dx in offs)

    def level(_, x_u8):
        x = x_u8.astype(jnp.float32)  # planar (C, H, W)
        acc = jnp.zeros_like(x)
        for dy, dx in offs:
            acc = acc + shift2d(x, dy, dx)
        out = acc / norm
        out_u8 = out.astype(jnp.uint8)  # C-style truncating cast (values >= 0)
        if grayscale_quirk:
            out_u8 = jnp.broadcast_to(out_u8[:1], out_u8.shape)
        return out_u8

    planar = jnp.transpose(img, (2, 0, 1))
    out = jax.lax.fori_loop(0, depth, level, planar)
    return jnp.transpose(out, (1, 2, 0))


@functools.partial(jax.jit, static_argnames=("radius", "depth"))
def box_filter(x: jax.Array, radius: int = 2, depth: int = 1) -> jax.Array:
    """Float iterated box average on planar (..., H, W), separable formulation.

    Border policy matches the reference (average over in-range taps only):
    numerator and per-pixel tap count are both filtered separably, then
    divided once.  O(r) work per pixel instead of O(r^2).
    """
    H, W = x.shape[-2], x.shape[-1]
    ones = jnp.ones((H, W), x.dtype)

    def sep_sum(v, axis_is_y: bool):
        acc = v
        for d in range(1, radius + 1):
            if axis_is_y:
                acc = acc + shift2d(v, d, 0) + shift2d(v, -d, 0)
            else:
                acc = acc + shift2d(v, 0, d) + shift2d(v, 0, -d)
        return acc

    count = sep_sum(sep_sum(ones, True), False)

    def level(_, v):
        num = sep_sum(sep_sum(v, True), False)
        return num / count

    return jax.lax.fori_loop(0, depth, level, x)
