"""Unified filter dispatch over ``FilterParams`` — all four reference types.

The reference declares ``FilterType {AVERAGE, GAUSSIAN, CROSS, WAVELET}``
(filter.cuh:12) but hard-codes uniform weights (``w = 1``, filter.cu:41,127);
here every variant is implemented:

* AVERAGE  — iterated box (ops/boxfilter.py)
* GAUSSIAN — separable spatial gaussian (sigma_space), iterated ``depth`` times
* CROSS    — cross-bilateral: spatial gaussian x edge-stopping on the
  albedo / normal / depth guidance planes (sigmas from FilterParams)
* WAVELET  — edge-aware à-trous SVGF sweep (ops/atrous.py)

:func:`apply_filter` is the ``filterKernel*(GBuffer, FilterParams)`` style
entry point (reference include/filter.cuh:25-26) operating on a GBuffer.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import FilterParams, FilterType, SVGFParams
from ..gbuffer import GBuffer
from .common import shift2d, valid_mask
from .boxfilter import box_filter
from .atrous import svgf_spatial_ref, _EPS


def _gauss_taps(radius: int, sigma: float):
    t = [math.exp(-0.5 * (i / max(sigma, 1e-6)) ** 2)
         for i in range(-radius, radius + 1)]
    s = sum(t)
    return tuple(v / s for v in t)


@functools.partial(jax.jit, static_argnames=("radius", "sigma", "depth"))
def gaussian_filter(x: jax.Array, radius: int = 2, sigma: float = 2.0,
                    depth: int = 1) -> jax.Array:
    """Separable spatial gaussian on planar (..., H, W); border-renormalized."""
    H, W = x.shape[-2], x.shape[-1]
    taps = _gauss_taps(radius, sigma)

    def one_axis(v, axis_is_y):
        num = jnp.zeros_like(v)
        den = jnp.zeros_like(v[..., :1, :1]) + jnp.zeros((H, W), v.dtype)
        for i, t in enumerate(taps):
            d = i - radius
            dy, dx = (d, 0) if axis_is_y else (0, d)
            m = valid_mask(H, W, dy, dx, v.dtype)
            num = num + t * m * shift2d(v, dy, dx)
            den = den + t * m
        return num / den

    def level(_, v):
        return one_axis(one_axis(v, True), False)

    return jax.lax.fori_loop(0, depth, level, x)


@functools.partial(jax.jit, static_argnames=("params",))
def cross_bilateral_filter(
    color: jax.Array,           # (3, H, W)
    albedo: jax.Array,          # (3, H, W)
    normal: jax.Array,          # (3, H, W)
    depth: jax.Array,           # (H, W)
    *,
    params: FilterParams = FilterParams(type=FilterType.CROSS),
) -> jax.Array:
    """Cross-bilateral filter guided by the G-buffer (non-dilated footprint).

    Weights: gaussian(spatial; sigma_space) x exp(-|da|^2/2sa^2) x
    (n.n')^sigma_normal x exp(-|dz|/sigma_depth).
    """
    H, W = depth.shape
    r = params.radius
    gt = _gauss_taps(r, params.sigma_space)

    num = jnp.zeros_like(color)
    den = jnp.zeros_like(depth)
    inv_2sa2 = 1.0 / (2.0 * params.sigma_albedo ** 2 + _EPS)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            g = gt[dy + r] * gt[dx + r]
            m = valid_mask(H, W, dy, dx, depth.dtype)
            a_q = shift2d(albedo, dy, dx)
            n_q = shift2d(normal, dy, dx)
            z_q = shift2d(depth, dy, dx)
            da2 = jnp.sum((albedo - a_q) ** 2, axis=0)
            wa = jnp.exp(-da2 * inv_2sa2)
            ndot = jnp.maximum(jnp.sum(normal * n_q, axis=0), 0.0)
            wn = jnp.power(jnp.maximum(ndot, 1e-20), params.sigma_normal)
            wz = jnp.exp(-jnp.abs(depth - z_q) / (params.sigma_depth + _EPS))
            w = g * m * wa * wn * wz
            num = num + w[None] * shift2d(color, dy, dx)
            den = den + w
    return num / jnp.maximum(den, _EPS)[None]


def apply_filter(
    gbuf: GBuffer,
    params: FilterParams,
    variance: Optional[jax.Array] = None,
) -> GBuffer:
    """Filter ``gbuf.render`` per ``params.type`` -> GBuffer with ``denoised``.

    The GBuffer-in / GBuffer-out shape of the reference kernels
    (``filterKernelBaseline(GBuffer, FilterParams)``, filter.cuh:25).
    """
    t = params.type
    if params.level != 0 and t != FilterType.WAVELET:
        raise ValueError(
            f"FilterParams.level={params.level} is only meaningful for "
            f"WAVELET (à-trous dilation); got type={t}")
    if t == FilterType.AVERAGE:
        out = box_filter(gbuf.render, radius=params.radius,
                         depth=params.depth)
    elif t == FilterType.GAUSSIAN:
        out = gaussian_filter(gbuf.render, radius=params.radius,
                              sigma=params.sigma_space, depth=params.depth)
    elif t == FilterType.CROSS:
        out = gbuf.render
        for _ in range(params.depth):
            out = cross_bilateral_filter(out, gbuf.albedo, gbuf.normal,
                                         gbuf.depth, params=params)
    elif t == FilterType.WAVELET:
        sp = SVGFParams(
            iterations=params.depth, radius=params.radius,
            sigma_color=params.sigma_color, sigma_normal=params.sigma_normal,
            sigma_depth=params.sigma_depth,
        )
        var = variance if variance is not None else jnp.ones_like(gbuf.depth)
        if params.level == 0:
            out, _ = svgf_spatial_ref(gbuf.render, var, gbuf.normal,
                                      gbuf.depth, params=sp)
        else:
            # starting level offset (reference FilterParams.level,
            # filter.cuh:14): apply levels [level, level+depth)
            from .atrous import atrous_level_ref
            c, v = gbuf.render, var
            for i in range(params.depth):
                c, v = atrous_level_ref(c, v, gbuf.normal, gbuf.depth,
                                        level=params.level + i, params=sp)
            out = c
    else:  # pragma: no cover
        raise ValueError(f"unknown filter type {t}")
    return gbuf.replace(denoised=out)
