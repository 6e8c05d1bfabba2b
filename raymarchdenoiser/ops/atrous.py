"""Edge-aware à-trous wavelet filter (SVGF spatial pass) — jnp oracle + public op.

This completes what the reference only *declares*: the ``WAVELET`` filter type
(``include/filter.cuh:12``), the ``sigma*`` edge-stopping parameters
(``filter.cuh:16-19``), the unused B3-spline ``__constant__ waveletSpline``
(``src/filter.cu:10``), and the à-trous dilation model ``space(n)=2^(n-1)``
from ``notebooks/tile.ipynb`` (here: spacing ``2^level`` with 5 levels, the
standard SVGF convention).

Math (SVGF, Schied et al. 2017):

* per-tap kernel ``h(d) = spline[dy]·spline[dx]`` dilated by ``s = 2^level``;
* edge weights ``w = w_z · w_n · w_l`` with
  ``w_z = exp(-|z_p − z_q| / (σ_z·|∇z_p·(p−q)| + ε))``,
  ``w_n = max(0, n_p·n_q)^σ_n``,
  ``w_l = exp(-|l_p − l_q| / (σ_l·sqrt(blur3x3(var)_p) + ε))``;
* color: ``c'_p = Σ_q h·w·c_q / Σ_q h·w``;
* variance: ``v'_p = Σ_q (h·w)²·v_q / (Σ_q h·w)²``.

Out-of-image taps are dropped (zero weight), matching the reference's
``inRange`` guard (``src/filter.cu:37-38``).

Gradient policy: with ``detach_weights=True`` (default) the edge weights are
computed under ``stop_gradient`` so the op is a linear combination of its
color/variance inputs with data-independent-for-AD weights — the mode the
pipeline trains with.  With ``detach_weights=False`` full autodiff through the
weights is available.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import SVGFParams, WAVELET_SPLINE_5
from ..gbuffer import luminance
from .common import shift2d, valid_mask, finite_diff_gradients


_EPS = 1e-8


def _spline_taps(radius: int) -> Tuple[float, ...]:
    """1-D kernel half-profile -> full profile. B3 spline for r=2, binomial else."""
    if radius == 2:
        return WAVELET_SPLINE_5
    if radius == 0:
        return (1.0,)
    # binomial approximation of a gaussian for other radii
    import math

    n = 2 * radius
    taps = [math.comb(n, k) for k in range(n + 1)]
    s = float(sum(taps))
    return tuple(t / s for t in taps)


def variance_blur3x3(variance: jax.Array) -> jax.Array:
    """3x3 gaussian pre-blur of the variance plane (SVGF driving σ_l).

    Border taps dropped and renormalized.
    """
    H, W = variance.shape
    k1 = (0.25, 0.5, 0.25)
    num = jnp.zeros_like(variance)
    den = jnp.zeros_like(variance)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = k1[dy + 1] * k1[dx + 1]
            m = valid_mask(H, W, dy, dx, variance.dtype)
            num = num + k * m * shift2d(variance, dy, dx)
            den = den + k * m
    return num / den


@functools.partial(jax.jit, static_argnames=("level", "params", "detach_weights"))
def atrous_level_ref(
    color: jax.Array,      # (3, H, W)
    variance: jax.Array,   # (H, W)
    normal: jax.Array,     # (3, H, W)
    depth: jax.Array,      # (H, W)
    zgrad: Optional[jax.Array] = None,  # (2, H, W); computed if None
    *,
    level: int = 0,
    params: SVGFParams = SVGFParams(),
    detach_weights: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """One à-trous level (jnp oracle). Returns (filtered color, filtered variance)."""
    H, W = depth.shape
    spacing = 1 << level
    r = params.radius
    taps1d = _spline_taps(r)
    if zgrad is None:
        zgrad = finite_diff_gradients(depth)

    lum = luminance(color)
    if detach_weights:
        lum_w = jax.lax.stop_gradient(lum)
        var_w = jax.lax.stop_gradient(variance)
    else:
        lum_w, var_w = lum, variance

    sigma_l_denom = params.sigma_color * jnp.sqrt(
        jnp.maximum(variance_blur3x3(var_w), 0.0)
    ) + _EPS

    num_c = jnp.zeros_like(color)
    num_v = jnp.zeros_like(variance)
    den = jnp.zeros_like(variance)

    luma_only = (params.luma_only_from is not None
                 and level >= params.luma_only_from)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * spacing, dx * spacing
            h = taps1d[dy + r] * taps1d[dx + r]
            m = valid_mask(H, W, oy, ox, depth.dtype)

            l_q = shift2d(lum_w, oy, ox)
            # luminance
            wl_exp = -jnp.abs(lum_w - l_q) / sigma_l_denom
            if luma_only:
                # cheaper-filter mode: deep dilated levels drop the
                # depth/normal terms (quality-gated, see SVGFParams)
                w = h * m * jnp.exp(wl_exp)
            else:
                z_q = shift2d(depth, oy, ox)
                n_q = shift2d(normal, oy, ox)
                # depth: |∇z·(p−q)| along the (dilated) offset
                dz_denom = params.sigma_depth * jnp.abs(
                    zgrad[0] * oy + zgrad[1] * ox) + _EPS
                wz_exp = -jnp.abs(depth - z_q) / dz_denom
                # normal
                ndot = jnp.maximum(jnp.sum(normal * n_q, axis=0), 0.0)
                wn = jnp.power(jnp.maximum(ndot, 1e-20), params.sigma_normal)
                w = h * m * jnp.exp(wz_exp + wl_exp) * wn
            if detach_weights:
                w = jax.lax.stop_gradient(w)

            num_c = num_c + w[None] * shift2d(color, oy, ox)
            num_v = num_v + (w * w) * shift2d(variance, oy, ox)
            den = den + w

    den = jnp.maximum(den, _EPS)
    return num_c / den[None], num_v / (den * den)


@functools.partial(
    jax.jit, static_argnames=("params", "detach_weights", "return_feedback")
)
def svgf_spatial_ref(
    color: jax.Array,
    variance: jax.Array,
    normal: jax.Array,
    depth: jax.Array,
    *,
    params: SVGFParams = SVGFParams(),
    detach_weights: bool = True,
    return_feedback: bool = False,
):
    """Full multi-level à-trous sweep (jnp oracle).

    Returns denoised color, and if ``return_feedback`` also the intermediate
    color after ``params.feedback_level`` iterations — SVGF feeds *that* into
    the next frame's temporal history rather than the fully filtered image.
    """
    zgrad = finite_diff_gradients(depth)
    c, v = color, variance
    feedback = color
    pf = params.pyramid_from
    n_full = params.iterations if pf is None else min(pf, params.iterations)
    for lvl in range(n_full):
        c, v = atrous_level_ref(
            c, v, normal, depth, zgrad,
            level=lvl, params=params, detach_weights=detach_weights,
        )
        if lvl + 1 == params.feedback_level:
            feedback = c
    if pf is not None and pf < params.iterations:
        if params.feedback_level > pf:
            raise ValueError("pyramid_from requires feedback_level <= "
                             "pyramid_from (the feedback plane must be a "
                             "full-resolution level)")
        c, v = _pyramid_deep_levels(c, v, normal, depth, params,
                                    detach_weights)
    if return_feedback:
        return c, v, feedback
    return c, v


def _down2(x: jax.Array) -> jax.Array:
    """2x2-mean downsample with edge-replicate padding for odd extents."""
    H, W = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [(0, H % 2), (0, W % 2)]
    if H % 2 or W % 2:
        x = jnp.pad(x, pad, mode="edge")
    Hp, Wp = x.shape[-2:]
    x = x.reshape(x.shape[:-2] + (Hp // 2, 2, Wp // 2, 2))
    return x.mean(axis=(-3, -1))


def _up2(x: jax.Array, H: int, W: int) -> jax.Array:
    """Bilinear 2x upsample (half-pixel-center phase, matching _down2)."""
    return jax.image.resize(x, x.shape[:-2] + (2 * x.shape[-2],
                                               2 * x.shape[-1]),
                            method="bilinear")[..., :H, :W]


def _pyramid_deep_levels(c, v, normal, depth, params, detach_weights):
    """Half-resolution deep à-trous levels (SVGFParams.pyramid_from): the
    levels >= pyramid_from run on 2x2-mean downsampled planes with the
    level index shifted by one (same world-space footprint at half the
    pixels), and the coarse-scale CHANGE is bilinear-upsampled and added
    back — full-resolution detail from the fine levels is preserved, only
    the deep smoothing delta moves through the pyramid.  Experimental:
    footprint-growth motivation in the reference's tile model
    (notebooks/tile.ipynb cells 197-200)."""
    H, W = depth.shape
    cd, vd = _down2(c), _down2(v)
    nd = _down2(normal)
    nd = nd / jnp.maximum(jnp.linalg.norm(nd, axis=0, keepdims=True), 1e-8)
    zd = _down2(depth)
    zgd = finite_diff_gradients(zd)
    c2, v2 = cd, vd
    for lvl in range(params.pyramid_from, params.iterations):
        c2, v2 = atrous_level_ref(
            c2, v2, nd, zd, zgd,
            level=lvl - 1, params=params, detach_weights=detach_weights,
        )
    c_out = c + _up2(c2 - cd, H, W)
    v_out = jnp.maximum(v + _up2(v2 - vd, H, W), 0.0)
    return c_out, v_out
