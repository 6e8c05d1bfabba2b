"""Temporal reprojection, accumulation and variance estimation (SVGF).

Realizes the reference's declared-but-absent temporal pipeline ("Temporal
accumulation to reduce flickering", reference README.md:8; the per-frame
dataset layout ``render/<scene>/<frame>/`` and the stream-aware
``CudaGBuffer::openImages`` hook at gbuffer.h:32 are its only traces).

Pipeline per frame (Schied et al. 2017):

1. **Reproject**: bilinear-gather history (color, moments, length) at
   ``p + motion`` with per-tap validity (in-bounds + depth + normal
   consistency vs the previous frame's G-buffer).
2. **Accumulate**: EMA blend with ``alpha = max(alpha_min, 1/(N+1))``;
   optional neighborhood clamp of history color against the current frame
   (anti-ghosting).
3. **Moments/variance**: accumulate (E[l], E[l^2]) temporally; fall back to a
   spatial 7x7 moment estimate while history is short
   (``variance_boost_frames``).

Everything is pure jnp (gather-based), hence differentiable: the bilinear
gather's adjoint is the scatter-add XLA generates (SURVEY.md §7 hard part (b)).

Motion convention: ``motion[:, p] = (dy, dx)`` such that the matching pixel in
the *previous* frame is ``p + motion[:, p]`` (i.e. motion points backwards).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SVGFParams
from ..gbuffer import GBuffer, History, luminance
from .common import shift2d, valid_mask


def bilinear_gather_many(planes, ys: jax.Array, xs: jax.Array):
    """Bilinearly sample a list of (..., H, W) planes at float coord grids.

    All planes are stacked channel-minor and fetched with ONE gather per
    bilinear tap (4 total), so each tap reads one contiguous (P,) row.
    Out-of-range taps clamp (validity handled separately by the caller).
    """
    H, W = planes[0].shape[-2:]
    chans = []
    splits = []
    for p in planes:
        lead = int(np.prod(p.shape[:-2])) if p.ndim > 2 else 1
        chans.append(p.reshape(lead, H * W))
        splits.append(lead)
    stacked = jnp.concatenate(chans, axis=0).T  # (H*W, P) channel-minor
    P = stacked.shape[1]

    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)

    def at(yi, xi):
        return stacked[yi * W + xi]  # (H, W, P) via one gather

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x1i) * fx
    bot = at(y1i, x0i) * (1 - fx) + at(y1i, x1i) * fx
    out = top * (1 - fy) + bot * fy  # (H, W, P)

    results = []
    o = 0
    for p, lead in zip(planes, splits):
        part = jnp.moveaxis(out[..., o:o + lead], -1, 0)
        results.append(part.reshape(p.shape[:-2] + ys.shape))
        o += lead
    return results


def bilinear_gather(plane: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """Bilinearly sample one plane (see :func:`bilinear_gather_many`)."""
    return bilinear_gather_many([plane], ys, xs)[0]


def bilinear_shift_sample_many(planes, motion: jax.Array, max_motion: int):
    """Bounded-motion bilinear reprojection via streaming shifts (no gather).

    For |motion| <= M the bilinear sample is exactly

        out[p] = sum_{d in [-M, M+1]^2} tent(m0 - dy) * tent(m1 - dx) * x[p + d]

    with ``tent(t) = max(0, 1 - |t|)`` (only the 2x2 integer offsets
    bracketing the motion get nonzero weight), i.e. (2M+2)^2 statically
    shifted fused multiply-adds — streaming elementwise work, no gather.
    (The bound was chosen for hardware where gathers are slow; it also fixes
    which history counts as disoccluded, ``SVGFParams.max_motion``.)

    Samples with |motion| > M or outside the image read zeros; callers treat
    them as invalid history (same policy as the sharded bounded-motion path).
    Returns (results, within_bounds_mask).
    """
    H, W = planes[0].shape[-2:]
    chans = []
    splits = []
    for p in planes:
        lead = int(np.prod(p.shape[:-2])) if p.ndim > 2 else 1
        chans.append(p.reshape(lead, H, W))
        splits.append(lead)
    stack = jnp.concatenate(chans, axis=0)  # (P, H, W)

    m0, m1 = motion[0], motion[1]
    out = jnp.zeros_like(stack)
    for dy in range(-max_motion, max_motion + 2):
        ty = jnp.maximum(0.0, 1.0 - jnp.abs(m0 - dy))
        for dx in range(-max_motion, max_motion + 2):
            tx = jnp.maximum(0.0, 1.0 - jnp.abs(m1 - dx))
            w = ty * tx
            out = out + w[None] * shift2d(stack, dy, dx)

    within = (jnp.abs(m0) <= max_motion) & (jnp.abs(m1) <= max_motion)
    results = []
    o = 0
    for p, lead in zip(planes, splits):
        results.append(out[o:o + lead].reshape(p.shape))
        o += lead
    return results, within


def _neighborhood_minmax(color: jax.Array, radius: int = 1):
    """Per-pixel min/max of color over a (2r+1)^2 window (for history clamp).

    Separable (min/max commute with the product window): rows then cols,
    2·(2r+1) passes instead of (2r+1)²; out-of-image taps are dropped by
    ±inf substitution per 1-D pass.
    """
    H, W = color.shape[-2], color.shape[-1]

    def one_axis(lo, hi, axis_is_y):
        olo, ohi = lo, hi
        for d in range(-radius, radius + 1):
            if d == 0:
                continue
            dy, dx = (d, 0) if axis_is_y else (0, d)
            m = valid_mask(H, W, dy, dx, color.dtype) > 0
            olo = jnp.minimum(olo, jnp.where(m, shift2d(lo, dy, dx), jnp.inf))
            ohi = jnp.maximum(ohi, jnp.where(m, shift2d(hi, dy, dx), -jnp.inf))
        return olo, ohi

    cmin, cmax = one_axis(color, color, True)
    return one_axis(cmin, cmax, False)


def spatial_moments(lum: jax.Array, radius: int = 3) -> Tuple[jax.Array, jax.Array]:
    """Spatial (E[l], E[l^2]) over a (2r+1)^2 window, border-renormalized.

    Separable: the numerators are plain window sums (zero-fill shifts drop
    out-of-image taps), the valid-tap count factors into an outer product of
    1-D counts — 2·(2·(2r+1)) passes instead of 3·(2r+1)².
    """
    H, W = lum.shape

    def winsum(x):
        rows = x
        for d in range(1, radius + 1):
            rows = rows + shift2d(x, d, 0) + shift2d(x, -d, 0)
        out = rows
        for d in range(1, radius + 1):
            out = out + shift2d(rows, 0, d) + shift2d(rows, 0, -d)
        return out

    iy = jnp.arange(H, dtype=lum.dtype)[:, None]
    ix = jnp.arange(W, dtype=lum.dtype)[None, :]
    cy = jnp.minimum(iy, radius) + jnp.minimum(H - 1 - iy, radius) + 1.0
    cx = jnp.minimum(ix, radius) + jnp.minimum(W - 1 - ix, radius) + 1.0
    inv_cnt = 1.0 / (cy * cx)
    return winsum(lum) * inv_cnt, winsum(lum * lum) * inv_cnt


def _temporal_epilogue(gbuf, gathered, in_bounds, params):
    """Everything after the history reprojection: validity, history clamp,
    EMA accumulation, moments/variance (shared by both reprojection
    paths of :func:`temporal_accumulate`)."""
    color = gbuf.render
    prev_color, prev_moments, prev_len, prev_depth, prev_normal = gathered

    # geometric consistency: relative depth + normal agreement
    depth_ok = jnp.abs(prev_depth - gbuf.depth) <= 0.1 * jnp.maximum(
        jnp.abs(gbuf.depth), 1e-3
    )
    ndot = jnp.sum(prev_normal * gbuf.normal, axis=0)
    normal_ok = ndot > 0.8
    valid = in_bounds & depth_ok & normal_ok & (prev_len > 0)

    if params.history_clamp:
        cmin, cmax = _neighborhood_minmax(color, radius=1)
        prev_color = jnp.clip(prev_color, cmin, cmax)

    n_prev = jnp.where(valid, prev_len, 0.0)
    n_new = n_prev + 1.0
    alpha = jnp.maximum(params.temporal_alpha, 1.0 / n_new)
    alpha_m = jnp.maximum(params.temporal_moments_alpha, 1.0 / n_new)

    integrated = jnp.where(
        valid[None], (1 - alpha)[None] * prev_color + alpha[None] * color, color
    )

    lum = luminance(color)
    cur_moments = jnp.stack([lum, lum * lum])
    moments = jnp.where(
        valid[None],
        (1 - alpha_m)[None] * prev_moments + alpha_m[None] * cur_moments,
        cur_moments,
    )

    var_temporal = jnp.maximum(moments[1] - moments[0] ** 2, 0.0)
    sm1, sm2 = spatial_moments(lum)
    var_spatial = jnp.maximum(sm2 - sm1 * sm1, 0.0)
    use_spatial = n_new < params.variance_boost_frames
    variance = jnp.where(use_spatial, var_spatial, var_temporal)

    new_history = History(
        color=integrated,
        moments=moments,
        length=n_new,
        prev_depth=gbuf.depth,
        prev_normal=gbuf.normal,
    )
    return integrated, variance, new_history


@functools.partial(jax.jit, static_argnames=("params",))
def temporal_accumulate(
    gbuf: GBuffer,
    history: History,
    *,
    params: SVGFParams = SVGFParams(),
) -> Tuple[jax.Array, jax.Array, History]:
    """One temporal step.

    Returns ``(integrated_color, variance, new_history)``; ``new_history`` has
    the integrated color/moments but still needs its ``color`` replaced by the
    à-trous feedback level output (see models/svgf.py).
    """
    H, W = gbuf.shape
    color = gbuf.render
    motion = gbuf.motion if gbuf.motion is not None else jnp.zeros((2, H, W), color.dtype)

    iy = jnp.arange(H, dtype=color.dtype)[:, None] * jnp.ones((1, W), color.dtype)
    ix = jnp.ones((H, 1), color.dtype) * jnp.arange(W, dtype=color.dtype)[None, :]
    ys = iy + motion[0]
    xs = ix + motion[1]

    in_bounds = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)

    hist_planes = [history.color, history.moments, history.length,
                   history.prev_depth, history.prev_normal]
    if params.max_motion is not None:
        gathered, within = bilinear_shift_sample_many(
            hist_planes, motion, params.max_motion)
        in_bounds = in_bounds & within
    else:
        gathered = bilinear_gather_many(hist_planes, ys, xs)

    return _temporal_epilogue(gbuf, gathered, in_bounds, params)
