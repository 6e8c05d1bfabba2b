"""The à-trous oracle (ops/atrous.py) against an independent float64 NumPy loop.

``atrous_level_ref`` / ``svgf_spatial_ref`` are the SVGF spatial pass on
every device (XLA compiles them for the GPU).  Here they are checked against
a direct per-tap NumPy transcription of the SVGF formulas in float64, and
their detached-weight gradients against central finite differences of that
loop with the edge weights frozen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser.config import SVGFParams
from raymarchdenoiser.ops.atrous import (_EPS, _spline_taps, atrous_level_ref,
                                         svgf_spatial_ref)
from raymarchdenoiser.ops.common import finite_diff_gradients


def _scene(rng, H=40, W=56):
    color = rng.random((3, H, W), dtype=np.float32)
    variance = (0.02 * rng.random((H, W))).astype(np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.3 + 0.5 * rng.random((H, W))).astype(np.float32)
    return color, variance, n, depth


def _shift(x, oy, ox):
    """y[..., i, j] = x[..., i + oy, j + ox], zero outside, and the mask."""
    H, W = x.shape[-2:]
    out = np.zeros_like(x)
    m = np.zeros((H, W))
    ys = slice(max(-oy, 0), min(H, H - oy))
    xs = slice(max(-ox, 0), min(W, W - ox))
    ysrc = slice(max(oy, 0), min(H, H + oy))
    xsrc = slice(max(ox, 0), min(W, W + ox))
    out[..., ys, xs] = x[..., ysrc, xsrc]
    m[ys, xs] = 1.0
    return out, m


def _lum(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def _blur3(v):
    k = (0.25, 0.5, 0.25)
    num = np.zeros_like(v)
    den = np.zeros_like(v)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s, m = _shift(v, dy, dx)
            num += k[dy + 1] * k[dx + 1] * s
            den += k[dy + 1] * k[dx + 1] * m
    return num / den


def _weights_np(color, var, normal, depth, zgrad, level, params):
    """Per-tap SVGF edge weights ``h·m·w_z·w_n·w_l`` (float64)."""
    s = 1 << level
    r = params.radius
    taps = _spline_taps(r)
    lum = _lum(color)
    sden = params.sigma_color * np.sqrt(np.maximum(_blur3(var), 0.0)) + _EPS
    luma_only = (params.luma_only_from is not None
                 and level >= params.luma_only_from)
    ws = {}
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * s, dx * s
            l_q, m = _shift(lum, oy, ox)
            w = taps[dy + r] * taps[dx + r] * m * np.exp(
                -np.abs(lum - l_q) / sden)
            if not luma_only:
                z_q, _ = _shift(depth, oy, ox)
                n_q, _ = _shift(normal, oy, ox)
                dz = params.sigma_depth * np.abs(
                    zgrad[0] * oy + zgrad[1] * ox) + _EPS
                ndot = np.maximum((normal * n_q).sum(0), 0.0)
                w = w * np.exp(-np.abs(depth - z_q) / dz) * np.power(
                    np.maximum(ndot, 1e-20), params.sigma_normal)
            ws[oy, ox] = w
    return ws


def _apply_np(ws, color, var):
    num_c = np.zeros_like(color)
    num_v = np.zeros_like(var)
    den = np.zeros_like(var)
    for (oy, ox), w in ws.items():
        num_c += w[None] * _shift(color, oy, ox)[0]
        num_v += w * w * _shift(var, oy, ox)[0]
        den += w
    den = np.maximum(den, _EPS)
    return num_c / den[None], num_v / (den * den)


def _sweep_np(color, var, normal, depth, params, frozen=None):
    """Multi-level sweep in float64; returns (color, variance, per-level
    weights).  ``frozen`` replays recorded weights (detached-weight AD)."""
    color, var, normal, depth = (np.asarray(a, np.float64)
                                 for a in (color, var, normal, depth))
    zgrad = np.stack([np.gradient(depth, axis=0), np.gradient(depth, axis=1)])
    levels = []
    for lvl in range(params.iterations):
        ws = (frozen[lvl] if frozen is not None else
              _weights_np(color, var, normal, depth, zgrad, lvl, params))
        levels.append(ws)
        color, var = _apply_np(ws, color, var)
    return color, var, levels


def _assert_close_f64(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale


def test_numpy_zgrad_matches_finite_diff_gradients(rng):
    depth = _scene(rng)[3]
    want = np.stack([np.gradient(depth.astype(np.float64), axis=a)
                     for a in (0, 1)])
    _assert_close_f64(finite_diff_gradients(jnp.asarray(depth)), want, 1e-6)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_level_matches_f64_loop(rng, level):
    color, var, normal, depth = _scene(rng)
    p = SVGFParams(iterations=1)
    zg = finite_diff_gradients(jnp.asarray(depth))
    got_c, got_v = atrous_level_ref(*map(jnp.asarray, (color, var, normal,
                                                       depth)),
                                    zg, level=level, params=p)
    d64 = [np.asarray(a, np.float64) for a in (color, var, normal, depth)]
    zg64 = np.stack([np.gradient(d64[3], axis=0), np.gradient(d64[3], axis=1)])
    want_c, want_v = _apply_np(
        _weights_np(*d64, zg64, level, p), d64[0], d64[1])
    _assert_close_f64(got_c, want_c, 2e-5)
    _assert_close_f64(got_v, want_v, 2e-5)


@pytest.mark.parametrize("radius", [1, 2])
def test_radius_sweep_matches_f64_loop(rng, radius):
    """Five levels at radius 1 (binomial taps) and 2 (B3 spline)."""
    color, var, normal, depth = _scene(rng)
    p = SVGFParams(iterations=5, radius=radius)
    got_c, got_v = svgf_spatial_ref(*map(jnp.asarray, (color, var, normal,
                                                       depth)), params=p)
    want_c, want_v, _ = _sweep_np(color, var, normal, depth, p)
    _assert_close_f64(got_c, want_c, 5e-5)
    _assert_close_f64(got_v, want_v, 5e-5)


@pytest.mark.parametrize("radius", [1, 2])
def test_luma_only_deep_levels_match_f64_loop(rng, radius):
    """``SVGFParams.luma_only_from``: levels >= the threshold weigh by
    luminance alone, and the mode changes the result."""
    color, var, normal, depth = _scene(rng)
    p = SVGFParams(iterations=5, radius=radius, luma_only_from=3)
    args = tuple(map(jnp.asarray, (color, var, normal, depth)))
    got_c, got_v = svgf_spatial_ref(*args, params=p)
    want_c, want_v, _ = _sweep_np(color, var, normal, depth, p)
    _assert_close_f64(got_c, want_c, 5e-5)
    _assert_close_f64(got_v, want_v, 5e-5)
    base_c, _ = svgf_spatial_ref(
        *args, params=SVGFParams(iterations=5, radius=radius))
    assert float(jnp.abs(got_c - base_c).max()) > 1e-3


def test_feedback_plane_is_the_feedback_level_output(rng):
    color, var, normal, depth = _scene(rng)
    p = SVGFParams(iterations=3, feedback_level=2)
    args = tuple(map(jnp.asarray, (color, var, normal, depth)))
    _, _, fb = svgf_spatial_ref(*args, params=p, return_feedback=True)
    want, _, _ = _sweep_np(color, var, normal, depth,
                           SVGFParams(iterations=2))
    _assert_close_f64(fb, want, 5e-5)


def _loss_np(c, v):
    return np.sin(c).sum() + (v * v).sum()


@pytest.mark.parametrize("iterations", [1, 2])
def test_detached_vjp_matches_finite_differences(rng, iterations):
    """Gradients of ``svgf_spatial_ref(detach_weights=True)`` w.r.t. color
    and variance equal central differences of the float64 loop with its
    edge weights frozen (the detached-weight semantics)."""
    color, var, normal, depth = _scene(rng, 16, 24)
    p = SVGFParams(iterations=iterations)
    args = tuple(map(jnp.asarray, (color, var, normal, depth)))

    def loss(c, v):
        oc, ov = svgf_spatial_ref(c, v, args[2], args[3], params=p,
                                  detach_weights=True)
        return jnp.sum(jnp.sin(oc)) + jnp.sum(ov * ov)

    gc, gv = jax.grad(loss, argnums=(0, 1))(args[0], args[1])
    _, _, frozen = _sweep_np(color, var, normal, depth, p)

    def frozen_loss(c, v):
        oc, ov, _ = _sweep_np(c, v, normal, depth, p, frozen)
        return _loss_np(oc, ov)

    c64, v64 = color.astype(np.float64), var.astype(np.float64)
    eps = 1e-4
    for _ in range(3):
        uc = rng.standard_normal(c64.shape)
        uv = rng.standard_normal(v64.shape)
        fd = (frozen_loss(c64 + eps * uc, v64 + eps * uv)
              - frozen_loss(c64 - eps * uc, v64 - eps * uv)) / (2 * eps)
        ad = (np.asarray(gc, np.float64) * uc).sum() + (
            np.asarray(gv, np.float64) * uv).sum()
        assert abs(ad - fd) <= 1e-4 * max(abs(fd), 1.0), (ad, fd)


@pytest.mark.parametrize("radius", [1, 2])
def test_detach_flag_keeps_forward_values(rng, radius):
    color, var, normal, depth = _scene(rng)
    p = SVGFParams(iterations=3, radius=radius)
    args = tuple(map(jnp.asarray, (color, var, normal, depth)))
    det = svgf_spatial_ref(*args, params=p, detach_weights=True)
    full = svgf_spatial_ref(*args, params=p, detach_weights=False)
    for a, b in zip(det, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
