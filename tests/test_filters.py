"""Tests for the unified FilterParams dispatch (all four reference types)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser.config import FilterParams, FilterType
from raymarchdenoiser.gbuffer import GBuffer
from raymarchdenoiser.ops.filters import (
    apply_filter,
    gaussian_filter,
    cross_bilateral_filter,
)


def _gbuf(rng, H=32, W=40):
    color = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    albedo = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    normal = jnp.zeros((3, H, W)).at[2].set(1.0)
    depth = jnp.full((H, W), 0.5)
    return GBuffer(render=color, albedo=albedo, normal=normal, depth=depth)


def test_gaussian_constant_preserved():
    x = jnp.full((1, 20, 24), 0.4)
    y = gaussian_filter(x, radius=3, sigma=1.5, depth=2)
    np.testing.assert_allclose(np.asarray(y), 0.4, rtol=1e-5)


def test_gaussian_smooths_noise(rng):
    x = jnp.asarray(rng.random((1, 32, 32), dtype=np.float32))
    y = gaussian_filter(x, radius=2, sigma=2.0)
    assert np.asarray(y).std() < np.asarray(x).std() * 0.6


def test_gaussian_matches_direct_small(rng):
    import math
    x = rng.random((1, 9, 9), dtype=np.float32)
    got = np.asarray(gaussian_filter(jnp.asarray(x), radius=1, sigma=1.0))
    t = [math.exp(-0.5 * (i ** 2)) for i in (-1, 0, 1)]
    t = [v / sum(t) for v in t]
    want = np.zeros_like(x)
    H = W = 9
    for i in range(H):
        for j in range(W):
            num = den = 0.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    yy, xx = i + dy, j + dx
                    if 0 <= yy < H and 0 <= xx < W:
                        w = t[dy + 1] * t[dx + 1]
                        num += w * x[0, yy, xx]
                        den += w
            want[0, i, j] = num / den
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_cross_bilateral_respects_albedo_edges(rng):
    H = W = 32
    noise = 0.05 * rng.standard_normal((3, H, W)).astype(np.float32)
    base = np.zeros((3, H, W), np.float32)
    base[:, :, : W // 2] = 1.0
    color = jnp.asarray(base + noise)
    albedo = jnp.asarray(base)
    normal = jnp.zeros((3, H, W)).at[2].set(1.0)
    depth = jnp.full((H, W), 0.5)
    out = np.asarray(cross_bilateral_filter(
        color, albedo, normal, depth,
        params=FilterParams(type=FilterType.CROSS, radius=3, sigma_albedo=0.1)))
    assert out[:, :, : W // 2 - 3].mean() > 0.9
    assert out[:, :, W // 2 + 3:].mean() < 0.1
    # noise reduced on each side
    assert out[:, 4:-4, : W // 2 - 3].std() < color[:, 4:-4, : W // 2 - 3].std() * 0.7


@pytest.mark.parametrize("ftype", list(FilterType))
def test_apply_filter_dispatch(rng, ftype):
    g = _gbuf(rng)
    out = apply_filter(g, FilterParams(type=ftype, depth=2, radius=2))
    assert out.denoised is not None
    d = np.asarray(out.denoised)
    assert d.shape == (3, 32, 40)
    assert np.isfinite(d).all()
    # every filter must actually smooth an uncorrelated-noise image
    assert d.std() < np.asarray(g.render).std()


def test_filter_level_offsets_atrous_start(rng):
    """FilterParams.level (reference filter.cuh:14, unused there) starts the
    à-trous dilation at 2^level: level=1/depth=1 equals a direct level-1
    atrous application, and differs from level=0."""
    from raymarchdenoiser.config import FilterParams, FilterType, SVGFParams
    from raymarchdenoiser.gbuffer import GBuffer
    from raymarchdenoiser.ops.filters import apply_filter
    from raymarchdenoiser.ops.atrous import atrous_level_ref

    H = W = 32
    color = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    var = jnp.full((H, W), 0.05)
    g = GBuffer(render=color, albedo=jnp.full((3, H, W), 0.7),
                normal=jnp.zeros((3, H, W)).at[2].set(1.0),
                depth=jnp.full((H, W), 0.5))
    p1 = FilterParams(type=FilterType.WAVELET, depth=1, level=1)
    out1 = apply_filter(g, p1, variance=var)
    sp = SVGFParams(iterations=1, radius=p1.radius,
                    sigma_color=p1.sigma_color, sigma_normal=p1.sigma_normal,
                    sigma_depth=p1.sigma_depth)
    want, _ = atrous_level_ref(color, var, g.normal, g.depth, level=1, params=sp)
    np.testing.assert_allclose(np.asarray(out1.denoised), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    out0 = apply_filter(g, FilterParams(type=FilterType.WAVELET, depth=1),
                        variance=var)
    assert np.abs(np.asarray(out0.denoised) - np.asarray(out1.denoised)).max() > 1e-4


def test_filter_level_rejected_for_non_wavelet():
    from raymarchdenoiser.config import FilterParams, FilterType
    from raymarchdenoiser.gbuffer import GBuffer
    from raymarchdenoiser.ops.filters import apply_filter

    g = GBuffer(render=jnp.zeros((3, 8, 8)), albedo=jnp.zeros((3, 8, 8)),
                normal=jnp.zeros((3, 8, 8)), depth=jnp.zeros((8, 8)))
    with pytest.raises(ValueError, match="level"):
        apply_filter(g, FilterParams(type=FilterType.AVERAGE, level=1))


def _pad_window(x, r):
    """(…, H+2r, W+2r) zero-padded copy and the matching validity mask."""
    H, W = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)]
    m = np.zeros((H + 2 * r, W + 2 * r))
    m[r:r + H, r:r + W] = 1.0
    return np.pad(x, pad), m


def test_gaussian_depths_match_numpy(rng):
    """Iterated separable gaussian (depths 1 and 2, radius 2) against a
    float64 NumPy loop with border renormalization per 1-D pass."""
    import math
    x = rng.random((3, 40, 72), dtype=np.float32)
    r, sigma = 2, 2.0
    t = np.asarray([math.exp(-0.5 * (i / sigma) ** 2)
                    for i in range(-r, r + 1)])
    t /= t.sum()
    H, W = x.shape[-2:]

    def one_axis(v, axis):
        vp, m = _pad_window(v, r)
        num = np.zeros_like(v)
        den = np.zeros((H, W))
        for i, ti in enumerate(t):
            oy, ox = (i, r) if axis == 0 else (r, i)
            num += ti * vp[..., oy:oy + H, ox:ox + W]
            den += ti * m[oy:oy + H, ox:ox + W]
        return num / den

    want = x.astype(np.float64)
    for depth in (1, 2):
        want = one_axis(one_axis(want, 0), 1)
        got = gaussian_filter(jnp.asarray(x), radius=r, sigma=sigma,
                              depth=depth)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_cross_bilateral_matches_numpy_loop(rng):
    """Cross-bilateral weights (spatial gaussian x albedo x normal x depth
    terms) against a float64 per-tap NumPy loop."""
    import math
    H, W = 40, 72
    color = rng.random((3, H, W), dtype=np.float32)
    albedo = rng.random((3, H, W), dtype=np.float32)
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = (0.3 + 0.5 * rng.random((H, W))).astype(np.float32)
    p = FilterParams(type=FilterType.CROSS)
    got = cross_bilateral_filter(*map(jnp.asarray, (color, albedo, n, depth)),
                                 params=p)

    r = p.radius
    g = np.asarray([math.exp(-0.5 * (i / p.sigma_space) ** 2)
                    for i in range(-r, r + 1)])
    g /= g.sum()
    c64, a64, n64, z64 = (a.astype(np.float64)
                          for a in (color, albedo, n, depth))
    cp, m = _pad_window(c64, r)
    ap, _ = _pad_window(a64, r)
    npd, _ = _pad_window(n64, r)
    zp, _ = _pad_window(z64, r)
    num = np.zeros_like(c64)
    den = np.zeros((H, W))
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            win = (Ellipsis, slice(dy, dy + H), slice(dx, dx + W))
            wa = np.exp(-((a64 - ap[win]) ** 2).sum(0)
                        / (2 * p.sigma_albedo ** 2))
            ndot = np.maximum((n64 * npd[win]).sum(0), 1e-20)
            wz = np.exp(-np.abs(z64 - zp[win]) / p.sigma_depth)
            w = g[dy] * g[dx] * m[win] * wa * ndot ** p.sigma_normal * wz
            num += w[None] * cp[win]
            den += w
    np.testing.assert_allclose(np.asarray(got), num / den[None], atol=5e-5)
