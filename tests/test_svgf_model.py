"""End-to-end SVGF model tests on the Cornell fixture and synthetic sequences."""

import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser import History, SVGFParams
from raymarchdenoiser.gbuffer import GBuffer
from raymarchdenoiser.models.svgf import (
    svgf_denoise_frame,
    svgf_denoise_sequence,
    demodulate,
    remodulate,
)

SMALL = SVGFParams(iterations=2)


def _synthetic_gbuffer(rng, H=32, W=32, seed_noise=0.1):
    base = np.ones((3, H, W), np.float32) * 0.5
    noise = seed_noise * rng.standard_normal((3, H, W)).astype(np.float32)
    albedo = np.full((3, H, W), 0.7, np.float32)
    normal = np.zeros((3, H, W), np.float32)
    normal[2] = 1.0
    return GBuffer(
        render=jnp.asarray(np.clip(base + noise, 0, 1)),
        albedo=jnp.asarray(albedo),
        normal=jnp.asarray(normal),
        depth=jnp.full((H, W), 0.5),
        motion=jnp.zeros((2, H, W)),
    )


def test_demodulate_roundtrip_identity(rng):
    color = jnp.asarray(rng.random((3, 8, 8), dtype=np.float32))
    albedo = jnp.asarray(0.1 + 0.9 * rng.random((3, 8, 8), dtype=np.float32))
    back = remodulate(demodulate(color, albedo), albedo)
    np.testing.assert_allclose(np.asarray(back), np.asarray(color), rtol=1e-5)


def test_demodulate_passthrough_on_emissive(rng):
    color = jnp.asarray(rng.random((3, 4, 4), dtype=np.float32))
    albedo = jnp.zeros((3, 4, 4))
    np.testing.assert_allclose(np.asarray(demodulate(color, albedo)), np.asarray(color))


def test_single_frame_denoise_reduces_noise(rng):
    g = _synthetic_gbuffer(rng)
    out, hist = svgf_denoise_frame(g, History.zeros(*g.shape), params=SMALL)
    assert out.denoised is not None
    d = np.asarray(out.denoised)
    assert np.isfinite(d).all()
    assert d.std() < np.asarray(g.render).std() * 0.6
    assert float(np.asarray(hist.length).min()) == 1.0


@pytest.mark.slow
def test_temporal_accumulation_converges(rng):
    """A static noisy sequence must converge toward the clean mean."""
    params = SVGFParams(iterations=2, temporal_alpha=0.1)
    frames = [_synthetic_gbuffer(rng) for _ in range(8)]
    outs = list(svgf_denoise_sequence(frames, params=params))
    err_first = abs(np.asarray(outs[0].denoised).mean() - 0.5)
    err_last = abs(np.asarray(outs[-1].denoised).mean() - 0.5)
    d_last = np.asarray(outs[-1].denoised)
    assert np.isfinite(d_last).all()
    assert d_last.std() < np.asarray(outs[0].denoised).std() + 1e-6
    assert err_last <= err_first + 0.02


@pytest.mark.slow
def test_cornell_end_to_end(cornell_frame):
    out, hist = svgf_denoise_frame(
        cornell_frame, History.zeros(*cornell_frame.shape), params=SMALL
    )
    d = np.asarray(out.denoised)
    assert np.isfinite(d).all()
    # emissive guard: output should stay near displayable range
    assert d.max() < 3.0
    # flat-region denoising: center of back wall
    r = np.asarray(cornell_frame.render)
    region = (slice(None), slice(120, 180), slice(220, 280))
    # 2 iterations only (compile-time budget); 5-iter smooths much further
    assert d[region].std() < r[region].std() * 0.8
