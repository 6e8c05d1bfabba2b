"""Temporal sequence quality tests (BASELINE.md config 2) + dataset
generation round trip + golden regression for config 1."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
from raymarchdenoiser.gbuffer import History
from raymarchdenoiser.models.svgf import svgf_denoise_frame
from raymarchdenoiser.ops.raymarch import (
    cornell_scene, cornell_camera, render_gbuffer,
)

CFG = CameraParams(width=96, height=96)
RM = RaymarchParams(max_steps=48, shadow_steps=24)
SVGF = SVGFParams(iterations=3)


@pytest.fixture(scope="module")
def clean_ref():
    scene = cornell_scene()
    cam = cornell_camera()

    @jax.jit
    def render16(keys):
        def one(k):
            return render_gbuffer(scene, cam, cam, k, cam_cfg=CFG, params=RM).render
        return jnp.mean(jax.vmap(one)(keys), axis=0)

    return np.asarray(render16(jax.random.split(jax.random.PRNGKey(99), 16)))


@pytest.mark.slow
def test_static_sequence_temporal_convergence(clean_ref):
    """8 static frames: temporally accumulated denoised output must approach
    the 16-spp reference much closer than a single denoised frame."""
    scene = cornell_scene()
    cam = cornell_camera()
    hist = History.zeros(96, 96)
    errs = []
    for f in range(8):
        g = render_gbuffer(scene, cam, cam, jax.random.PRNGKey(f),
                           cam_cfg=CFG, params=RM)
        out, hist = svgf_denoise_frame(g, hist, params=SVGF)
        errs.append(float(((np.asarray(out.denoised) - clean_ref) ** 2).mean()))
    assert all(np.isfinite(errs))
    assert errs[-1] < errs[0] * 0.7, f"no temporal improvement: {errs}"


def test_generated_dataset_roundtrip(tmp_path):
    from raymarchdenoiser.io.generate import (
        generate_sequence, load_float_frame)
    from raymarchdenoiser.io.dataset import list_frames, load_frame

    root = str(tmp_path)
    frames = generate_sequence(
        root, "mini", frames=3,
        cam_cfg=CameraParams(width=48, height=48),
        rm_params=RaymarchParams(max_steps=24, shadow_steps=12),
    )
    assert list_frames(root, "mini") == [1, 2, 3]
    # PNG pipeline readable
    g_png = load_frame(root, "mini", 2)
    assert g_png.render.shape == (3, 48, 48)
    # float planes exact
    g_npz = load_float_frame(root, "mini", 2)
    np.testing.assert_allclose(
        np.asarray(g_npz.render), np.asarray(frames[1].render), atol=1e-6)
    assert g_npz.motion is not None
    # animated camera => some nonzero motion on frame 2
    assert np.abs(np.asarray(g_npz.motion)).max() > 0.01


def test_animated_sequence_temporal_helps(tmp_path):
    """Moving camera: reprojection must still help vs frame-independent
    denoising (config 2 semantics)."""
    from raymarchdenoiser.io.generate import generate_sequence

    root = str(tmp_path)
    frames = generate_sequence(
        root, "anim", frames=6, cam_cfg=CFG,
        rm_params=RM, save_float=False,
    )
    hist = History.zeros(96, 96)
    outs = []
    for g in frames:
        out, hist = svgf_denoise_frame(g, hist, params=SVGF)
        outs.append(out)
    # history must actually accumulate across moving frames
    assert float(np.asarray(hist.length).mean()) > 2.5
    for o in outs:
        assert np.isfinite(np.asarray(o.denoised)).all()


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell256_svgf5.npz")


def test_golden_cornell256_regression(cornell_frame):
    """BASELINE config 1: Cornell 256x256, 5-iter spatial-only SVGF.

    Guards against silent behavior drift: compares against a checked-in
    golden rendering of the denoised output (regenerate deliberately with
    tests/make_golden.py when semantics change on purpose).
    """
    import jax.image

    g = cornell_frame
    small = jax.tree_util.tree_map(
        lambda x: (jax.image.resize(x, x.shape[:-2] + (256, 256), "linear")
                   if hasattr(x, "shape") and x.ndim >= 2 else x),
        g)
    out, _ = svgf_denoise_frame(
        small, History.zeros(256, 256), params=SVGFParams(iterations=5))
    got = np.asarray(out.denoised)
    assert np.isfinite(got).all()
    if not os.path.exists(GOLDEN):
        pytest.skip("golden file not generated yet (run tests/make_golden.py)")
    want = np.load(GOLDEN)["denoised"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
