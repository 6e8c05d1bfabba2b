"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates that the halo-exchange pipeline reproduces the single-device
oracle bit-for-bit (up to fp reassociation) for several mesh shapes, and that
gradients flow through ``ppermute`` transposes (SURVEY.md §4 distributed-test
implication).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser.config import SVGFParams
from raymarchdenoiser.ops.atrous import svgf_spatial_ref
from raymarchdenoiser.parallel.mesh import make_mesh, factor2
from raymarchdenoiser.parallel.sharded import svgf_spatial_sharded

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _scene(rng, H=64, W=64):
    color = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    variance = jnp.asarray((0.02 * rng.random((H, W))).astype(np.float32))
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = jnp.asarray((0.3 + 0.5 * rng.random((H, W))).astype(np.float32))
    return color, variance, jnp.asarray(n), depth


def test_factor2():
    assert factor2(8) == (2, 4)
    assert factor2(16) == (4, 4)
    assert factor2(7) == (1, 7)


def test_make_mesh_shapes():
    m = make_mesh(8)
    assert m.devices.shape == (1, 2, 4)
    m2 = make_mesh(8, data=2)
    assert m2.devices.shape == (2, 2, 2)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_spatial_matches_oracle(rng, n_dev):
    color, variance, normal, depth = _scene(rng)
    params = SVGFParams(iterations=3)
    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    mesh = make_mesh(n_dev)
    got_c, got_v = svgf_spatial_sharded(color, variance, normal, depth,
                                        mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-6)


def test_sharded_deep_levels_halo_exceeds_tile(rng):
    """Level-4 halo (32 px) larger than the 16-px local tile of an 8-way mesh:
    exchange must still be correct (multi-hop halos degenerate to zeros only
    outside the image)."""
    color, variance, normal, depth = _scene(rng, 64, 64)
    params = SVGFParams(iterations=5)  # level 4 halo: 2 * 2^4 = 32 px
    want_c, _ = svgf_spatial_ref(color, variance, normal, depth,
                                 params=params, detach_weights=True)
    mesh = make_mesh(8)  # 2x4 spatial: 32x16 tiles -> halo 32 > 16-px x-tiles
    got_c, _ = svgf_spatial_sharded(color, variance, normal, depth,
                                    mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_nondivisible_500x500_matches_oracle(rng, n_dev):
    """Pad-and-mask wrapper (VERDICT r3 weak #3): the reference's own
    500×500 Cornell fixture shape (render/cornell/1/) shards on meshes
    whose tile grids don't divide it — the image is padded to divisible
    tiles, global-coordinate masks keep true-border semantics, outputs are
    cropped.  Results must equal the unsharded oracle."""
    color, variance, normal, depth = _scene(rng, 500, 500)
    params = SVGFParams(iterations=3)
    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    mesh = make_mesh(n_dev)
    got_c, got_v = svgf_spatial_sharded(color, variance, normal, depth,
                                        mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-6)


@pytest.mark.slow
def test_sharded_nondivisible_prime_shape_matches_oracle(rng):
    """Prime-ish global shape (509×763) on an asymmetric 2×4 mesh: tiles pad
    255×191 -> wrapper rounds to 510×764 and crops."""
    color, variance, normal, depth = _scene(rng, 509, 763)
    params = SVGFParams(iterations=2)
    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    mesh = make_mesh(8)
    got_c, got_v = svgf_spatial_sharded(color, variance, normal, depth,
                                        mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-6)


def test_sharded_nondivisible_matches_oracle(rng):
    """Pad-and-mask on a small odd shape: the padded tiles' global masks
    drop pad pixels exactly like the oracle's dropped taps."""
    color, variance, normal, depth = _scene(rng, 61, 93)
    params = SVGFParams(iterations=2)
    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    mesh = make_mesh(4)
    got_c, got_v = svgf_spatial_sharded(color, variance, normal, depth,
                                        mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-6)


def test_sharded_gradients_match_oracle(rng):
    color, variance, normal, depth = _scene(rng, 32, 32)
    params = SVGFParams(iterations=2)
    mesh = make_mesh(4)

    def loss_ref(c):
        oc, _ = svgf_spatial_ref(c, variance, normal, depth, params=params,
                                 detach_weights=True)
        return jnp.sum(oc ** 2)

    def loss_shard(c):
        oc, _ = svgf_spatial_sharded(c, variance, normal, depth, mesh=mesh,
                                     params=params)
        return jnp.sum(oc ** 2)

    g_ref = jax.grad(loss_ref)(color)
    g_shard = jax.grad(loss_shard)(color)
    np.testing.assert_allclose(np.asarray(g_shard), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_five_levels_and_feedback_match_oracle(rng, n_dev):
    """The default five-level sweep, including the feedback plane the
    temporal history consumes."""
    color, variance, normal, depth = _scene(rng)
    params = SVGFParams(feedback_level=1)
    want = svgf_spatial_ref(color, variance, normal, depth, params=params,
                            detach_weights=True, return_feedback=True)
    got = svgf_spatial_sharded(color, variance, normal, depth,
                               mesh=make_mesh(n_dev), params=params,
                               return_feedback=True)
    for name, a, b in zip(["color", "variance", "feedback"], want, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=5e-5, atol=1e-5, err_msg=name)


def test_sharded_variance_gradients_match_oracle(rng):
    """Gradients w.r.t. color AND variance route their halo parts back to
    the owning tiles over the ppermute transposes."""
    color, variance, normal, depth = _scene(rng, 48, 48)
    params = SVGFParams(iterations=2)
    mesh = make_mesh(4)

    def loss(fn):
        def L(c, v):
            oc, ov = fn(c, v)
            return jnp.sum(oc ** 2) + jnp.sum(ov * 1.7)
        return L

    ref = loss(lambda c, v: svgf_spatial_ref(c, v, normal, depth,
                                             params=params))
    shd = loss(lambda c, v: svgf_spatial_sharded(c, v, normal, depth,
                                                 mesh=mesh, params=params))
    g_ref = jax.grad(ref, argnums=(0, 1))(color, variance)
    g_shd = jax.grad(shd, argnums=(0, 1))(color, variance)
    for name, a, b in zip(["d_color", "d_variance"], g_ref, g_shd):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_r1_luma_mode_matches_oracle(rng, n_dev):
    """Radius-1 taps with luminance-only weights from level 3: forward and
    gradients of the sharded sweep match the single-device oracle."""
    H = W = 64
    color, variance, normal, depth = _scene(rng, H, W)
    params = SVGFParams(iterations=5, radius=1, luma_only_from=3)
    mesh = make_mesh(n_dev)

    def run(c, v):
        return svgf_spatial_sharded(c, v, normal, depth, mesh=mesh,
                                    params=params)

    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    got_c, got_v = run(color, variance)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-6)

    def loss_ref(c, v):
        oc, ov = svgf_spatial_ref(c, v, normal, depth, params=params,
                                  detach_weights=True)
        return jnp.sum(oc ** 2) + jnp.sum(ov)

    def loss_sh(c, v):
        oc, ov = run(c, v)
        return jnp.sum(oc ** 2) + jnp.sum(ov)

    g_ref = jax.grad(loss_ref, argnums=(0, 1))(color, variance)
    g_sh = jax.grad(loss_sh, argnums=(0, 1))(color, variance)
    for name, a, b in zip(["d_color", "d_variance"], g_ref, g_sh):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_sharded_oracle_luma_mode_matches_ref(rng):
    """The sharded ORACLE path also runs luma_only_from (tile-local mirror of
    atrous_level_ref's luma branch + global masks)."""
    color, variance, normal, depth = _scene(rng, 64, 64)
    params = SVGFParams(iterations=5, radius=1, luma_only_from=3)
    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    mesh = make_mesh(8)
    got_c, got_v = svgf_spatial_sharded(color, variance, normal, depth,
                                        mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-6)


def test_sharded_pyramid_mode_raises(rng):
    """``pyramid_from`` is a single-device experiment: the sharded sweep
    refuses it loudly."""
    color, variance, normal, depth = _scene(rng, 32, 32)
    with pytest.raises(NotImplementedError, match="pyramid_from"):
        svgf_spatial_sharded(color, variance, normal, depth,
                             mesh=make_mesh(4),
                             params=SVGFParams(iterations=3, pyramid_from=2))


def test_sharded_pipeline_rejects_nondivisible_shape():
    from raymarchdenoiser.config import CameraParams, RaymarchParams
    from raymarchdenoiser.parallel.sharded import make_sharded_pipeline

    with pytest.raises(ValueError, match="does not tile"):
        make_sharded_pipeline(make_mesh(4), 33, 32,
                              cam_cfg=CameraParams(width=32, height=33),
                              rm_params=RaymarchParams(),
                              svgf_params=SVGFParams())


def _small_pipeline_cfg(H, W):
    from raymarchdenoiser.config import CameraParams, RaymarchParams
    return dict(cam_cfg=CameraParams(width=W, height=H),
                rm_params=RaymarchParams(max_steps=16, shadow_steps=8),
                svgf_params=SVGFParams(iterations=2, max_motion=3))


def test_sharded_pipeline_matches_single_device(rng):
    """make_sharded_pipeline over two frames (frame 2 reprojects through the
    carried history) equals render_and_denoise on one device: tiles render
    the full frame's noise and every stencil sees its halo."""
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.models.pipeline import render_and_denoise
    from raymarchdenoiser.ops.raymarch import cornell_scene, cornell_camera
    from raymarchdenoiser.parallel.sharded import make_sharded_pipeline

    H = W = 32
    kw = _small_pipeline_cfg(H, W)
    f_sh = make_sharded_pipeline(make_mesh(4), H, W, **kw)
    scene, cam = cornell_scene(), cornell_camera()
    key = jax.random.PRNGKey(0)
    h1 = h4 = History.zeros(H, W)
    for _ in range(2):
        g1, h1 = render_and_denoise(scene, cam, cam, h1, key, **kw)
        g4, h4 = f_sh(scene, cam, cam, h4, key)
    d1, d4 = np.asarray(g1.denoised), np.asarray(g4.denoised)
    assert np.isfinite(d4).all()
    np.testing.assert_allclose(d4, d1, rtol=1e-4, atol=1e-4)


def test_sharded_train_step_matches_single_device(rng):
    """Two Adam steps of make_sharded_train_step (step 2 consumes the
    carried history) track make_train_step on one device: same losses and
    the same updated albedo table."""
    import optax
    from raymarchdenoiser.models.pipeline import (init_train_state,
                                                  make_train_step)
    from raymarchdenoiser.ops.raymarch import cornell_scene, cornell_camera
    from raymarchdenoiser.parallel.sharded import make_sharded_train_step

    H = W = 32
    kw = _small_pipeline_cfg(H, W)
    scene, cam = cornell_scene(), cornell_camera()
    target = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    opt = optax.adam(1e-2)

    step1 = make_train_step(scene, cam, target, opt, **kw)
    st = init_train_state(scene.materials.albedo, opt, H, W,
                          jax.random.PRNGKey(0))
    step4 = make_sharded_train_step(make_mesh(4), scene, cam, target, opt,
                                    **kw)
    a4, o4, h4, k4 = st.albedo, st.opt_state, st.history, st.key
    for _ in range(2):
        st, l1 = step1(st)
        a4, o4, h4, k4, l4 = step4(a4, o4, h4, k4)
        assert abs(float(l4) - float(l1)) <= 1e-4 * abs(float(l1)), (l4, l1)
    np.testing.assert_allclose(np.asarray(a4), np.asarray(st.albedo),
                               rtol=1e-4, atol=1e-5)


def test_sharded_luma_mode_composes_with_pad_and_mask(rng):
    """The r1+luma per-scene mode AND a non-mesh-divisible global shape
    (pad-and-mask) at once: the padded tiles' global masks and the luma
    levels must not interfere."""
    H, W = 67, 45
    color, variance, normal, depth = _scene(rng, H, W)
    params = SVGFParams(iterations=5, radius=1, luma_only_from=3)
    want_c, want_v = svgf_spatial_ref(color, variance, normal, depth,
                                      params=params, detach_weights=True)
    mesh = make_mesh(4)
    got_c, got_v = svgf_spatial_sharded(color, variance, normal, depth,
                                        mesh=mesh, params=params)
    np.testing.assert_allclose(np.asarray(got_c), np.asarray(want_c),
                               rtol=5e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_v), np.asarray(want_v),
                               rtol=5e-5, atol=1e-5)
