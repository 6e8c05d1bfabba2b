"""Raymarcher tests: geometry, G-buffer planes, noise statistics, gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser.config import CameraParams, RaymarchParams
from raymarchdenoiser.ops.raymarch import (
    Scene,
    Camera,
    cornell_scene,
    cornell_camera,
    sdf_scene,
    sdf_normal,
    camera_rays,
    raymarch,
    render_gbuffer,
)

CFG = CameraParams(width=64, height=64)
RM = RaymarchParams(max_steps=48, shadow_steps=24)


@pytest.fixture(scope="module")
def scene():
    return cornell_scene()


@pytest.fixture(scope="module")
def frame(scene):
    key = jax.random.PRNGKey(0)
    return render_gbuffer(scene, cornell_camera(), None, key, cam_cfg=CFG, params=RM)


def test_sdf_center_inside_box(scene):
    # center of the box interior: nearest surface < 1 away, sign positive
    p = jnp.zeros((3, 1, 1))
    d, mat = sdf_scene(scene, p)
    assert 0 < float(d[0, 0]) <= 1.0


def test_sdf_normals_unit(scene, rng):
    p = jnp.asarray(rng.uniform(-0.9, 0.9, (3, 8, 8)).astype(np.float32))
    n = sdf_normal(scene, p)
    lens = np.linalg.norm(np.asarray(n), axis=0)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)


def test_camera_rays_normalized():
    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    lens = np.linalg.norm(np.asarray(rd), axis=0)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)
    assert ro.shape == (3, 64, 64)


def test_primary_rays_hit_walls(scene):
    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    t, hit = raymarch(scene, ro, rd, RM)
    # closed box: everything hits except a handful of grazing edge rays that
    # need more than RM.max_steps to converge
    assert np.asarray(hit).mean() > 0.999
    assert np.asarray(t).max() < 5.0


def test_gbuffer_planes(frame):
    g = frame
    assert g.render.shape == (3, 64, 64)
    for plane in (g.render, g.albedo, g.normal, g.motion):
        assert np.isfinite(np.asarray(plane)).all()
    assert (np.asarray(g.depth) > 0).mean() > 0.999  # closed box: ~all hit
    # normals face the camera (dot with view dir <= 0 on hits)
    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    ndotv = np.asarray(jnp.sum(g.normal * rd, axis=0))
    assert (ndotv <= 1e-3).all()
    # left wall red-ish, right wall green-ish
    alb = np.asarray(g.albedo)
    assert alb[0, 32, 2] > alb[1, 32, 2]   # left column: R > G
    assert alb[1, 32, 61] > alb[0, 32, 61]  # right column: G > R


def test_static_camera_zero_motion(scene):
    key = jax.random.PRNGKey(1)
    cam = cornell_camera()
    g = render_gbuffer(scene, cam, cam, key, cam_cfg=CFG, params=RM)
    m = np.asarray(g.motion)
    hit_interior = np.abs(m) < 0.35  # bilinear/fp slack, plus normal-flip pixels
    assert hit_interior.mean() > 0.97


def test_render_noise_varies_with_key(scene):
    g1 = render_gbuffer(scene, cornell_camera(), None, jax.random.PRNGKey(1),
                        cam_cfg=CFG, params=RM)
    g2 = render_gbuffer(scene, cornell_camera(), None, jax.random.PRNGKey(2),
                        cam_cfg=CFG, params=RM)
    assert not np.allclose(np.asarray(g1.render), np.asarray(g2.render))
    # albedo/normal/depth planes are noise-free
    np.testing.assert_allclose(np.asarray(g1.albedo), np.asarray(g2.albedo))
    np.testing.assert_allclose(np.asarray(g1.depth), np.asarray(g2.depth))


def test_spp_reduces_noise(scene):
    k = jax.random.PRNGKey(3)
    g1 = render_gbuffer(scene, cornell_camera(), None, k, cam_cfg=CFG, params=RM, spp=1)
    g16 = render_gbuffer(scene, cornell_camera(), None, k, cam_cfg=CFG, params=RM, spp=16)
    # variance of the 16-spp render against its own mean must be smaller
    r1, r16 = np.asarray(g1.render), np.asarray(g16.render)
    # compare local high-frequency energy on the floor region
    def hf(x):
        return np.abs(np.diff(x[0, 48:, 8:56], axis=0)).mean()
    assert hf(r16) < hf(r1)


def test_gradients_flow_to_materials(scene):
    key = jax.random.PRNGKey(0)

    def loss(albedo_table):
        s = scene.replace(materials=scene.materials.replace(albedo=albedo_table))
        g = render_gbuffer(s, cornell_camera(), None, key, cam_cfg=CFG, params=RM)
        return jnp.mean(g.render ** 2)

    grads = jax.grad(loss)(scene.materials.albedo)
    ga = np.asarray(grads)
    assert np.isfinite(ga).all()
    # walls visible -> nonzero gradient for wall materials 0..2
    assert np.abs(ga[:3]).max() > 0


def _sphere_interior_mask(scene):
    """Pixels that hit the sphere away from its silhouette (frozen mask).

    t is *discontinuous* across the silhouette (it jumps from the sphere to
    the wall behind), so finite differences of an all-pixel loss measure the
    silhouette jump, not the smooth dt/dθ the implicit adjoint computes.
    Restricting the loss to interior sphere pixels (with the mask frozen
    across the FD perturbations) makes it differentiable.
    """
    from raymarchdenoiser.ops.raymarch import raymarch, camera_rays

    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    t, hit = raymarch(scene, ro, rd, RM)
    p = ro + t[None] * rd
    _, mat = sdf_scene(scene, p)
    on_sphere = np.asarray((mat == 4) & hit)
    # erode: keep pixels whose full 8-neighborhood is also on the sphere
    interior = on_sphere.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            interior &= np.roll(np.roll(on_sphere, dy, 0), dx, 1)
    assert interior.sum() > 20, "sphere should cover interior pixels"
    return jnp.asarray(interior), ro, rd


def test_implicit_vjp_matches_finite_differences(scene):
    """Geometry gradients via the implicit-function adjoint (dt*/dθ =
    -f_θ/(∇f·rd)) agree with central finite differences of the march
    (SURVEY.md §7(b); VERDICT round-1 next-step #2)."""
    from raymarchdenoiser.ops.raymarch import raymarch

    mask, ro, rd = _sphere_interior_mask(scene)

    def loss_at(radius):
        s = scene.replace(
            sphere_params=scene.sphere_params.at[0, 3].set(radius))
        t, _hit = raymarch(s, ro, rd, RM)
        return jnp.sum(jnp.where(mask, t, 0.0))

    r0 = scene.sphere_params[0, 3]
    g = jax.grad(loss_at)(r0)
    eps = 1e-3
    fd = (loss_at(r0 + eps) - loss_at(r0 - eps)) / (2 * eps)
    # growing the sphere shortens the masked rays
    assert float(g) < 0
    np.testing.assert_allclose(float(g), float(fd), rtol=0.05)


def test_implicit_vjp_center_translation_gradient(scene):
    from raymarchdenoiser.ops.raymarch import raymarch

    mask, ro, rd = _sphere_interior_mask(scene)

    def loss_at(cz):
        s = scene.replace(
            sphere_params=scene.sphere_params.at[0, 2].set(cz))
        t, _hit = raymarch(s, ro, rd, RM)
        return jnp.sum(jnp.where(mask, t, 0.0))

    c0 = scene.sphere_params[0, 2]
    g = jax.grad(loss_at)(c0)
    eps = 1e-3
    fd = (loss_at(c0 + eps) - loss_at(c0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=0.05)


def test_implicit_vjp_forward_unchanged(scene):
    """custom_vjp must not change the primal march results."""
    from raymarchdenoiser.ops.raymarch import (
        raymarch, _raymarch_loop, camera_rays)

    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    t1, h1 = raymarch(scene, ro, rd, RM)
    t2, h2 = _raymarch_loop(scene, ro, rd, RM)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))


@pytest.fixture
def triton_route(monkeypatch):
    """Route render_gbuffer's marches through the Triton kernels, run in
    interpret mode (the CPU has no compiled route for them)."""
    import functools
    import importlib

    rmod = importlib.import_module("raymarchdenoiser.ops.raymarch")
    mt = importlib.import_module("raymarchdenoiser.ops.pallas.march_triton")
    monkeypatch.setattr(rmod, "march_route", lambda: "triton")
    monkeypatch.setattr(mt, "march_triton",
                        functools.partial(mt.march_triton, interpret=True))
    monkeypatch.setattr(mt, "shadow_triton",
                        functools.partial(mt.shadow_triton, interpret=True))


def _render(scene, cam, prev, key, cfg=CFG, params=RM):
    """render_gbuffer's body under a fresh jit (no trace cached from the
    other route)."""
    from raymarchdenoiser.ops.raymarch import render_gbuffer_window

    return jax.jit(lambda s, k: render_gbuffer_window(
        s, cam, prev, k, 0, 0, cfg.height, cfg.width, cam_cfg=cfg,
        params=params))(scene, key)


def _assert_planes_close(a, b, atol=5e-5):
    for name in ["render", "albedo", "normal", "depth", "motion"]:
        np.testing.assert_allclose(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            atol=atol, err_msg=name)


def test_pallas_march_parity_interpret(scene, request):
    """Early-exit Triton march + shadow kernels (interpret mode) == the jnp
    loops: every G-buffer plane of a Cornell frame with motion."""
    key = jax.random.PRNGKey(0)
    cam = cornell_camera()
    a = _render(scene, cam, cam, key)
    request.getfixturevalue("triton_route")
    b = _render(scene, cam, cam, key)
    _assert_planes_close(a, b)


def test_pallas_march_gradient_parity_interpret(scene, request):
    """Material gradients through the Triton route == the jnp route (the
    implicit-function adjoint and the shadow stop_gradient are shared)."""
    key = jax.random.PRNGKey(0)

    def loss(albedo):
        s = scene.replace(materials=scene.materials.replace(albedo=albedo))
        return jnp.mean(_render(s, cornell_camera(), None, key).render ** 2)

    g1 = jax.grad(loss)(scene.materials.albedo)
    request.getfixturevalue("triton_route")
    g2 = jax.grad(loss)(scene.materials.albedo)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("shape", [(29, 37), (8, 16), (3, 50), (17, 1)])
def test_triton_march_ragged_shapes(scene, shape):
    """Image shapes that do not divide into 8x16 tiles: the kernels mask
    the pixels past the border, and every in-image pixel matches the loop."""
    from raymarchdenoiser.ops.raymarch import _raymarch_loop, _shadow_factor
    from raymarchdenoiser.ops.pallas.march_triton import (march_triton,
                                                           shadow_triton)

    H, W = shape
    ro, rd, _ = camera_rays(cornell_camera(),
                            CameraParams(width=W, height=H))
    t1, h1 = march_triton(scene, ro, rd, RM, interpret=True)
    t0, h0 = _raymarch_loop(scene, ro, rd, RM)
    assert t1.shape == (H, W) and h1.shape == (H, W) and h1.dtype == bool
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h0))

    p = ro + t0[None] * rd
    n = sdf_normal(scene, p)
    lp = jnp.broadcast_to(scene.light_center[:, None, None], p.shape)
    v1 = shadow_triton(scene, p, n, lp, RM, interpret=True)
    assert v1.shape == (H, W)
    np.testing.assert_array_equal(np.asarray(v1),
                                  np.asarray(_shadow_factor(scene, p, n, lp,
                                                            RM)))


@pytest.mark.parametrize("omega", [1.2, 1.4])
def test_triton_relaxed_parity(scene, omega):
    """Over-relaxed tracing: the kernels apply the loops' rollback rule, so
    relax_omega means the same thing on either route."""
    from raymarchdenoiser.ops.raymarch import _raymarch_loop, _shadow_factor
    from raymarchdenoiser.ops.pallas.march_triton import (march_triton,
                                                           shadow_triton)

    rm = RaymarchParams(max_steps=48, shadow_steps=24, relax_omega=omega)
    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    t1, h1 = march_triton(scene, ro, rd, rm, interpret=True)
    t0, h0 = _raymarch_loop(scene, ro, rd, rm)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h0))
    p = ro + t0[None] * rd
    n = sdf_normal(scene, p)
    lp = jnp.broadcast_to(scene.light_center[:, None, None], p.shape)
    np.testing.assert_array_equal(
        np.asarray(shadow_triton(scene, p, n, lp, rm, interpret=True)),
        np.asarray(_shadow_factor(scene, p, n, lp, rm)))


def test_march_route_choice():
    """One dispatch point: GPU -> Triton kernels, CPU -> jnp loops, any
    other platform is an error (no silent fallback)."""
    from raymarchdenoiser.backend import march_route

    assert march_route("gpu") == "triton"
    assert march_route("cpu") == "jnp"
    assert march_route() == "jnp"  # this suite runs on the CPU
    with pytest.raises(RuntimeError, match="no march route"):
        march_route("metal")


def test_render_gbuffer_route_in_program(scene, request):
    """The route shows in the compiled program: no pallas_call on the CPU
    route; both marches are Triton pallas_calls on the GPU route."""
    from raymarchdenoiser.ops.raymarch import render_gbuffer_window

    def jaxpr_text():
        cam = cornell_camera()
        return str(jax.make_jaxpr(lambda k: render_gbuffer_window(
            scene, cam, cam, k, 0, 0, 16, 16,
            cam_cfg=CameraParams(width=16, height=16), params=RM))(
                jax.random.PRNGKey(0)))

    assert "pallas_call" not in jaxpr_text()
    request.getfixturevalue("triton_route")
    text = jaxpr_text()
    assert text.count("pallas_call") == 2
    assert "sphere_march" in text and "shadow_march" in text


def test_flatten_scene_layout():
    """The kernels read primitives at fixed offsets of the flat scene
    vector: spheres (4 each), boxes (6), planes (4), then material ids."""
    from raymarchdenoiser.ops.raymarch import random_scene
    from raymarchdenoiser.ops.pallas.march_triton import flatten_scene

    sc = random_scene(n_spheres=3, n_boxes=2, n_materials=5, seed=1)
    flat = np.asarray(flatten_scene(sc))
    ns, nb, npl = 3, 2, 5
    assert flat.shape == (ns * 5 + nb * 7 + npl * 5,)
    np.testing.assert_array_equal(flat[:12], np.asarray(sc.sphere_params).ravel())
    np.testing.assert_array_equal(flat[12:24], np.asarray(sc.box_params).ravel())
    np.testing.assert_array_equal(flat[24:44], np.asarray(sc.plane_params).ravel())
    np.testing.assert_array_equal(
        flat[44:], np.concatenate([sc.sphere_mat, sc.box_mat, sc.plane_mat]))


def test_relaxed_march_matches_plain(scene):
    """Over-relaxed sphere tracing (relax_omega > 1) must converge to the
    same surfaces as plain tracing: same hit mask, hit distances within a
    few hit_eps away from silhouettes (the rollback rule guarantees no
    surface is skipped; isolated grazing rays where 64-step plain tracing
    itself hasn't converged may differ by more)."""
    from raymarchdenoiser.ops.raymarch import _raymarch_loop

    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    plain = RaymarchParams(max_steps=64, relax_omega=1.0)
    relaxed = RaymarchParams(max_steps=64, relax_omega=1.4)
    t0, h0 = _raymarch_loop(scene, ro, rd, plain)
    t1, h1 = _raymarch_loop(scene, ro, rd, relaxed)
    assert (np.asarray(h0) == np.asarray(h1)).mean() > 0.999
    both = np.asarray(h0 & h1)
    dt = np.abs(np.asarray(t0) - np.asarray(t1))[both]
    assert np.percentile(dt, 99) < 2 * plain.hit_eps, np.percentile(dt, 99)
    assert dt.max() < 0.1, dt.max()


def test_relaxed_shadow_no_less_accurate_than_plain(scene):
    """Relaxed shadow visibility must be at least as close to a converged
    (128-step plain) reference as the plain 32-step march: the relaxation
    covers the ray in fewer evals, so step-starved grazing rays that plain
    tracing falsely shadows reach the light (measured: 92% vs 90% reference
    agreement on this scene)."""
    from raymarchdenoiser.ops.raymarch import (
        _shadow_factor, _raymarch_loop)

    ro, rd, _ = camera_rays(cornell_camera(), CFG)
    plain = RaymarchParams(relax_omega=1.0)
    t, hit = _raymarch_loop(scene, ro, rd, plain)
    p = ro + t[None] * rd
    n = sdf_normal(scene, p, plain.normal_eps)
    lp = jnp.broadcast_to(scene.light_center[:, None, None], p.shape)
    ref = np.asarray(_shadow_factor(
        scene, p, n, lp, RaymarchParams(relax_omega=1.0, shadow_steps=128)))
    v_plain = np.asarray(_shadow_factor(scene, p, n, lp, plain))
    v_relax = np.asarray(_shadow_factor(
        scene, p, n, lp, RaymarchParams(relax_omega=1.4)))
    agree_plain = (ref == v_plain).mean()
    agree_relax = (ref == v_relax).mean()
    assert agree_relax >= agree_plain - 0.002, (agree_relax, agree_plain)
    assert agree_relax > 0.9


def test_big_scene_kernel_parity_interpret(request):
    """Scene-scale generality: the unrolled kernel SDF and the
    compare-select material lookup on a ~53-primitive / 16-material
    procedural scene match the jnp route."""
    from raymarchdenoiser.ops.raymarch import random_scene
    key = jax.random.PRNGKey(0)
    big = random_scene(n_spheres=24, n_boxes=24, n_materials=16, seed=3)
    cam = cornell_camera()
    a = _render(big, cam, cam, key)
    request.getfixturevalue("triton_route")
    b = _render(big, cam, cam, key)
    _assert_planes_close(a, b)
