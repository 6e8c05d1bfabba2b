"""Differentiable SDF raymarcher emitting a full G-buffer (jnp reference).

The reference repo is *named* RaymarchDenoiserCuda but contains no raymarcher
(SURVEY.md verdict) — only the Cornell G-buffer PNGs it would have produced
(``render/cornell/1/``).  This module supplies the renderer: a sphere-tracing
raymarcher over an SDF primitive scene that emits the same four planes as the
dataset (render/albedo/normal/depth) plus motion vectors, fused into one pass.

The reference loops (:func:`_raymarch_loop`, :func:`_shadow_factor`) march
all pixels in lock-step inside a ``lax.fori_loop`` with a *static* step count
and convergence masks — no data-dependent control flow, full (H, W)-vectorized
math.  On a GPU the two loops run as early-exit Triton kernels instead
(``ops/pallas/march_triton.py``, same update rules); ``backend.march_route``
picks the route.  MC noise in the "render" plane comes from jittered
area-light samples (soft shadows), reproducing the 1-spp pathtrace noise the
denoiser consumes.

Differentiability: materials (albedo, emission) and light are first-class
differentiables; geometry gradients flow through the SDF march (pure
function of scene params) unless wrapped in stop_gradient by the caller.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import pytree

from ..backend import march_route
from ..config import CameraParams, RaymarchParams
from ..gbuffer import GBuffer


@pytree.dataclass
class Materials:
    albedo: jax.Array    # (M, 3)
    emission: jax.Array  # (M, 3)


@pytree.dataclass
class Scene:
    """SDF primitive soup; fixed-size arrays keep shapes static under jit."""

    sphere_params: jax.Array  # (Ns, 4): center xyz, radius
    sphere_mat: jax.Array     # (Ns,) int32
    box_params: jax.Array     # (Nb, 6): center xyz, half-extent xyz
    box_mat: jax.Array        # (Nb,) int32
    plane_params: jax.Array   # (Np, 4): unit normal xyz, offset  (sdf = n.p + d)
    plane_mat: jax.Array      # (Np,) int32
    materials: Materials
    # rectangular area light (also geometrically present as an emissive box)
    light_center: jax.Array   # (3,)
    light_u: jax.Array        # (3,) half-extent vector
    light_v: jax.Array        # (3,) half-extent vector
    light_radiance: jax.Array  # (3,)


@pytree.dataclass
class Camera:
    position: jax.Array  # (3,)
    look_at: jax.Array   # (3,)
    up: jax.Array        # (3,)


def _normalize(v, axis=0, eps=1e-8):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=axis, keepdims=True), eps)


def sdf_scene(scene: Scene, p: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Signed distance + material id at points ``p`` (3, ...)."""
    # spheres: |p - c| - r
    sp = scene.sphere_params  # (Ns, 4)
    d_sph = jnp.linalg.norm(
        p[None] - sp[:, :3, None, None], axis=1
    ) - sp[:, 3, None, None]                       # (Ns, H, W)

    # boxes: |max(|p-c| - h, 0)| + min(max-component, 0)
    bp = scene.box_params
    q = jnp.abs(p[None] - bp[:, :3, None, None]) - bp[:, 3:, None, None]
    d_box = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=1) + jnp.minimum(
        jnp.max(q, axis=1), 0.0
    )                                              # (Nb, H, W)

    # planes: n.p + d
    pp = scene.plane_params
    # explicit component math, NOT einsum: a matrix product may run at
    # reduced precision (TF32 on a GPU) — a ~4e-3 SDF error destroys the
    # finite-difference normals (eps=1e-3).  Elementwise math stays full f32.
    d_pl = (pp[:, 0, None, None] * p[0][None]
            + pp[:, 1, None, None] * p[1][None]
            + pp[:, 2, None, None] * p[2][None]
            + pp[:, 3, None, None])

    dists = jnp.concatenate([d_sph, d_box, d_pl], axis=0)
    mats = jnp.concatenate([scene.sphere_mat, scene.box_mat, scene.plane_mat])
    idx = jnp.argmin(dists, axis=0)
    return jnp.min(dists, axis=0), mats[idx]


def sdf_normal(scene: Scene, p: jax.Array, eps: float = 1e-3) -> jax.Array:
    """Central-difference SDF gradient -> unit normal (3, ...)."""
    def d(off):
        return sdf_scene(scene, p + jnp.asarray(off, p.dtype)[:, None, None])[0]

    n = jnp.stack([
        d([eps, 0, 0]) - d([-eps, 0, 0]),
        d([0, eps, 0]) - d([0, -eps, 0]),
        d([0, 0, eps]) - d([0, 0, -eps]),
    ])
    return _normalize(n)


def camera_basis(camera: Camera, cfg: CameraParams):
    fwd = _normalize(camera.look_at - camera.position)
    # screen-right = up x fwd so that, looking down +z with +y up, +x world
    # appears on screen right (Cornell convention: red wall left, green right)
    right = _normalize(jnp.cross(camera.up, fwd))
    up = jnp.cross(fwd, right)
    half_h = jnp.tan(cfg.fov_y / 2.0)
    half_w = half_h * (cfg.width / cfg.height)
    return fwd, right, up, half_w, half_h


def camera_rays_window(camera: Camera, cfg: CameraParams,
                       row0, col0, th: int, tw: int):
    """Rays for a (th, tw) pixel window at origin (row0, col0) — the sharded
    path's per-tile ray generator (row0/col0 may be traced scalars)."""
    H, W = cfg.height, cfg.width
    fwd, right, up, half_w, half_h = camera_basis(camera, cfg)
    ys = (0.5 - (row0 + jnp.arange(th) + 0.5) / H) * 2 * half_h   # +y up
    xs = ((col0 + jnp.arange(tw) + 0.5) / W - 0.5) * 2 * half_w
    dirs = (
        fwd[:, None, None]
        + up[:, None, None] * ys[None, :, None]
        + right[:, None, None] * xs[None, None, :]
    )
    rd = _normalize(dirs)
    ro = jnp.broadcast_to(camera.position[:, None, None], rd.shape)
    return ro, rd, (fwd, right, up, half_w, half_h)


def camera_rays(camera: Camera, cfg: CameraParams):
    """Primary ray origins/directions (3, H, W) for a pinhole camera."""
    return camera_rays_window(camera, cfg, 0, 0, cfg.height, cfg.width)


def _raymarch_loop(scene: Scene, ro: jax.Array, rd: jax.Array,
                   params: RaymarchParams) -> Tuple[jax.Array, jax.Array]:
    """Sphere-trace all rays in lock-step; returns (t, hit_mask).

    With ``params.relax_omega > 1``: over-relaxed sphere tracing (Keinert et
    al., "Enhanced Sphere Tracing") — step ``ω·d`` instead of ``d``, and when
    the step spheres at the segment's ends don't overlap (``d + d_prev <
    step``, meaning a surface may have been skipped) the step is rolled back
    to the conservative ``d_prev`` from the segment start, so converged hits
    are the same surfaces plain tracing finds, in ~30% fewer SDF evals on
    this scene.  The Triton kernel uses the identical update rule.
    """
    shape = ro.shape[1:]
    om = params.relax_omega

    if om <= 1.0:
        def body(_, t):
            p = ro + t[None] * rd
            d, _m = sdf_scene(scene, p)
            # converged or escaped rays stop advancing (masked update)
            active = (d > params.hit_eps) & (t < params.max_dist)
            return t + jnp.where(active, d, 0.0)

        t = jax.lax.fori_loop(0, params.max_steps, body,
                              jnp.zeros(shape, ro.dtype))
    else:
        def body(_, carry):
            t, d_prev, step_prev = carry
            d, _m = sdf_scene(scene, ro + t[None] * rd)
            # overlap test: only a relaxed step (step_prev > d_prev) can fail
            fail = ((d + d_prev) < step_prev) & (step_prev > d_prev)
            active = (d > params.hit_eps) & (t < params.max_dist) & ~fail
            delta = jnp.where(fail, d_prev - step_prev,
                              jnp.where(active, om * d, 0.0))
            # after a rollback the committed step from the segment start is
            # the conservative d_prev, which can never fail the overlap test
            new_step = jnp.where(fail, d_prev,
                                 jnp.where(active, om * d, step_prev))
            new_dp = jnp.where(active, d, d_prev)
            return (t + delta, new_dp, new_step)

        zero = jnp.zeros(shape, ro.dtype)
        t, _, _ = jax.lax.fori_loop(0, params.max_steps, body,
                                    (zero, zero, zero))
    d_final, _ = sdf_scene(scene, ro + t[None] * rd)
    hit = (d_final <= params.hit_eps * 4.0) & (t < params.max_dist)
    return t, hit


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def raymarch(scene: Scene, ro: jax.Array, rd: jax.Array,
             params: RaymarchParams) -> Tuple[jax.Array, jax.Array]:
    """Differentiable sphere-trace with an implicit-function adjoint.

    Forward: :func:`_march` (the Triton kernel on a GPU, the lock-step
    :func:`_raymarch_loop` on the CPU).  Backward: instead
    of autodiff through ``max_steps`` loop iterations (which stores a
    residual per step), the hit distance is differentiated implicitly: at a
    hit, ``f(θ, ro + t·rd) = const``, so

        dt = -(f_θ·dθ + ∇f·d_ro + t·∇f·d_rd) / (∇f·rd)

    — one SDF evaluation at the hit point replaces the whole unrolled march
    (SURVEY.md §7 hard part (b)).  Misses and escaped rays get zero gradient
    (their t is not a smooth function of the scene), and the denominator is
    magnitude-clamped: grazing rays genuinely have exploding dt/dθ.
    """
    return _march(scene, ro, rd, params)


def _march(scene, ro, rd, params):
    if march_route() == "triton":
        from .pallas.march_triton import march_triton
        return march_triton(scene, ro, rd, params)
    return _raymarch_loop(scene, ro, rd, params)


def _raymarch_fwd(scene, ro, rd, params):
    t, hit = _march(scene, ro, rd, params)
    return (t, hit), (scene, ro, rd, t, hit)


def _raymarch_bwd(params, res, cot):
    scene, ro, rd, t, hit = res
    g_t, _g_hit = cot  # hit is boolean: no cotangent

    p = ro + t[None] * rd

    def f(sc, pp):
        return sdf_scene(sc, pp)[0]

    # ∂f/∂t = ∇f · rd via one forward-mode directional derivative
    denom = jax.jvp(lambda pp: f(scene, pp), (p,), (rd,))[1]
    # hits enter surfaces: denom < 0; clamp magnitude (sign-preserving)
    # for grazing rays
    safe = jnp.where(jnp.abs(denom) < 1e-2,
                     jnp.where(denom < 0, -1e-2, 1e-2), denom)
    s = jnp.where(hit, -g_t / safe, 0.0)

    _, vjp_fn = jax.vjp(f, scene, p)
    d_scene, grad_p_s = vjp_fn(s)     # f_θᵀs  and  (∇f)ᵀs
    d_ro = grad_p_s
    d_rd = t[None] * grad_p_s
    return d_scene, d_ro, d_rd


raymarch.defvjp(_raymarch_fwd, _raymarch_bwd)


def _shadow_ray(p: jax.Array, n: jax.Array, light_p: jax.Array):
    """Shadow ray from hit points ``p`` toward light samples ``light_p``:
    ``(origin, unit direction, distance to the light)``.  The origin is
    offset along the surface *normal* (not the ray) — otherwise rays grazing
    their own surface stall on d≈0."""
    origin = p + 0.02 * n
    to_l = light_p - origin
    dist_l = jnp.linalg.norm(to_l, axis=0)
    return origin, to_l / jnp.maximum(dist_l, 1e-8)[None], dist_l


def shadow_factor(scene: Scene, p: jax.Array, n: jax.Array,
                  light_p: jax.Array, params: RaymarchParams) -> jax.Array:
    """Shadow visibility on the route for this platform (the Triton kernel
    on a GPU, :func:`_shadow_factor` on the CPU)."""
    if march_route() == "triton":
        from .pallas.march_triton import shadow_triton
        return shadow_triton(scene, p, n, light_p, params)
    return _shadow_factor(scene, p, n, light_p, params)


def _shadow_factor(scene: Scene, p: jax.Array, n: jax.Array, light_p: jax.Array,
                   params: RaymarchParams) -> jax.Array:
    """March a shadow ray from p toward light_p; 1 = unoccluded.

    Steps have a floor — otherwise rays grazing their own surface stall on
    d≈0 and produce structured step-count banding instead of shadows.
    """
    origin, ld, dist_l = _shadow_ray(p, n, light_p)
    min_step = 0.01
    om = params.relax_omega

    if om <= 1.0:
        def body(_, t):
            q = origin + t[None] * ld
            d, _m = sdf_scene(scene, q)
            active = (d > params.hit_eps) & (t < dist_l - 0.02)
            return t + jnp.where(active, jnp.maximum(d, min_step), 0.0)

        t = jax.lax.fori_loop(
            0, params.shadow_steps, body, jnp.zeros(p.shape[1:], p.dtype)
        )
    else:
        # relaxed variant of the same march; the conservative fallback step
        # keeps the min_step floor, so grazing rays still can't stall (a
        # floored conservative step is excluded from the overlap test)
        def body(_, carry):
            t, d_prev, step_prev = carry
            d, _m = sdf_scene(scene, origin + t[None] * ld)
            cons = jnp.maximum(d_prev, min_step)
            fail = ((d + d_prev) < step_prev) & (step_prev > cons)
            active = (d > params.hit_eps) & (t < dist_l - 0.02) & ~fail
            step = jnp.maximum(om * d, min_step)
            delta = jnp.where(fail, cons - step_prev,
                              jnp.where(active, step, 0.0))
            new_step = jnp.where(fail, cons,
                                 jnp.where(active, step, step_prev))
            new_dp = jnp.where(active, d, d_prev)
            return (t + delta, new_dp, new_step)

        zero = jnp.zeros(p.shape[1:], p.dtype)
        t, _, _ = jax.lax.fori_loop(0, params.shadow_steps, body,
                                    (zero, zero, zero))
    # visibility is piecewise-constant in the scene params (a.e. zero
    # gradient); stop_gradient keeps autodiff from storing a residual per
    # shadow step for a gradient that is identically zero
    return jax.lax.stop_gradient((t >= dist_l - 0.03).astype(p.dtype))


def sample_light(scene: Scene, key: jax.Array, shape) -> jax.Array:
    """Uniform random point on the rect area light -> (3, H, W)."""
    u = jax.random.uniform(key, (2,) + tuple(shape), minval=-1.0, maxval=1.0)
    return (
        scene.light_center[:, None, None]
        + scene.light_u[:, None, None] * u[0][None]
        + scene.light_v[:, None, None] * u[1][None]
    )


def _material_lookup(mat: jax.Array, *tables: jax.Array):
    """Per-pixel material-table lookup as compare-masked accumulation.

    ``tables[i]`` is (M, C); ``mat`` is an (H, W) int id map; returns one
    (C, H, W) plane stack per table.  M is tiny and static, so M broadcast
    compares shared across all tables + M*C masked FMAs fuse into one
    elementwise pass.  Linear in the tables, so gradients match a gather's.
    """
    M = tables[0].shape[0]
    outs = [jnp.zeros((t.shape[1],) + mat.shape, t.dtype) for t in tables]
    for k in range(M):
        sel = (mat == k)[None].astype(tables[0].dtype)
        outs = [o + sel * t[k][:, None, None] for o, t in zip(outs, tables)]
    return outs if len(outs) > 1 else outs[0]


def render_gbuffer_window(
    scene: Scene,
    camera: Camera,
    prev_camera: Optional[Camera],
    key: jax.Array,
    row0, col0, th: int, tw: int,
    *,
    cam_cfg: CameraParams = CameraParams(),
    params: RaymarchParams = RaymarchParams(),
    spp: int = 1,
) -> GBuffer:
    """Fused raymarch + G-buffer pass over a pixel window (sharding-ready):
    one march, all planes emitted.  ``spp`` light samples average into the
    noisy render plane (1 = reference noise level; large spp approximates the
    clean target).  row0/col0 may be traced (per-device tile origins).

    The primary and shadow marches take the platform's route
    (:func:`raymarch`, :func:`shadow_factor`); normals, materials, shading
    and motion are elementwise XLA code around them.
    """
    ro, rd, _basis = camera_rays_window(camera, cam_cfg, row0, col0, th, tw)
    t, hit = raymarch(scene, ro, rd, params)
    p = ro + t[None] * rd
    _, mat = sdf_scene(scene, p)
    n = sdf_normal(scene, p, params.normal_eps)
    # flip normal toward the viewer (SDF gradient points outward)
    n = jnp.where(jnp.sum(n * rd, axis=0, keepdims=True) > 0, -n, n)

    albedo, emission = _material_lookup(
        mat, scene.materials.albedo, scene.materials.emission)  # (3, H, W)

    hit_f = hit.astype(ro.dtype)[None]
    albedo = albedo * hit_f
    emission = emission * hit_f

    # direct lighting: spp jittered area-light samples (soft-shadow MC noise)
    full = (cam_cfg.height, cam_cfg.width)

    def one_sample(k):
        # light samples are drawn for the whole frame and windowed, so a
        # tile sees exactly the noise of the full-frame render
        lp = sample_light(scene, k, full)
        if (th, tw) != full:
            lp = jax.lax.dynamic_slice(lp, (0, row0, col0), (3, th, tw))
        to_l = lp - p
        dist2 = jnp.sum(to_l * to_l, axis=0)
        ld = to_l / jnp.maximum(jnp.sqrt(dist2), 1e-8)[None]
        cos_s = jnp.maximum(jnp.sum(n * ld, axis=0), 0.0)
        # light faces downward (-v normal approx): cos at light
        light_n = _normalize(jnp.cross(scene.light_u, scene.light_v))
        cos_l = jnp.abs(light_n[0] * ld[0] + light_n[1] * ld[1]
                        + light_n[2] * ld[2])
        vis = shadow_factor(scene, p, n, lp, params)
        area = 4.0 * jnp.linalg.norm(jnp.cross(scene.light_u, scene.light_v))
        geom = cos_s * cos_l * area / jnp.maximum(dist2, 1e-4)
        return scene.light_radiance[:, None, None] * (vis * geom)[None]

    keys = jax.random.split(key, spp)
    irr = jnp.mean(jax.vmap(one_sample)(keys), axis=0)
    ambient = 0.08
    render = albedo * (irr / jnp.pi + ambient) + emission

    # motion vectors: reproject hit point into the previous camera
    if prev_camera is not None:
        pro, prd, (pfwd, pright, pup, phw, phh) = camera_rays(prev_camera, cam_cfg)
        rel = p - prev_camera.position[:, None, None]
        def dot3(v, w):  # f32 elementwise dot (see the d_pl note on einsum)
            return v[0] * w[0] + v[1] * w[1] + v[2] * w[2]

        z = dot3(pfwd, rel)
        x = dot3(pright, rel) / jnp.maximum(z, 1e-6)
        y = dot3(pup, rel) / jnp.maximum(z, 1e-6)
        px = (x / phw * 0.5 + 0.5) * cam_cfg.width - 0.5
        py = (0.5 - y / phh * 0.5) * cam_cfg.height - 0.5
        iy = (row0 + jnp.arange(th, dtype=ro.dtype))[:, None]
        ix = (col0 + jnp.arange(tw, dtype=ro.dtype))[None, :]
        motion = jnp.stack([py - iy, px - ix]) * hit_f
    else:
        motion = jnp.zeros((2,) + t.shape, ro.dtype)

    depth = jnp.where(hit, t, 0.0)
    return GBuffer(
        render=render, albedo=albedo, normal=n * hit_f, depth=depth,
        motion=motion, denoised=None,
    )


@functools.partial(jax.jit, static_argnames=("cam_cfg", "params", "spp"))
def render_gbuffer(
    scene: Scene,
    camera: Camera,
    prev_camera: Optional[Camera],
    key: jax.Array,
    *,
    cam_cfg: CameraParams = CameraParams(),
    params: RaymarchParams = RaymarchParams(),
    spp: int = 1,
) -> GBuffer:
    """Full-frame fused raymarch + G-buffer pass (differentiable)."""
    return render_gbuffer_window(
        scene, camera, prev_camera, key, 0, 0, cam_cfg.height, cam_cfg.width,
        cam_cfg=cam_cfg, params=params, spp=spp,
    )


# ---------------------------------------------------------------------------
# Cornell-box scene builder (matches the reference dataset's layout intent)
# ---------------------------------------------------------------------------

def cornell_scene(
    *,
    left_color=(0.75, 0.08, 0.08),
    right_color=(0.08, 0.65, 0.08),
    white=(0.85, 0.85, 0.85),
    box_color=(0.35, 0.35, 0.35),
    light_radiance=(18.0, 18.0, 18.0),
    dtype=jnp.float32,
) -> Scene:
    """Cornell box in [-1,1]^2 x [0,2]: 5 walls, tall box, short box, sphere,
    ceiling rect light — the scene of ``render/cornell/1/``."""
    mats_albedo = jnp.asarray([
        white,        # 0 floor/ceiling/back
        left_color,   # 1 left wall
        right_color,  # 2 right wall
        box_color,    # 3 boxes
        white,        # 4 sphere
        (0.0, 0.0, 0.0),  # 5 light (emissive)
    ], dtype)
    mats_emission = jnp.zeros_like(mats_albedo).at[5].set(
        jnp.asarray(light_radiance, dtype))

    # coordinate system: x right, y up, z into the box (camera at -z)
    planes = jnp.asarray([
        [0, 1, 0, 1.0],    # floor y=-1
        [0, -1, 0, 1.0],   # ceiling y=+1
        [0, 0, -1, 2.0],   # back wall z=+2
        [1, 0, 0, 1.0],    # left wall x=-1
        [-1, 0, 0, 1.0],   # right wall x=+1
    ], dtype)
    plane_mat = jnp.asarray([0, 0, 0, 1, 2], jnp.int32)

    boxes = jnp.asarray([
        [-0.35, -0.40, 1.30, 0.30, 0.60, 0.30],   # tall box
        [0.40, -0.70, 0.90, 0.28, 0.30, 0.28],    # short box
        [0.0, 0.995, 1.25, 0.25, 0.012, 0.20],    # light slab on ceiling
    ], dtype)
    box_mat = jnp.asarray([3, 3, 5], jnp.int32)

    spheres = jnp.asarray([[-0.45, -0.72, 0.80, 0.28]], dtype)
    sphere_mat = jnp.asarray([4], jnp.int32)

    return Scene(
        sphere_params=spheres, sphere_mat=sphere_mat,
        box_params=boxes, box_mat=box_mat,
        plane_params=planes, plane_mat=plane_mat,
        materials=Materials(albedo=mats_albedo, emission=mats_emission),
        light_center=jnp.asarray([0.0, 0.98, 1.25], dtype),
        light_u=jnp.asarray([0.25, 0.0, 0.0], dtype),
        light_v=jnp.asarray([0.0, 0.0, 0.20], dtype),
        light_radiance=jnp.asarray(light_radiance, dtype),
    )


def random_scene(
    n_spheres: int = 24,
    n_boxes: int = 24,
    n_materials: int = 16,
    seed: int = 0,
    dtype=jnp.float32,
) -> Scene:
    """Procedural stress scene: the Cornell shell (5 walls + ceiling light)
    plus ``n_spheres``/``n_boxes`` primitives over ``n_materials`` random
    materials — scales the statically unrolled SDF and the compare-select
    material lookup well beyond the 9-primitive Cornell fixture."""
    import numpy as _np
    rng = _np.random.default_rng(seed)

    mats_albedo = rng.uniform(0.05, 0.9, (n_materials, 3)).astype(_np.float32)
    mats_emission = _np.zeros((n_materials, 3), _np.float32)
    mats_emission[n_materials - 1] = (18.0, 18.0, 18.0)  # light material

    planes = _np.asarray([
        [0, 1, 0, 1.0], [0, -1, 0, 1.0], [0, 0, -1, 2.0],
        [1, 0, 0, 1.0], [-1, 0, 0, 1.0]], _np.float32)
    plane_mat = rng.integers(0, n_materials - 1, 5).astype(_np.int32)

    def body_positions(n):
        p = rng.uniform((-0.85, -0.85, 0.25), (0.85, 0.85, 1.85), (n, 3))
        return p.astype(_np.float32)

    sph = _np.concatenate([
        body_positions(n_spheres),
        rng.uniform(0.05, 0.22, (n_spheres, 1)).astype(_np.float32)], axis=1)
    sphere_mat = rng.integers(0, n_materials - 1, n_spheres).astype(_np.int32)

    box_half = rng.uniform(0.04, 0.2, (n_boxes, 3)).astype(_np.float32)
    boxes = _np.concatenate([body_positions(n_boxes), box_half], axis=1)
    # last box is the ceiling light slab (emissive material)
    boxes[-1] = (0.0, 0.995, 1.25, 0.25, 0.012, 0.20)
    box_mat = rng.integers(0, n_materials - 1, n_boxes).astype(_np.int32)
    box_mat[-1] = n_materials - 1

    return Scene(
        sphere_params=jnp.asarray(sph, dtype),
        sphere_mat=jnp.asarray(sphere_mat),
        box_params=jnp.asarray(boxes, dtype),
        box_mat=jnp.asarray(box_mat),
        plane_params=jnp.asarray(planes, dtype),
        plane_mat=jnp.asarray(plane_mat),
        materials=Materials(albedo=jnp.asarray(mats_albedo, dtype),
                            emission=jnp.asarray(mats_emission, dtype)),
        light_center=jnp.asarray([0.0, 0.98, 1.25], dtype),
        light_u=jnp.asarray([0.25, 0.0, 0.0], dtype),
        light_v=jnp.asarray([0.0, 0.0, 0.20], dtype),
        light_radiance=jnp.asarray([18.0, 18.0, 18.0], dtype),
    )


def cornell_camera(dtype=jnp.float32) -> Camera:
    return Camera(
        position=jnp.asarray([0.0, 0.0, -1.6], dtype),
        look_at=jnp.asarray([0.0, 0.0, 1.0], dtype),
        up=jnp.asarray([0.0, 1.0, 0.0], dtype),
    )
