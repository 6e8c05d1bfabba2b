"""Sphere-tracing kernels for the GPU: Pallas through Triton.

``ops/raymarch.py`` marches every pixel in lock-step: each of ``max_steps``
``fori_loop`` iterations is a separate XLA kernel that reads and writes the
per-pixel ray state in device memory, and every pixel pays for the slowest
pixel of the frame.  Here one program handles an 8x16 pixel tile, keeps its
128 rays in registers, and runs a ``while_loop`` that stops as soon as none
of its own rays is still marching (or at the step limit).  Wall pixels
converge in a handful of steps, so most tiles stop long before the limit.

* :func:`march_triton` — the primary march, same contract as
  ``ops.raymarch._raymarch_loop`` (returns ``(t, hit)``).
* :func:`shadow_triton` — the area-light shadow march, same contract as
  ``ops.raymarch._shadow_factor`` (returns the visibility plane).

The update rules (plain and over-relaxed) are the ones of the jnp loops, so
``RaymarchParams.relax_omega`` means the same thing on either route.  Only
the forward loop differs: the implicit-function adjoint of
``ops.raymarch.raymarch`` and the ``stop_gradient`` on the shadow factor are
shared, so gradients are identical.

Layout: the (3, H, W) ray planes are passed flat; a program's pixel indices
are computed from its tile coordinates, and pixels past the image border are
masked out of every load (they start out escaped, so they never hold up a
tile's exit).  Results go to planes padded up to whole tiles, so no two
lanes ever store to one address; the wrapper slices the padding off (a no-op
at 1080p, which divides into 8x16 tiles).  The scene's primitive parameters travel as one flat
vector that every program reads whole; primitive counts are static, so the
SDF loops unroll.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import RaymarchParams

# One program marches an 8x16 tile: 128 rays, one per thread of 4 warps.
# A 2D tile keeps neighbouring rays (which converge after similar step
# counts) together, so a tile exits soon after its own slowest ray.
TILE_H = 8
TILE_W = 16
_NUM_WARPS = 4
_SHADOW_MIN_STEP = 0.01


def flatten_scene(scene) -> jax.Array:
    """Pack the Scene's primitive parameters into one flat f32 vector.

    Layout: [spheres (Ns,4) | boxes (Nb,6) | planes (Np,4) | sphere_mat (Ns)
    | box_mat (Nb) | plane_mat (Np)] — material ids as f32 for one dtype.
    """
    return jnp.concatenate([
        scene.sphere_params.reshape(-1).astype(jnp.float32),
        scene.box_params.reshape(-1).astype(jnp.float32),
        scene.plane_params.reshape(-1).astype(jnp.float32),
        scene.sphere_mat.astype(jnp.float32),
        scene.box_mat.astype(jnp.float32),
        scene.plane_mat.astype(jnp.float32),
    ])


def _counts(scene):
    return (scene.sphere_params.shape[0], scene.box_params.shape[0],
            scene.plane_params.shape[0])


def _make_sdf(sc, counts):
    """Component-wise SDF over the scalars of the flat scene ref ``sc``:
    ``sdf(px, py, pz) -> d`` (the primitive loops unroll statically)."""
    n_sph, n_box, n_pl = counts
    ob = n_sph * 4
    op = ob + n_box * 6

    def sdf(px, py, pz):
        d = None

        def take(di):
            nonlocal d
            d = di if d is None else jnp.minimum(d, di)

        for i in range(n_sph):
            dx = px - sc[4 * i]
            dy = py - sc[4 * i + 1]
            dz = pz - sc[4 * i + 2]
            take(jnp.sqrt(dx * dx + dy * dy + dz * dz) - sc[4 * i + 3])
        for i in range(n_box):
            o = ob + 6 * i
            qx = jnp.abs(px - sc[o]) - sc[o + 3]
            qy = jnp.abs(py - sc[o + 1]) - sc[o + 4]
            qz = jnp.abs(pz - sc[o + 2]) - sc[o + 5]
            ox = jnp.maximum(qx, 0.0)
            oy = jnp.maximum(qy, 0.0)
            oz = jnp.maximum(qz, 0.0)
            outside = jnp.sqrt(ox * ox + oy * oy + oz * oz)
            take(outside + jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)),
                                       0.0))
        for i in range(n_pl):
            o = op + 4 * i
            take(sc[o] * px + sc[o + 1] * py + sc[o + 2] * pz + sc[o + 3])
        return d

    return sdf


def _padded(H: int, W: int):
    return pl.cdiv(H, TILE_H) * TILE_H, pl.cdiv(W, TILE_W) * TILE_W


def _tile_pixels(H: int, W: int):
    """This program's tile: flat indices into the (H, W) inputs, flat
    indices into the tile-padded outputs, and the in-image mask."""
    k = jnp.arange(TILE_H * TILE_W, dtype=jnp.int32)
    y = pl.program_id(0) * TILE_H + k // TILE_W
    x = pl.program_id(1) * TILE_W + k % TILE_W
    valid = (y < H) & (x < W)
    return jnp.where(valid, y * W + x, 0), y * _padded(H, W)[1] + x, valid


def _load3(ref, idx, valid, n):
    return tuple(plgpu.load(ref.at[idx + c * n], mask=valid, other=0.0)
                 for c in range(3))


def _trace(step, t0, n_steps: int, relax_omega: float, extra_fail_floor):
    """Early-exit sphere trace of one tile.

    ``step(t) -> (d, active, step_len)`` evaluates the SDF at the current
    ray points.  Plain tracing (``relax_omega <= 1``) advances active rays by
    ``step_len``.  Over-relaxed tracing is the rule of the jnp loops in
    ``ops/raymarch.py``: step ``ω·step_len``, and when consecutive step
    spheres do not overlap roll back to the conservative step from the
    segment start (``extra_fail_floor(d_prev)``).  The loop ends when no ray
    of the tile is active or after ``n_steps`` iterations."""
    om = relax_omega
    if om <= 1.0:
        def cond(carry):
            i, _t, n_active = carry
            return (i < n_steps) & (n_active > 0.0)

        def body(carry):
            i, t, _n = carry
            _d, active, step_len = step(t)
            t = t + jnp.where(active, step_len, 0.0)
            return i + 1, t, jnp.sum(active.astype(jnp.float32))

        _, t, _ = jax.lax.while_loop(cond, body,
                                     (jnp.int32(0), t0, jnp.float32(1.0)))
        return t

    def cond(carry):
        i, _t, _dp, _sp, n_active = carry
        return (i < n_steps) & (n_active > 0.0)

    def body(carry):
        i, t, d_prev, step_prev, _n = carry
        d, active, step_len = step(t, omega=om)
        cons = extra_fail_floor(d_prev)
        fail = ((d + d_prev) < step_prev) & (step_prev > cons)
        active = active & ~fail
        delta = jnp.where(fail, cons - step_prev,
                          jnp.where(active, step_len, 0.0))
        new_step = jnp.where(fail, cons, jnp.where(active, step_len,
                                                   step_prev))
        new_dp = jnp.where(active, d, d_prev)
        going = active | fail
        return (i + 1, t + delta, new_dp, new_step,
                jnp.sum(going.astype(jnp.float32)))

    z = jnp.zeros_like(t0)
    _, t, _, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), t0, z, z, jnp.float32(1.0)))
    return t


def _make_march_kernel(H, W, params: RaymarchParams, counts):
    n = H * W

    def kernel(sc_ref, ro_ref, rd_ref, t_ref, hit_ref):
        sdf = _make_sdf(sc_ref, counts)
        idx, out_idx, valid = _tile_pixels(H, W)
        rox, roy, roz = _load3(ro_ref, idx, valid, n)
        rdx, rdy, rdz = _load3(rd_ref, idx, valid, n)

        def step(t, omega=1.0):
            d = sdf(rox + t * rdx, roy + t * rdy, roz + t * rdz)
            active = (d > params.hit_eps) & (t < params.max_dist)
            return d, active, omega * d

        # pixels outside the image start escaped
        t0 = jnp.where(valid, 0.0, params.max_dist)
        t = _trace(step, t0, params.max_steps, params.relax_omega,
                   lambda d_prev: d_prev)
        d_final = sdf(rox + t * rdx, roy + t * rdy, roz + t * rdz)
        hit = (d_final <= params.hit_eps * 4.0) & (t < params.max_dist)
        plgpu.store(t_ref.at[out_idx], t)
        plgpu.store(hit_ref.at[out_idx], hit.astype(jnp.float32))

    return kernel


def _make_shadow_kernel(H, W, params: RaymarchParams, counts):
    n = H * W
    min_step = _SHADOW_MIN_STEP

    def kernel(sc_ref, o_ref, ld_ref, dl_ref, vis_ref):
        sdf = _make_sdf(sc_ref, counts)
        idx, out_idx, valid = _tile_pixels(H, W)
        ox, oy, oz = _load3(o_ref, idx, valid, n)
        ldx, ldy, ldz = _load3(ld_ref, idx, valid, n)
        # zero for pixels outside the image: inactive from the start
        dist_l = plgpu.load(dl_ref.at[idx], mask=valid, other=0.0)

        def step(t, omega=1.0):
            d = sdf(ox + t * ldx, oy + t * ldy, oz + t * ldz)
            active = (d > params.hit_eps) & (t < dist_l - 0.02)
            return d, active, jnp.maximum(omega * d, min_step)

        t = _trace(step, jnp.zeros_like(dist_l), params.shadow_steps,
                   params.relax_omega,
                   lambda d_prev: jnp.maximum(d_prev, min_step))
        vis = (t >= dist_l - 0.03).astype(jnp.float32)
        plgpu.store(vis_ref.at[out_idx], vis)

    return kernel


def _call(kernel, H, W, n_out, name, interpret, *args):
    """Run ``kernel`` over the tile grid; outputs come back as (H, W)."""
    Hp, Wp = _padded(H, W)
    outs = pl.pallas_call(
        kernel,
        out_shape=tuple(jax.ShapeDtypeStruct((Hp * Wp,), jnp.float32)
                        for _ in range(n_out)),
        grid=(pl.cdiv(H, TILE_H), pl.cdiv(W, TILE_W)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)
    return tuple(o.reshape(Hp, Wp)[:H, :W] for o in outs)


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def march_triton(scene, ro, rd, params: RaymarchParams,
                 interpret: bool = False):
    """Primary sphere trace of (3, H, W) rays -> ``(t, hit)`` (H, W).

    Forward only: ``ops.raymarch.raymarch`` wraps it in the
    implicit-function adjoint."""
    H, W = ro.shape[-2:]
    kernel = _make_march_kernel(H, W, params, _counts(scene))
    t, hit = _call(kernel, H, W, 2, "sphere_march", interpret,
                   flatten_scene(scene), ro.reshape(-1), rd.reshape(-1))
    return t, hit > 0.5


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def shadow_triton(scene, p, n, light_p, params: RaymarchParams,
                  interpret: bool = False):
    """Shadow-ray visibility (H, W) from hit points ``p`` with normals ``n``
    toward light samples ``light_p`` (1 = unoccluded).  The shadow ray is
    built exactly as ``ops.raymarch._shadow_factor`` builds it; visibility is
    piecewise constant, so the result carries no gradient."""
    from ..raymarch import _shadow_ray

    # pallas_call has no differentiation rule: no tangent may reach it
    scene, p, n, light_p = jax.lax.stop_gradient((scene, p, n, light_p))
    H, W = p.shape[-2:]
    origin, ld, dist_l = _shadow_ray(p, n, light_p)
    kernel = _make_shadow_kernel(H, W, params, _counts(scene))
    (vis,) = _call(kernel, H, W, 1, "shadow_march", interpret,
                   flatten_scene(scene), origin.reshape(-1), ld.reshape(-1),
                   dist_l.reshape(-1))
    return vis
