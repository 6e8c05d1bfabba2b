"""Spatially sharded SVGF + raymarch pipeline (shard_map over a device mesh).

BASELINE.md config 5: image tiles sharded over ('y', 'x') mesh axes with a
halo exchange per à-trous level (``ppermute``; NCCL on GPUs), end-to-end
forward + backward.  Everything here runs *inside* ``jax.shard_map``; the
public entry points (:func:`svgf_spatial_sharded`,
:func:`make_sharded_pipeline`, :func:`make_sharded_train_step`) wrap it.

Correctness contract: identical results (up to fp reassociation) to the
single-device oracle (ops/atrous.py) for any mesh shape, enforced by global
coordinate masks — an out-of-tile tap that is inside a neighbor contributes
via the exchanged halo, an out-of-image tap contributes zero weight exactly
like the reference's ``inRange`` guard (src/filter.cu:37-38).

Differentiable: ``ppermute``'s transpose is ``ppermute`` with the inverse
permutation and the gather transposes to scatter-add, so ``jax.grad`` of a
shard_mapped pipeline yields the correctly halo-exchanged adjoint for free;
gradients of replicated leaves (materials) are psum'd by shard_map itself.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..gbuffer import GBuffer, History, luminance
from ..ops.atrous import _spline_taps, _EPS
from .halo import exchange_halo2d, tile_origin

REPL = P()
PLANE = P("y", "x")
PLANES = P(None, "y", "x")


def _named(mesh: Mesh, specs):
    """NamedShardings for a pytree of PartitionSpecs (or one spec)."""
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def _rows_cols(x, oy, ox, th, tw, h):
    """Slice a (…, th, tw) window at center offset (oy, ox) from a tile
    padded by h on both spatial axes (static offsets)."""
    return x[..., h + oy:h + oy + th, h + ox:h + ox + tw]


def _global_iota(ry, cx, th, tw):
    gy = ry + jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0)
    gx = cx + jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1)
    return gy, gx


def atrous_level_local(
    color_p, var_p, normal_p, depth_p, sden_p,   # halo-padded tiles (pad h)
    zgrad,                                        # (2, th, tw) center only
    ry, cx, Hg, Wg,                               # tile origin + global shape
    *, level: int, params: SVGFParams,
) -> Tuple[jax.Array, jax.Array]:
    """One à-trous level on a halo-padded local tile (oracle math, global
    masks).  ``h = radius * 2^level`` padding is assumed on both axes."""
    spacing = 1 << level
    r = params.radius
    h = r * spacing
    taps1d = _spline_taps(r)
    th, tw = zgrad.shape[-2:]
    gy, gx = _global_iota(ry, cx, th, tw)

    col_c = _rows_cols(color_p, 0, 0, th, tw, h)
    lum_p_full = 0.2126 * color_p[0] + 0.7152 * color_p[1] + 0.0722 * color_p[2]
    lum_c = _rows_cols(lum_p_full, 0, 0, th, tw, h)
    n_c = _rows_cols(normal_p, 0, 0, th, tw, h)
    z_c = _rows_cols(depth_p, 0, 0, th, tw, h)
    sden_c = _rows_cols(sden_p, 0, 0, th, tw, h)

    num_c = jnp.zeros_like(col_c)
    num_v = jnp.zeros_like(z_c)
    den = jnp.zeros_like(z_c)

    luma_only = (params.luma_only_from is not None
                 and level >= params.luma_only_from)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            oy, ox = dy * spacing, dx * spacing
            hw = taps1d[dy + r] * taps1d[dx + r]
            m = ((gy + oy >= 0) & (gy + oy < Hg)
                 & (gx + ox >= 0) & (gx + ox < Wg)).astype(z_c.dtype)

            l_q = _rows_cols(lum_p_full, oy, ox, th, tw, h)
            c_q = _rows_cols(color_p, oy, ox, th, tw, h)
            v_q = _rows_cols(var_p, oy, ox, th, tw, h)

            wl = -jnp.abs(lum_c - l_q) / sden_c
            if luma_only:
                # cheaper-filter deep-level mode (SVGFParams.luma_only_from):
                # mirror of ops.atrous.atrous_level_ref's luma branch
                w = hw * m * jnp.exp(wl)
            else:
                z_q = _rows_cols(depth_p, oy, ox, th, tw, h)
                n_q = _rows_cols(normal_p, oy, ox, th, tw, h)
                dz_den = params.sigma_depth * jnp.abs(
                    zgrad[0] * oy + zgrad[1] * ox) + _EPS
                wz = -jnp.abs(z_c - z_q) / dz_den
                ndot = jnp.maximum(jnp.sum(n_c * n_q, axis=0), 0.0)
                wn = jnp.power(jnp.maximum(ndot, 1e-20), params.sigma_normal)
                w = hw * m * jnp.exp(wz + wl) * wn
            # detached weights: matches the oracle's detach_weights=True
            w = lax.stop_gradient(w)

            num_c = num_c + w[None] * c_q
            num_v = num_v + (w * w) * v_q
            den = den + w

    den = jnp.maximum(den, _EPS)
    return num_c / den[None], num_v / (den * den)


def _variance_blur3x3_local(var, ry, cx, Hg, Wg):
    """3x3 gaussian blur with halo exchange + global-border renormalization
    (sharded analogue of ops.atrous.variance_blur3x3)."""
    vp = exchange_halo2d(var, 1)
    th, tw = var.shape
    gy, gx = _global_iota(ry, cx, th, tw)
    k1 = (0.25, 0.5, 0.25)
    num = jnp.zeros_like(var)
    dencnt = jnp.zeros_like(var)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = k1[dy + 1] * k1[dx + 1]
            m = ((gy + dy >= 0) & (gy + dy < Hg)
                 & (gx + dx >= 0) & (gx + dx < Wg)).astype(var.dtype)
            num = num + k * m * _rows_cols(vp, dy, dx, th, tw, 1)
            dencnt = dencnt + k * m
    # pixels entirely outside the global image (pad-and-mask tiles) have a
    # zero tap count; clamp so they yield 0, not NaN (bit-exact for in-image
    # pixels, whose own center tap guarantees dencnt >= 0.25)
    return num / jnp.maximum(dencnt, 1e-20)


def _zgrad_local(depth, ry, cx, Hg, Wg):
    """Central-difference depth gradient with halo exchange + one-sided
    borders (sharded analogue of ops.common.finite_diff_gradients)."""
    dp = exchange_halo2d(depth, 1)
    th, tw = depth.shape
    gy, gx = _global_iota(ry, cx, th, tw)
    up = _rows_cols(dp, -1, 0, th, tw, 1)
    dn = _rows_cols(dp, 1, 0, th, tw, 1)
    lf = _rows_cols(dp, 0, -1, th, tw, 1)
    rt = _rows_cols(dp, 0, 1, th, tw, 1)
    fwd_y, bwd_y = dn - depth, depth - up
    fwd_x, bwd_x = rt - depth, depth - lf
    dzdy = jnp.where(gy == 0, fwd_y,
                     jnp.where(gy == Hg - 1, bwd_y, 0.5 * (fwd_y + bwd_y)))
    dzdx = jnp.where(gx == 0, fwd_x,
                     jnp.where(gx == Wg - 1, bwd_x, 0.5 * (fwd_x + bwd_x)))
    return jnp.stack([dzdy, dzdx])


def svgf_spatial_local(
    color, variance, normal, depth,
    Hg: int, Wg: int,
    *, params: SVGFParams, return_feedback: bool = False,
):
    """Multi-level à-trous on local tiles (call inside shard_map): each level
    exchanges an ``h = radius * 2^level`` halo (multi-hop when the halo is
    wider than the tile) and masks taps by global coordinates, so results
    match the single-device oracle."""
    th, tw = depth.shape
    if params.pyramid_from is not None:
        raise NotImplementedError(
            "pyramid_from is an unsharded jnp-oracle experiment only")
    ry, cx = tile_origin((th, tw))
    zgrad = _zgrad_local(depth, ry, cx, Hg, Wg)
    c, v = color, variance
    feedback = color
    for lvl in range(params.iterations):
        h = params.radius * (1 << lvl)
        sden = params.sigma_color * jnp.sqrt(jnp.maximum(
            _variance_blur3x3_local(lax.stop_gradient(v), ry, cx, Hg, Wg), 0.0
        )) + _EPS
        c, v = atrous_level_local(
            exchange_halo2d(c, h), exchange_halo2d(v, h),
            exchange_halo2d(normal, h), exchange_halo2d(depth, h),
            exchange_halo2d(sden, h),
            zgrad, ry, cx, Hg, Wg, level=lvl, params=params,
        )
        if lvl + 1 == params.feedback_level:
            feedback = c
    if return_feedback:
        return c, v, feedback
    return c, v


# ---------------------------------------------------------------------------
# temporal accumulation on tiles (bounded-motion reprojection)
# ---------------------------------------------------------------------------

def _bilinear_gather_padded(plane_p, ys, xs, mh):
    """Bilinear sample a halo-padded (..., th+2mh, tw+2mh) tile at local
    coords (ys, xs) relative to the unpadded tile (clamped to the padded
    extent; validity handled by the caller)."""
    Hp, Wp = plane_p.shape[-2], plane_p.shape[-1]
    ys = ys + mh
    xs = xs + mh
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0i = jnp.clip(y0.astype(jnp.int32), 0, Hp - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, Wp - 1)
    y1i = jnp.clip(y0i + 1, 0, Hp - 1)
    x1i = jnp.clip(x0i + 1, 0, Wp - 1)
    flat = plane_p.reshape(plane_p.shape[:-2] + (Hp * Wp,))

    def at(yi, xi):
        return jnp.take(flat, yi * Wp + xi, axis=-1)

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x1i) * fx
    bot = at(y1i, x0i) * (1 - fx) + at(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def _neighborhood_minmax_local(color, ry, cx, Hg, Wg):
    """Separable per-pixel 3x3 min/max on halo-padded tiles (rows then cols;
    out-of-image taps dropped by ±inf substitution — the validity mask
    factors into per-row × per-col global-coordinate tests)."""
    cp = exchange_halo2d(color, 1)
    th, tw = color.shape[-2:]
    gy, gx = _global_iota(ry, cx, th, tw)

    rmin = jnp.full_like(cp[..., :th, :], jnp.inf)
    rmax = jnp.full_like(cp[..., :th, :], -jnp.inf)
    for dy in (-1, 0, 1):
        mrow = ((gy[:, :1] + dy >= 0) & (gy[:, :1] + dy < Hg))[None]
        s = cp[..., 1 + dy:1 + dy + th, :]
        rmin = jnp.minimum(rmin, jnp.where(mrow, s, jnp.inf))
        rmax = jnp.maximum(rmax, jnp.where(mrow, s, -jnp.inf))
    cmin = jnp.full_like(color, jnp.inf)
    cmax = jnp.full_like(color, -jnp.inf)
    for dx in (-1, 0, 1):
        mcol = ((gx[:1] + dx >= 0) & (gx[:1] + dx < Wg))[None]
        cmin = jnp.minimum(cmin, jnp.where(mcol, rmin[..., 1 + dx:1 + dx + tw],
                                           jnp.inf))
        cmax = jnp.maximum(cmax, jnp.where(mcol, rmax[..., 1 + dx:1 + dx + tw],
                                           -jnp.inf))
    return cmin, cmax


def _spatial_moments_local(lum, ry, cx, Hg, Wg, radius=3):
    """Separable 7x7 moment window on halo-padded tiles: out-of-image taps
    are zeros (halo exchange zero-fills), so the numerators are plain sums;
    the valid-tap count is the outer product of 1-D global-coordinate
    counts (mirror of ops.temporal.spatial_moments)."""
    lp = exchange_halo2d(lum, radius)
    th, tw = lum.shape
    gy, gx = _global_iota(ry, cx, th, tw)

    def winsum(xp):
        rows = jnp.zeros((th, xp.shape[-1]), lum.dtype)
        for d in range(-radius, radius + 1):
            rows = rows + xp[radius + d:radius + d + th, :]
        out = jnp.zeros((th, tw), lum.dtype)
        for d in range(-radius, radius + 1):
            out = out + rows[:, radius + d:radius + d + tw]
        return out

    gyf = gy.astype(lum.dtype)
    gxf = gx.astype(lum.dtype)
    # clamp to >= 1: out-of-image pixels (pad-and-mask tiles) would otherwise
    # produce zero or negative counts (in-image pixels always count their own
    # tap, so the clamp is bit-exact for them)
    cy = jnp.maximum(jnp.minimum(gyf, float(radius))
                     + jnp.minimum(Hg - 1 - gyf, float(radius)) + 1.0, 1.0)
    cxn = jnp.maximum(jnp.minimum(gxf, float(radius))
                      + jnp.minimum(Wg - 1 - gxf, float(radius)) + 1.0, 1.0)
    inv_cnt = 1.0 / (cy * cxn)
    return winsum(lp) * inv_cnt, winsum(lp * lp) * inv_cnt


def temporal_accumulate_local(
    gbuf: GBuffer, history: History, Hg: int, Wg: int,
    *, params: SVGFParams,
):
    """Tile-local temporal step (mirror of ops.temporal.temporal_accumulate).

    The disocclusion policy is shared with the single-device path:
    ``params.max_motion`` is the single source of truth, accepted inclusively
    (``|motion| <= max_motion``) in both.  Reprojection reads history through
    an exchanged halo of ``max_motion + 1`` pixels (the +1 covers the bilinear
    ceil tap); larger motion is treated as a disocclusion (history rejected),
    bounding the halo traffic per frame.  Parity at boundary motions is tested in
    tests/test_sharded.py.
    """
    if params.max_motion is None:
        raise ValueError(
            "sharded temporal accumulation requires bounded motion "
            "(SVGFParams.max_motion is None); unbounded gather-based "
            "reprojection cannot be halo-exchanged")
    th, tw = gbuf.depth.shape
    ry, cx = tile_origin((th, tw))
    color = gbuf.render
    motion = gbuf.motion if gbuf.motion is not None else jnp.zeros((2, th, tw), color.dtype)
    mm = params.max_motion
    mh = mm + 1  # halo width: max accepted motion + bilinear ceil tap

    iy = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0).astype(color.dtype)
    ix = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1).astype(color.dtype)
    ys = iy + motion[0]   # local coords of the history sample
    xs = ix + motion[1]
    gys = ys + ry
    gxs = xs + cx

    in_bounds = ((gys >= 0) & (gys <= Hg - 1) & (gxs >= 0) & (gxs <= Wg - 1)
                 & (jnp.abs(motion[0]) <= mm) & (jnp.abs(motion[1]) <= mm))

    hc = exchange_halo2d(history.color, mh)
    hm = exchange_halo2d(history.moments, mh)
    hl = exchange_halo2d(history.length, mh)
    hd = exchange_halo2d(history.prev_depth, mh)
    hn = exchange_halo2d(history.prev_normal, mh)

    prev_color = _bilinear_gather_padded(hc, ys, xs, mh)
    prev_moments = _bilinear_gather_padded(hm, ys, xs, mh)
    prev_len = _bilinear_gather_padded(hl, ys, xs, mh)
    prev_depth = _bilinear_gather_padded(hd, ys, xs, mh)
    prev_normal = _bilinear_gather_padded(hn, ys, xs, mh)

    integrated, variance, moments, n_new = _temporal_epilogue_sharded(
        gbuf, (prev_color, prev_moments, prev_len, prev_depth, prev_normal),
        in_bounds, ry, cx, Hg, Wg, params)
    new_history = History(
        color=integrated, moments=moments, length=n_new,
        prev_depth=gbuf.depth, prev_normal=gbuf.normal)
    return integrated, variance, new_history


def _temporal_epilogue_sharded(gbuf, planes, in_bounds, ry, cx, Hg, Wg,
                               params):
    """Shared tile-local temporal epilogue (mirror of the oracle's
    ``_temporal_epilogue``, with the 3x3 clamp and 7x7 moments on
    halo-exchanged tiles + global masks)."""
    prev_color, prev_moments, prev_len, prev_depth, prev_normal = planes
    color = gbuf.render
    depth_ok = jnp.abs(prev_depth - gbuf.depth) <= 0.1 * jnp.maximum(
        jnp.abs(gbuf.depth), 1e-3)
    ndot = jnp.sum(prev_normal * gbuf.normal, axis=0)
    valid = in_bounds & depth_ok & (ndot > 0.8) & (prev_len > 0)

    if params.history_clamp:
        cmin, cmax = _neighborhood_minmax_local(color, ry, cx, Hg, Wg)
        prev_color = jnp.clip(prev_color, cmin, cmax)

    n_prev = jnp.where(valid, prev_len, 0.0)
    n_new = n_prev + 1.0
    alpha = jnp.maximum(params.temporal_alpha, 1.0 / n_new)
    alpha_m = jnp.maximum(params.temporal_moments_alpha, 1.0 / n_new)

    integrated = jnp.where(
        valid[None], (1 - alpha)[None] * prev_color + alpha[None] * color, color)

    lum = luminance(color)
    cur_moments = jnp.stack([lum, lum * lum])
    moments = jnp.where(
        valid[None],
        (1 - alpha_m)[None] * prev_moments + alpha_m[None] * cur_moments,
        cur_moments)

    var_temporal = jnp.maximum(moments[1] - moments[0] ** 2, 0.0)
    sm1, sm2 = _spatial_moments_local(lum, ry, cx, Hg, Wg)
    var_spatial = jnp.maximum(sm2 - sm1 * sm1, 0.0)
    variance = jnp.where(n_new < params.variance_boost_frames, var_spatial,
                         var_temporal)
    return integrated, variance, moments, n_new


@functools.partial(jax.jit, static_argnames=("mesh", "params",
                                              "return_feedback"))
def svgf_spatial_sharded(
    color, variance, normal, depth,
    *, mesh: Mesh, params: SVGFParams = SVGFParams(),
    return_feedback: bool = False,
):
    """Sharded multi-level à-trous sweep over mesh axes ('y', 'x').

    Non-divisible global shapes are handled by pad-and-mask: the image is
    zero-padded up to mesh-divisible tiles, the tiles' global-coordinate masks (which always test the TRUE bounds)
    drop every tap beyond the real border exactly like the reference's
    ``inRange`` guard, and the padding is cropped off the outputs — so
    results are identical to the divisible case.
    """
    Hg, Wg = depth.shape
    ny = mesh.shape["y"]
    nx = mesh.shape["x"]
    Hp = -(-Hg // ny) * ny
    Wpad = -(-Wg // nx) * nx

    def pad(x):
        if Hp == Hg and Wpad == Wg:
            return x
        p = [(0, 0)] * (x.ndim - 2) + [(0, Hp - Hg), (0, Wpad - Wg)]
        return jnp.pad(x, p)

    fn = functools.partial(svgf_spatial_local, Hg=Hg, Wg=Wg, params=params,
                           return_feedback=return_feedback)
    out_specs = (PLANES, PLANE, PLANES) if return_feedback else (PLANES, PLANE)
    outs = shard_map(
        fn, mesh=mesh,
        in_specs=(PLANES, PLANE, PLANES, PLANE),
        out_specs=out_specs,
        check_vma=False,
    )(pad(color), pad(variance), pad(normal), pad(depth))
    if Hp == Hg and Wpad == Wg:
        return outs
    return tuple(o[..., :Hg, :Wg] for o in outs)


# ---------------------------------------------------------------------------
# full pipeline: render -> temporal -> spatial, sharded end to end
# ---------------------------------------------------------------------------

def pipeline_local(
    scene, camera, prev_camera, history: History, key,
    Hg: int, Wg: int,
    *, cam_cfg: CameraParams, rm_params: RaymarchParams,
    svgf_params: SVGFParams, spp: int = 1, demod: bool = True,
):
    """Per-device frame pipeline (call inside shard_map).

    The raymarch is embarrassingly parallel (each device renders its own
    pixel window, on the platform's march route, with the full frame's
    light-sample noise); temporal + spatial exchange halos with the
    neighbouring tiles, so the frame matches the single-device one.
    """
    from ..ops.raymarch import render_gbuffer_window
    from ..models.svgf import demodulate, remodulate

    th, tw = Hg // lax.axis_size("y"), Wg // lax.axis_size("x")
    ry, cx = tile_origin((th, tw))

    gbuf = render_gbuffer_window(
        scene, camera, prev_camera, key, ry, cx, th, tw,
        cam_cfg=cam_cfg, params=rm_params, spp=spp,
    )

    work = gbuf.replace(render=demodulate(gbuf.render, gbuf.albedo)) if demod else gbuf
    integrated, variance, new_history = temporal_accumulate_local(
        work, history, Hg, Wg, params=svgf_params)
    filtered, _v, feedback = svgf_spatial_local(
        integrated, variance, gbuf.normal, gbuf.depth, Hg, Wg,
        params=svgf_params, return_feedback=True)
    new_history = new_history.replace(color=feedback)
    denoised = remodulate(filtered, gbuf.albedo) if demod else filtered
    return gbuf.replace(denoised=denoised), new_history


def _data_size(mesh: Mesh) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("data", 1)


def _history_specs(mesh: Mesh) -> History:
    if _data_size(mesh) > 1:   # one history per 'data' slice
        return History(color=P("data", None, "y", "x"),
                       moments=P("data", None, "y", "x"),
                       length=P("data", "y", "x"),
                       prev_depth=P("data", "y", "x"),
                       prev_normal=P("data", None, "y", "x"))
    return History(color=PLANES, moments=PLANES, length=PLANE,
                   prev_depth=PLANE, prev_normal=PLANES)


def history_sharding(mesh: Mesh) -> History:
    """Where the sharded pipeline and train step keep the temporal history.

    ``jax.device_put`` a fresh ``History`` here (and the train step's
    replicated albedo, optimizer state and key to ``NamedSharding(mesh,
    P())``): then the first call compiles the program that every later call,
    fed the previous call's outputs, reuses."""
    return _named(mesh, _history_specs(mesh))


def make_sharded_pipeline(
    mesh: Mesh, Hg: int, Wg: int,
    *, cam_cfg: CameraParams, rm_params: RaymarchParams,
    svgf_params: SVGFParams, spp: int = 1,
):
    """Build a jitted sharded (render + denoise) frame function
    ``(scene, camera, prev_camera, history, key) -> (gbuffer, history)``.

    Scene/cameras/key are replicated; G-buffer planes and history are
    sharded P('y','x') on their trailing two axes.  The global shape must
    divide over the ('y', 'x') mesh.
    """
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    if Hg % ny or Wg % nx:
        raise ValueError(f"({Hg}, {Wg}) does not tile over the ({ny}, {nx}) "
                         f"('y', 'x') mesh")
    gb_specs = GBuffer(render=PLANES, albedo=PLANES, normal=PLANES,
                       depth=PLANE, motion=PLANES, denoised=PLANES)
    hist_specs = _history_specs(mesh)
    fn = functools.partial(
        pipeline_local, Hg=Hg, Wg=Wg, cam_cfg=cam_cfg,
        rm_params=rm_params, svgf_params=svgf_params, spp=spp)
    in_specs = (REPL, REPL, REPL, hist_specs, REPL)
    out_specs = (gb_specs, hist_specs)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False),
                   in_shardings=_named(mesh, in_specs),
                   out_shardings=_named(mesh, out_specs))


def make_sharded_train_step(
    mesh: Mesh, base_scene, camera, target, optimizer,
    *, cam_cfg: CameraParams, rm_params: RaymarchParams,
    svgf_params: SVGFParams,
):
    """Sharded version of models.pipeline.make_train_step: loss + grads of
    the material table with the image pipeline sharded over ('y','x') and —
    when the mesh has a non-trivial 'data' axis — Monte-Carlo samples
    data-parallel across it.

    The albedo table is replicated; shard_map transposes the replicated->
    sharded broadcast into a psum of per-device gradient contributions over
    ALL mesh axes — the gradient all-reduce (SURVEY.md §5 backend row).
    With data parallelism, each 'data' slice renders the frame with an
    independent noise key and keeps its own temporal history (leading batch
    axis sharded P('data')); the loss is the pmean of the slice losses, so
    the material gradient averages over ``data_size`` independent MC
    estimates per step.

    Returns ``train_step(albedo, opt_state, history, key) -> (albedo,
    opt_state, history, key, loss)``.
    """
    nd = _data_size(mesh)
    hist_specs = _history_specs(mesh)

    def local_loss(albedo, history, key, target_tile):
        scene = base_scene.replace(
            materials=base_scene.materials.replace(albedo=albedo))
        if nd > 1:
            history = jax.tree.map(lambda x: x[0], history)
            key = jax.random.fold_in(key, lax.axis_index("data"))
        out, new_hist = pipeline_local(
            scene, camera, None, history, key,
            target.shape[-2], target.shape[-1],
            cam_cfg=cam_cfg, rm_params=rm_params, svgf_params=svgf_params)
        # mean over the full image = psum of tile sums / global pixel count
        sse = jnp.sum((out.denoised - target_tile) ** 2)
        loss = lax.psum(lax.psum(sse, "y"), "x") / (3 * target.shape[-2] * target.shape[-1])
        if nd > 1:
            loss = lax.pmean(loss, "data")
            new_hist = jax.tree.map(lambda x: x[None], new_hist)
        return loss, new_hist

    sharded_loss = shard_map(
        local_loss, mesh=mesh,
        in_specs=(REPL, hist_specs, REPL, PLANES),
        out_specs=(REPL, hist_specs),
        check_vma=False,
    )

    repl, hist = _named(mesh, REPL), _named(mesh, hist_specs)

    @functools.partial(jax.jit, in_shardings=(repl, repl, hist, repl),
                       out_shardings=(repl, repl, hist, repl, repl))
    def train_step(albedo, opt_state, history, key):
        key, sub = jax.random.split(key)
        (loss, new_hist), grads = jax.value_and_grad(
            sharded_loss, has_aux=True)(albedo, history, sub, target)
        updates, opt_state = optimizer.update(grads, opt_state, albedo)
        albedo = jnp.clip(optax.apply_updates(albedo, updates), 0.0, 1.0)
        return albedo, opt_state, new_hist, key, loss

    return train_step
