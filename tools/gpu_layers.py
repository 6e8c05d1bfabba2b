#!/usr/bin/env python3
"""Per-layer times of the 1080p frame on the GPU, and the march route A/B.

Run on a machine with one NVIDIA GPU:

    python tools/gpu_layers.py [--size 1080p] [--reps 10]

Prints one line per measurement (median and min of ``--reps`` runs after two
warm-up calls, each ending in ``block_until_ready``) and, last, one JSON
object with every number.  What it measures:

* the primary and shadow marches: Triton kernel vs the jnp ``fori_loop``
  (with the hit-mask agreement and the |Δt| on shared hits);
* ``render_gbuffer`` and the whole frame (render -> SVGF with history) with
  the march on either route;
* one à-trous level, forward and forward+backward, at levels 0 and 4, with
  its share of the byte roofline (minimal plane traffic over 3.35 TB/s);
* the temporal step, bounded-shift (``max_motion=6``) vs gather
  (``max_motion=None``), forward and with the gradient w.r.t. the render.

Forcing the jnp march on the GPU patches ``march_route`` in
``ops/raymarch.py`` for this process only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _time(fn, *args, reps=10):
    import jax
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3, float(np.min(ts)) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="1080p", choices=["1080p", "4k", "256"])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from raymarchdenoiser.backend import enable_compile_cache
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("tools/gpu_layers.py measures the GPU; no GPU found")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)

    import importlib
    # the module (``raymarchdenoiser.ops.raymarch`` is also a function name)
    rmod = importlib.import_module("raymarchdenoiser.ops.raymarch")
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.models.svgf import svgf_denoise_frame
    from raymarchdenoiser.ops.atrous import atrous_level_ref
    from raymarchdenoiser.ops.common import finite_diff_gradients
    from raymarchdenoiser.ops.pallas.march_triton import (march_triton,
                                                           shadow_triton)
    from raymarchdenoiser.ops.temporal import temporal_accumulate
    from raymarchdenoiser.io.generate import orbit_camera

    H, W = {"1080p": (1080, 1920), "4k": (2160, 3840), "256": (256, 256)}[
        args.size]
    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    sv = SVGFParams()
    scene = rmod.cornell_scene()
    cam, prev = orbit_camera(0.1), orbit_camera(0.0)
    res = {"card": card.strip(), "size": [H, W],
           "device_kind": jax.devices()[0].device_kind}

    def report(name, ms):
        res[name] = {"median_ms": ms[0], "min_ms": ms[1]}
        print(f"{name}: median {ms[0]:.3f} ms  min {ms[1]:.3f} ms", flush=True)

    # --- march parity and A/B ------------------------------------------
    ro, rd, _ = rmod.camera_rays(cam, cfg)
    with jax.default_matmul_precision("highest"):
        t_k, h_k = march_triton(scene, ro, rd, rm)
        t_j, h_j = jax.jit(rmod._raymarch_loop, static_argnums=3)(
            scene, ro, rd, rm)
    h_k, h_j = np.asarray(h_k), np.asarray(h_j)
    both = h_k & h_j
    dt = np.abs(np.asarray(t_k) - np.asarray(t_j))[both]
    res["march_parity"] = {
        "hit_agree": float((h_k == h_j).mean()),
        "dt_p99": float(np.percentile(dt, 99)), "dt_max": float(dt.max())}
    print("march parity:", res["march_parity"], flush=True)
    report("march_triton", _time(lambda a, b: march_triton(scene, a, b, rm),
                                 ro, rd, reps=args.reps))
    loop = jax.jit(lambda a, b: rmod._raymarch_loop(scene, a, b, rm))
    report("march_jnp", _time(loop, ro, rd, reps=args.reps))

    p = ro + t_j[None] * rd
    n = rmod.sdf_normal(scene, p)
    lp = rmod.sample_light(scene, jax.random.PRNGKey(1), (H, W))
    v_k = np.asarray(shadow_triton(scene, p, n, lp, rm))
    v_j = np.asarray(jax.jit(rmod._shadow_factor, static_argnums=4)(
        scene, p, n, lp, rm))
    res["shadow_parity"] = {"vis_agree": float((v_k == v_j).mean())}
    print("shadow parity:", res["shadow_parity"], flush=True)
    report("shadow_triton", _time(
        lambda a, b, c: shadow_triton(scene, a, b, c, rm), p, n, lp,
        reps=args.reps))
    report("shadow_jnp", _time(
        jax.jit(lambda a, b, c: rmod._shadow_factor(scene, a, b, c, rm)),
        p, n, lp, reps=args.reps))

    def frame_fns():
        render = jax.jit(lambda k: rmod.render_gbuffer_window(
            scene, cam, prev, k, 0, 0, H, W, cam_cfg=cfg, params=rm))

        @jax.jit
        def frame(k, hist):
            g = rmod.render_gbuffer_window(scene, cam, prev, k, 0, 0, H, W,
                                           cam_cfg=cfg, params=rm)
            return svgf_denoise_frame(g, hist, params=sv)
        return render, frame

    key = jax.random.PRNGKey(0)
    hist0 = svgf_denoise_frame(
        jax.jit(lambda k: rmod.render_gbuffer_window(
            scene, prev, None, k, 0, 0, H, W, cam_cfg=cfg, params=rm))(key),
        History.zeros(H, W), params=sv)[1]
    real_route = rmod.march_route
    for route in ("triton", "jnp", "triton"):
        rmod.march_route = (lambda r=route: r)
        render, frame = frame_fns()
        report(f"render_gbuffer_{route}", _time(render, key, reps=args.reps))
        report(f"frame_{route}", _time(frame, key, hist0, reps=args.reps))
    rmod.march_route = real_route

    # --- à-trous levels -------------------------------------------------
    g = jax.jit(lambda k: rmod.render_gbuffer_window(
        scene, cam, prev, k, 0, 0, H, W, cam_cfg=cfg, params=rm))(key)
    color = g.render
    var = jnp.full((H, W), 0.01, jnp.float32) + 0.01 * color[0]
    zgrad = finite_diff_gradients(g.depth)
    plane = H * W * 4
    # every plane is an argument: a plane closed over would be a constant
    # that XLA may fold at compile time
    guides = (g.normal, g.depth, zgrad)
    for lvl in (0, 4):
        fwd = jax.jit(lambda c, v, n, z, zg, l=lvl: atrous_level_ref(
            c, v, n, z, zg, level=l, params=sv))

        def loss(c, v, n, z, zg, l=lvl):
            oc, ov = atrous_level_ref(c, v, n, z, zg, level=l, params=sv)
            return jnp.sum(oc * oc) + jnp.sum(ov)
        fb = jax.jit(jax.grad(loss, argnums=(0, 1)))
        f_ms = _time(fwd, color, var, *guides, reps=args.reps)
        fb_ms = _time(fb, color, var, *guides, reps=args.reps)
        report(f"atrous_l{lvl}_fwd", f_ms)
        report(f"atrous_l{lvl}_fwd_bwd", fb_ms)
        # minimal traffic: color 3, var 1, normal 3, depth 1, zgrad 2 in;
        # color 3 + var 1 out.  The backward re-reads the 10 inputs, reads
        # 4 cotangent planes and writes 4 gradient planes.
        fwd_floor = 14 * plane / HBM_BYTES_PER_S * 1e3
        bwd_floor = 18 * plane / HBM_BYTES_PER_S * 1e3
        res[f"atrous_l{lvl}_fwd"]["roofline_share"] = fwd_floor / f_ms[0]
        res[f"atrous_l{lvl}_fwd_bwd"]["roofline_share"] = (
            (fwd_floor + bwd_floor) / fb_ms[0])
        print(f"  level {lvl} roofline share: fwd "
              f"{fwd_floor / f_ms[0]:.3f}, fwd+bwd "
              f"{(fwd_floor + bwd_floor) / fb_ms[0]:.3f}", flush=True)

    # --- temporal step: bounded shift vs gather -------------------------
    for mm in (6, None):
        p_t = SVGFParams(max_motion=mm)
        tag = "shift6" if mm is not None else "gather"
        fwd = jax.jit(lambda gg, hh, pp=p_t: temporal_accumulate(
            gg, hh, params=pp))

        def tloss(r, gg, hh, pp=p_t):
            i, v, nh = temporal_accumulate(gg.replace(render=r), hh,
                                           params=pp)
            return jnp.sum(i * i) + jnp.sum(v)
        # gradient w.r.t. the render, as in the train step; the G-buffer
        # and history are arguments, not constants XLA could fold
        report(f"temporal_{tag}_fwd", _time(fwd, g, hist0, reps=args.reps))
        report(f"temporal_{tag}_grad", _time(jax.jit(jax.grad(tloss)),
                                             g.render, g, hist0,
                                             reps=args.reps))
    stats = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
