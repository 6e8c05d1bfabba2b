#!/usr/bin/env python3
"""Benchmark harness — north-star metric (BASELINE.json):

    Mpixels/s/chip for SVGF forward+backward (5 à-trous iterations, 1080p).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "platform":
..., "device_kind": ..., "device_count": N}.  Runs on an NVIDIA GPU only
(exits non-zero otherwise).  Extra configs (BASELINE.md table) via --config;
--csv appends a timing dump (the analogue of the reference's build/out.csv
notebook feed, tile.ipynb cell 199).
"""

import argparse
import json
import sys
import time

import numpy as np


def _scene_inputs(H, W, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    color = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    variance = jnp.asarray((0.02 * rng.random((H, W))).astype(np.float32))
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    depth = jnp.asarray((0.3 + 0.5 * rng.random((H, W))).astype(np.float32))
    return color, variance, jnp.asarray(n), depth


def _chain_time(make_fn, x, n_lo=3, n_hi=18, reps=5):
    """Seconds/iteration via the slope between two chain lengths run inside
    one jit each (a forced scalar readback guarantees completion); the slope
    cancels the fixed per-call dispatch and readback cost.  Reports the
    MEDIAN of ``reps`` slopes.
    """
    f_lo, f_hi = make_fn(n_lo), make_fn(n_hi)
    float(f_lo(x))
    float(f_hi(x))
    slopes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f_lo(x))
        t1 = time.perf_counter()
        float(f_hi(x))
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (n_hi - n_lo))
    return sorted(slopes)[len(slopes) // 2]


def _spatial(params):
    import functools
    from raymarchdenoiser.ops.atrous import svgf_spatial_ref
    return functools.partial(svgf_spatial_ref, params=params,
                             detach_weights=True)


def bench_svgf_fwd_bwd(H=1080, W=1920, iterations=5, radius=2):
    """North-star config: SVGF fwd+bwd at 1080p, 5 levels."""
    import jax
    import jax.numpy as jnp
    from raymarchdenoiser.config import SVGFParams

    spatial = _spatial(SVGFParams(iterations=iterations, radius=radius))
    color, variance, normal, depth = _scene_inputs(H, W)

    def make_chain(n):
        @jax.jit
        def f(c):
            def loss(c):
                oc, ov = spatial(c, variance, normal, depth)
                return jnp.sum(oc ** 2) + jnp.sum(ov)

            def body(i, cv):
                _, g = jax.value_and_grad(loss)(cv)
                return g  # chain through the gradient: forces full fwd+bwd
            return jnp.sum(jax.lax.fori_loop(0, n, body, c))
        return f

    dt = _chain_time(make_chain, color)
    return H * W / dt / 1e6, dt


def bench_svgf_fwd(H=1080, W=1920, iterations=5, radius=2):
    """Forward-only SVGF, chain-slope timed."""
    import jax
    import jax.numpy as jnp
    from raymarchdenoiser.config import SVGFParams

    spatial = _spatial(SVGFParams(iterations=iterations, radius=radius))
    color, variance, normal, depth = _scene_inputs(H, W)

    def make_chain(n):
        @jax.jit
        def f(c):
            def body(i, c):
                oc, ov = spatial(c, variance, normal, depth)
                return oc
            return jnp.sum(jax.lax.fori_loop(0, n, body, c))
        return f

    dt = _chain_time(make_chain, color)
    return H * W / dt / 1e6, dt


def bench_raymarch(H=1080, W=1920):
    """Fused raymarch+G-buffer pass, chain-slope timed (the per-frame key
    split forms the dependency chain)."""
    import jax
    import jax.numpy as jnp
    from raymarchdenoiser.config import CameraParams, RaymarchParams
    from raymarchdenoiser.ops.raymarch import (
        cornell_scene, cornell_camera, render_gbuffer)

    cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    scene = cornell_scene()
    cam = cornell_camera()

    def make_chain(n):
        @jax.jit
        def f(key):
            def body(i, carry):
                key, acc = carry
                key, sub = jax.random.split(key)
                g = render_gbuffer(scene, cam, cam, sub, cam_cfg=cfg,
                                   params=rm)
                # consume every emitted plane: single-pixel reads would let
                # XLA slice the whole-image shading/normal/motion math down
                # to a few pixels and overstate the number
                use = (jnp.sum(g.render) + jnp.sum(g.normal)
                       + jnp.sum(g.depth) + jnp.sum(g.albedo)
                       + jnp.sum(g.motion))
                return (jax.random.fold_in(key, jnp.int32(use)), acc + use)
            _, acc = jax.lax.fori_loop(
                0, n, body, (key, jnp.float32(0.0)))
            return acc
        return f

    dt = _chain_time(make_chain, jax.random.PRNGKey(0), n_lo=2, n_hi=8)
    return H * W / dt / 1e6, dt


def bench_pipeline(H=1080, W=1920, iterations=5, spp=1, radius=2):
    """BASELINE config 3: fused raymarch + G-buffer -> temporal -> SVGF per
    frame (fwd path), measured as a frame chain (the temporal history is the
    natural dependency)."""
    import jax
    import jax.numpy as jnp
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.models.svgf import svgf_denoise_frame
    from raymarchdenoiser.ops.raymarch import cornell_scene, cornell_camera, render_gbuffer

    cam_cfg = CameraParams(width=W, height=H)
    rm = RaymarchParams()
    svgf = SVGFParams(iterations=iterations, radius=radius)
    scene = cornell_scene()
    cam = cornell_camera()

    def make_chain(n):
        @jax.jit
        def f(key):
            hist = History.zeros(H, W)

            def body(i, carry):
                hist, key, acc = carry
                key, sub = jax.random.split(key)
                g = render_gbuffer(scene, cam, cam, sub, cam_cfg=cam_cfg,
                                   params=rm, spp=spp)
                out, hist = svgf_denoise_frame(g, hist, params=svgf)
                # consume the denoised frame: only the history feeds the next
                # iteration, so without this XLA dead-code-eliminates every
                # à-trous level past the feedback level
                return (hist, key, acc + jnp.sum(out.denoised))

            hist, _, acc = jax.lax.fori_loop(0, n, body,
                                             (hist, key, jnp.float32(0.0)))
            return jnp.sum(hist.color) + acc
        return f

    import jax.random as jr
    key = jr.PRNGKey(0)
    dt = _chain_time(make_fn=make_chain, x=key, n_lo=2, n_hi=10)
    return H * W / dt / 1e6, dt


def bench_seq(H=512, W=512, iterations=5):
    """BASELINE config 2: Cornell-scale 512^2, full SVGF (temporal
    reprojection + variance guidance + 5-level à-trous), 8-frame sequence.
    Correctness of the sequence flow is tests/test_sequence.py; this
    measures per-frame throughput with the frame chain as the dependency
    (fresh MC noise per frame, constant small camera motion)."""
    import jax
    import jax.numpy as jnp
    from raymarchdenoiser.config import SVGFParams
    from raymarchdenoiser.gbuffer import GBuffer, History
    from raymarchdenoiser.models.svgf import svgf_denoise_frame

    params = SVGFParams(iterations=iterations)
    rng = np.random.default_rng(0)
    base = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    albedo = jnp.asarray(0.2 + 0.6 * rng.random((3, H, W), dtype=np.float32))
    n = rng.standard_normal((3, H, W)).astype(np.float32)
    n[2] += 3.0
    n /= np.sqrt((n ** 2).sum(0, keepdims=True))
    normal = jnp.asarray(n)
    depth = jnp.asarray((0.3 + 0.5 * rng.random((H, W))).astype(np.float32))
    motion = jnp.full((2, H, W), 1.3, jnp.float32)  # slow pan

    def make_chain(n_frames):
        @jax.jit
        def f(key):
            hist = History.zeros(H, W)

            def body(i, carry):
                hist, key, acc = carry
                key, sub = jax.random.split(key)
                noise = 0.3 * jax.random.normal(sub, base.shape)
                g = GBuffer(render=jnp.abs(base + noise), albedo=albedo,
                            normal=normal, depth=depth, motion=motion)
                out, hist = svgf_denoise_frame(g, hist, params=params)
                return (hist, key, acc + jnp.sum(out.denoised))

            hist, _, acc = jax.lax.fori_loop(
                0, n_frames, body, (hist, key, jnp.float32(0.0)))
            return jnp.sum(hist.color) + acc
        return f

    dt = _chain_time(make_chain, jax.random.PRNGKey(0), n_lo=2, n_hi=10)
    return H * W / dt / 1e6, dt


def bench_train(H=1080, W=1920, iterations=5, radius=2):
    """BASELINE config 4, measured end to end at 1080p: raymarch
    (implicit-function VJP) -> temporal -> SVGF -> pixel loss -> material
    gradients -> optax update."""
    import jax
    import jax.numpy as jnp
    import optax
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.models.pipeline import (
        make_train_step, init_train_state)
    from raymarchdenoiser.ops.raymarch import cornell_scene, cornell_camera

    scene = cornell_scene()
    cam = cornell_camera()
    rng = np.random.default_rng(0)
    target = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    opt = optax.adam(1e-2)
    step = make_train_step(
        scene, cam, target, opt,
        cam_cfg=CameraParams(width=W, height=H),
        rm_params=RaymarchParams(),
        svgf_params=SVGFParams(iterations=iterations, radius=radius))
    state0 = init_train_state(scene.materials.albedo, opt, H, W,
                              jax.random.PRNGKey(0))

    def make_chain(n):
        @jax.jit
        def f(state):
            def body(i, carry):
                state, acc = carry
                state, loss = step(state)
                return (state, acc + loss)
            state, acc = jax.lax.fori_loop(0, n, body,
                                           (state, jnp.float32(0.0)))
            return jnp.sum(state.albedo) + acc
        return f

    dt = _chain_time(make_chain, state0, n_lo=2, n_hi=8)
    return H * W / dt / 1e6, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="fwd_bwd_1080p",
                    choices=["fwd_bwd_1080p", "fwd_1080p", "raymarch_1080p",
                             "pipeline_1080p", "train_1080p", "seq_512"])
    ap.add_argument("--csv", default=None, help="append timings to CSV")
    ap.add_argument("--radius", type=int, default=2, choices=[1, 2],
                    help="à-trous tap radius (2: the classic SVGF 5x5 B3 "
                         "kernel; 1: the 3-tap binomial mode)")
    args = ap.parse_args()

    import jax
    from raymarchdenoiser.backend import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {dev.platform!r}")

    extra = {}
    rtag = "" if args.radius == 2 else f" r{args.radius}"
    if args.config == "fwd_bwd_1080p":
        value, dt = bench_svgf_fwd_bwd(radius=args.radius)
        metric = f"SVGF fwd+bwd 5-iter 1080p{rtag}"
    elif args.config == "fwd_1080p":
        value, dt = bench_svgf_fwd(radius=args.radius)
        metric = f"SVGF fwd 5-iter 1080p{rtag}"
    elif args.config == "pipeline_1080p":
        value, dt = bench_pipeline(radius=args.radius)
        extra["ms_per_frame"] = round(dt * 1e3, 3)
        metric = f"raymarch+temporal+SVGF frame 1080p{rtag}"
    elif args.config == "train_1080p":
        value, dt = bench_train(radius=args.radius)
        extra["ms_per_step"] = round(dt * 1e3, 3)
        metric = f"train step 1080p{rtag}"
    elif args.config == "seq_512":
        value, dt = bench_seq()
        extra["ms_per_frame"] = round(dt * 1e3, 3)
        metric = "full SVGF 512^2 8-frame sequence (temporal+spatial)"
    else:
        value, dt = bench_raymarch()
        metric = "raymarch+gbuffer 1080p"

    if args.csv:
        with open(args.csv, "a") as f:
            f.write(f"{metric}|{value:.3f}|{dt*1e3:.3f}\n")
    out = {
        "metric": "Mpixels/s/chip " + metric,
        "value": round(value, 3),
        "unit": "Mpix/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    out.update(extra)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
