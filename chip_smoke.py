#!/usr/bin/env python3
"""Smoke test of the product path on an NVIDIA GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: the sharded path only

One card runs, in one process:

1. frame  -- 4 animated 1080p Cornell frames, ``render_gbuffer`` ->
   ``svgf_denoise_frame``, history carried from frame to frame;
2. train  -- 3 steps of the 1080p ``make_train_step`` with ``optax.adam``;
3. parity -- the Triton march and shadow kernels against the jnp loops at
   1080p, and the temporal step and the SVGF sweep on the GPU against the
   same calls on the CPU at 512x512;
4. tests  -- the ``gpu``-marked tests (tests/test_gpu.py), in-process.

``--multi`` runs a 4K ``make_sharded_pipeline`` frame and a 1080p
``make_sharded_train_step`` on a 4-card mesh, each against the one-card
result.

Each phase prints one JSON line (first-call seconds, which include the
compile; steady-state ms; the process's peak device memory so far; its
parity numbers).  The card's name and power limit come first.  The last line,
``{"ok": true, "device": {...}}``, is printed only when every phase passed;
without a GPU, or without the rest of the repository, the script exits
non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _peak_bytes():
    import jax
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def _report(phase, first_s, steady_ms, parity, **extra):
    line = {"phase": phase, "compile_s": round(first_s, 3),
            "steady_ms": None if steady_ms is None else round(steady_ms, 3),
            "peak_bytes_in_use": _peak_bytes(), "parity": parity}
    line.update(extra)
    print(json.dumps(line), flush=True)


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _rel_err(got, want):
    """max |got - want| over max |want| (0 for an all-zero reference)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def frame_phase(H=1080, W=1920, frames=4):
    """``frames`` animated frames, history carried; outputs finite."""
    import jax
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.io.generate import orbit_camera
    from raymarchdenoiser.models.svgf import svgf_denoise_frame
    from raymarchdenoiser.ops.raymarch import cornell_scene, render_gbuffer

    cfg, rm, sv = CameraParams(width=W, height=H), RaymarchParams(), SVGFParams()
    scene = cornell_scene()
    cams = [orbit_camera(i / (2 * frames)) for i in range(frames)]
    keys = jax.random.split(jax.random.PRNGKey(0), frames)
    hist = History.zeros(H, W)

    def frame(i, hist):
        g = render_gbuffer(scene, cams[i], cams[max(i - 1, 0)], keys[i],
                           cam_cfg=cfg, params=rm)
        return svgf_denoise_frame(g, hist, params=sv)

    times = []
    for i in range(frames):
        (out, hist), dt = _timed(frame, i, hist)
        times.append(dt)
        den = np.asarray(out.denoised)
        check(den.shape == (3, H, W), f"frame {i}: shape {den.shape}")
        check(np.isfinite(den).all(), f"frame {i}: non-finite output")
    n_max = float(hist.length.max())
    # (lengths are bilinearly reprojected, so not exact integers)
    check(abs(n_max - frames) < 1e-3,
          f"history not carried: max length {n_max}")
    _report("frame", times[0], statistics.median(times[1:]) * 1e3, None,
            frames=frames, size=[H, W],
            denoised_mean=float(den.mean()), history_max_length=n_max)


def train_phase(H=1080, W=1920, steps=3):
    """``steps`` Adam steps of BASELINE config 4: finite loss, albedo in
    [0, 1] and moved."""
    import jax
    import jax.numpy as jnp
    import optax
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.models.pipeline import (init_train_state,
                                                  make_train_step)
    from raymarchdenoiser.ops.raymarch import cornell_camera, cornell_scene

    scene = cornell_scene()
    target = jnp.asarray(np.random.default_rng(0).random((3, H, W),
                                                         dtype=np.float32))
    opt = optax.adam(1e-2)
    step = make_train_step(scene, cornell_camera(), target, opt,
                           cam_cfg=CameraParams(width=W, height=H),
                           rm_params=RaymarchParams(),
                           svgf_params=SVGFParams())
    state = init_train_state(scene.materials.albedo, opt, H, W,
                             jax.random.PRNGKey(0))
    times, losses = [], []
    for _ in range(steps):
        (state, loss), dt = _timed(step, state)
        times.append(dt)
        losses.append(float(loss))
    albedo = np.asarray(state.albedo)
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(albedo.min() >= 0.0 and albedo.max() <= 1.0,
          f"albedo left [0, 1]: {albedo.min()} .. {albedo.max()}")
    check(np.abs(albedo - np.asarray(scene.materials.albedo)).max() > 0,
          "albedo did not move")
    _report("train", times[0], statistics.median(times[1:]) * 1e3, None,
            steps=steps, size=[H, W], losses=losses)


def parity_phase(H=1080, W=1920, Hs=512, Ws=512):
    """The Triton marches against the jnp loops on the GPU; the temporal
    step and the SVGF sweep on the GPU against the CPU.

    Tolerances (the whole path is f32 and has no matrix product; the
    comparison runs under ``default_matmul_precision("highest")`` all the
    same, so a future einsum cannot drop to TF32 unnoticed):

    * march: both routes apply the same f32 update to each ray, so hit
      masks agree on >= 99.9 % of pixels and shared hits lie within
      ``hit_eps`` (1e-3) of each other -- the distance at which either
      route calls the ray converged;
    * shadow visibility agrees on >= 99.9 % of pixels (a visibility flip
      needs a ray that ends within rounding of ``dist_l - 0.03``);
    * temporal step: max error <= 1e-4 of the plane's largest value -- adds
      and multiplies only; the GPU contracts a*b+c into FMAs (about one ulp
      per operation), and m2 - m1^2 cancels in the variance;
    * SVGF sweep (5 levels): <= 1e-3 of the largest value -- ``exp`` differs
      by an ulp or two between the two libraries, ``pow(ndot, 128)`` scales
      a 1-ulp error of ndot by 128 (about 1e-5 relative in a weight), and
      five levels compound it.
    """
    import jax
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.io.generate import orbit_camera
    from raymarchdenoiser.models.svgf import demodulate, svgf_denoise_frame
    from raymarchdenoiser.ops.atrous import svgf_spatial_ref
    from raymarchdenoiser.ops.pallas.march_triton import (march_triton,
                                                           shadow_triton)
    from raymarchdenoiser.ops.raymarch import (_raymarch_loop, _shadow_factor,
                                               camera_rays, cornell_scene,
                                               render_gbuffer, sample_light,
                                               sdf_normal)
    from raymarchdenoiser.ops.temporal import temporal_accumulate

    rm, sv = RaymarchParams(), SVGFParams()
    scene = cornell_scene()
    cpu = jax.devices("cpu")[0]
    out = {}
    t_start = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ro, rd, _ = camera_rays(orbit_camera(0.25),
                                CameraParams(width=W, height=H))
        t_k, h_k = march_triton(scene, ro, rd, rm)
        t_j, h_j = jax.jit(_raymarch_loop, static_argnums=3)(scene, ro, rd,
                                                             rm)
        h_k, h_j = np.asarray(h_k), np.asarray(h_j)
        dt = np.abs(np.asarray(t_k) - np.asarray(t_j))[h_k & h_j]
        out["march_hit_agree"] = float((h_k == h_j).mean())
        out["march_dt_max"] = float(dt.max(initial=0.0))
        check(out["march_hit_agree"] >= 0.999, f"march hits: {out}")
        check(out["march_dt_max"] <= rm.hit_eps, f"march |dt|: {out}")

        p = ro + t_j[None] * rd
        n = sdf_normal(scene, p, rm.normal_eps)
        lp = sample_light(scene, jax.random.PRNGKey(1), (H, W))
        v_k = np.asarray(shadow_triton(scene, p, n, lp, rm))
        v_j = np.asarray(jax.jit(_shadow_factor, static_argnums=4)(
            scene, p, n, lp, rm))
        out["shadow_vis_agree"] = float((v_k == v_j).mean())
        check(out["shadow_vis_agree"] >= 0.999, f"shadow: {out}")

        # temporal + SVGF: two rendered 512^2 frames, history from the first
        cfg = CameraParams(width=Ws, height=Hs)
        c0, c1 = orbit_camera(0.0), orbit_camera(0.05)
        g0 = render_gbuffer(scene, c0, c0, jax.random.PRNGKey(2),
                            cam_cfg=cfg, params=rm)
        g1 = render_gbuffer(scene, c1, c0, jax.random.PRNGKey(3),
                            cam_cfg=cfg, params=rm)
        _, hist = svgf_denoise_frame(g0, History.zeros(Hs, Ws), params=sv)
        work = g1.replace(render=demodulate(g1.render, g1.albedo))
        on_cpu = jax.device_put((work, hist), cpu)
        tg = temporal_accumulate(work, hist, params=sv)
        tc = temporal_accumulate(*on_cpu, params=sv)
        out["temporal_err"] = max(
            _rel_err(a, b) for a, b in zip(jax.tree.leaves(tg),
                                           jax.tree.leaves(tc)))
        check(out["temporal_err"] <= 1e-4, f"temporal: {out}")

        args_cpu = (tc[0], tc[1], on_cpu[0].normal, on_cpu[0].depth)
        sg = svgf_spatial_ref(*jax.device_put(args_cpu, jax.devices()[0]),
                              params=sv)
        sc = svgf_spatial_ref(*args_cpu, params=sv)
        out["svgf_err"] = max(_rel_err(a, b) for a, b in zip(sg, sc))
        check(out["svgf_err"] <= 1e-3, f"svgf: {out}")
    _report("parity", time.perf_counter() - t_start, None, out,
            size=[H, W], small_size=[Hs, Ws])


def tests_phase():
    """The ``gpu``-marked tests, in this process (they must all run)."""
    import pytest

    class Tally:
        passed = 0
        skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            if report.skipped:
                self.skipped += 1

    os.environ["RDT_TEST_GPU"] = "1"
    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[tally])
    check(rc == 0, f"gpu tests failed (pytest exit code {rc})")
    check(tally.passed > 0 and tally.skipped == 0,
          f"gpu tests: {tally.passed} passed, {tally.skipped} skipped")
    _report("tests", time.perf_counter() - t0, None, None,
            passed=tally.passed)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def multi_phase(H=2160, W=3840, Ht=1080, Wt=1920, n_dev=4):
    """The sharded 4K frame and the sharded 1080p train step on an
    ``n_dev``-card mesh, each against the one-card result.

    Tiles render the full frame's light-sample noise and every stencil
    reads its halo, so the sharded frame is the one-card frame up to
    rounding: at most 1e-4 of the pixels may differ by more than 1e-3 of
    the image's largest value (a silhouette ray whose direction rounds
    differently can flip its hit).  The train step's losses agree to 1e-4
    relative, and the Adam-updated albedo to 1e-3.
    """
    import jax
    import jax.numpy as jnp
    import optax
    from raymarchdenoiser.config import CameraParams, RaymarchParams, SVGFParams
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.io.generate import orbit_camera
    from raymarchdenoiser.models.pipeline import (init_train_state,
                                                  make_train_step,
                                                  render_and_denoise)
    from raymarchdenoiser.ops.raymarch import cornell_camera, cornell_scene
    from raymarchdenoiser.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec
    from raymarchdenoiser.parallel.sharded import (history_sharding,
                                                   make_sharded_pipeline,
                                                   make_sharded_train_step)

    check(len(jax.devices()) >= n_dev,
          f"--multi needs {n_dev} devices, found {len(jax.devices())}")
    mesh = make_mesh(n_dev)
    rm, sv = RaymarchParams(), SVGFParams()
    scene = cornell_scene()

    # --- 4K frame, two frames with history --------------------------------
    cfg = CameraParams(width=W, height=H)
    kw = dict(cam_cfg=cfg, rm_params=rm, svgf_params=sv)
    sharded = make_sharded_pipeline(mesh, H, W, **kw)
    cams = [orbit_camera(0.0), orbit_camera(0.05)]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    h1 = History.zeros(H, W)
    hs = jax.device_put(h1, history_sharding(mesh))
    t_sh = []
    for i in range(2):
        prev = cams[max(i - 1, 0)]
        # the one-card frame finishes before the sharded one is timed
        g1, h1 = jax.block_until_ready(
            render_and_denoise(scene, cams[i], prev, h1, keys[i], **kw))
        (gs, hs), dt = _timed(sharded, scene, cams[i], prev, hs, keys[i])
        t_sh.append(dt)
    devices = {s.device for s in gs.denoised.addressable_shards}
    check(len(devices) == n_dev, f"tiles on {len(devices)} devices")
    d1, ds = np.asarray(g1.denoised), np.asarray(gs.denoised)
    check(np.isfinite(ds).all(), "sharded frame: non-finite output")
    scale = np.abs(d1).max()
    bad = float((np.abs(ds - d1) > 1e-3 * scale).mean())
    frame_par = {"frac_pixels_over_1e-3": bad,
                 "mean_abs_err": float(np.abs(ds - d1).mean()),
                 "max_rel_err": _rel_err(ds, d1)}
    check(bad <= 1e-4, f"sharded frame vs one card: {frame_par}")
    _report("multi_frame", t_sh[0], t_sh[1] * 1e3, frame_par, size=[H, W],
            mesh=list(mesh.devices.shape), devices=len(devices))

    # --- 1080p train step ---------------------------------------------------
    kw = dict(cam_cfg=CameraParams(width=Wt, height=Ht), rm_params=rm,
              svgf_params=sv)
    target = jnp.asarray(np.random.default_rng(0).random((3, Ht, Wt),
                                                         dtype=np.float32))
    opt = optax.adam(1e-2)
    step1 = make_train_step(scene, cornell_camera(), target, opt, **kw)
    step4 = make_sharded_train_step(mesh, scene, cornell_camera(), target,
                                    opt, **kw)
    st = init_train_state(scene.materials.albedo, opt, Ht, Wt,
                          jax.random.PRNGKey(0))
    repl = NamedSharding(mesh, PartitionSpec())
    carry = jax.device_put((st.albedo, st.opt_state, st.history, st.key),
                           (repl, repl, history_sharding(mesh), repl))
    l1s, l4s, t4 = [], [], []
    for _ in range(2):
        st, l1 = jax.block_until_ready(step1(st))
        (*carry, l4), dt = _timed(step4, *carry)
        t4.append(dt)
        l1s.append(float(l1))
        l4s.append(float(l4))
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l1s, l4s))
    alb_err = float(np.abs(np.asarray(carry[0])
                           - np.asarray(st.albedo)).max())
    train_par = {"loss_rel_err": loss_err, "albedo_max_abs_err": alb_err,
                 "losses_one_card": l1s, "losses_sharded": l4s}
    check(all(np.isfinite(l4s)), f"sharded train: {train_par}")
    check(loss_err <= 1e-4 and alb_err <= 1e-3,
          f"sharded train vs one card: {train_par}")
    _report("multi_train", t4[0], t4[1] * 1e3, train_par, size=[Ht, Wt])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax
    from raymarchdenoiser.backend import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    if args.multi:
        multi_phase()
    else:
        frame_phase()
        train_phase()
        parity_phase()
        tests_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
