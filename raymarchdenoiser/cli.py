"""Command-line entry point: ``python -m raymarchdenoiser.cli``.

Mirrors the reference CLI (``src/main.cpp:12-40``): ``-t [regex]`` runs the
registered cases (all by default), ``-h`` prints usage, unknown options go to
stderr.  The registered cases cover the reference's set (``src/test.cu:51-90``:
FILTER_BASELINE / FILTER_TILED / DEVICE_STATS / IMAGE) plus the new
framework's pipelines, each printing per-case milliseconds like the reference
runner — plus Mpix/s where meaningful.
"""

from __future__ import annotations

import sys

import numpy as np

from . import testing
from .testing import case_


def _register_builtin_cases():
    import jax
    import jax.numpy as jnp

    from .config import CameraParams, SVGFParams
    from .utils.timing import time_fn, mpix_per_s, print_device_properties

    H, W = (1080, 1920)  # reference test buffers are full-HD (test.cu:64-66)

    def _rand_planes(h, w):
        rng = np.random.default_rng(0)
        color = jnp.asarray(rng.random((3, h, w), dtype=np.float32))
        variance = jnp.asarray((0.02 * rng.random((h, w))).astype(np.float32))
        n = rng.standard_normal((3, h, w)).astype(np.float32)
        n[2] += 3.0
        n /= np.sqrt((n ** 2).sum(0, keepdims=True))
        depth = jnp.asarray((0.3 + 0.5 * rng.random((h, w))).astype(np.float32))
        return color, variance, jnp.asarray(n), depth

    @case_("FILTER_BASELINE")
    def filter_baseline():
        # reference: 1920x1080, radius=2, depth=1 average filter (test.cu:68-78)
        from .ops.boxfilter import box_filter
        x = _rand_planes(H, W)[0]
        dt, _ = time_fn(lambda: box_filter(x, radius=2, depth=1), repeats=5)
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s (XLA)")

    @case_("FILTER_TILED")
    def filter_tiled():
        # reference tiled kernel config (test.cu:81-90); XLA's fusion takes
        # the place of the shared-memory tile
        from .ops.boxfilter import box_filter
        x = _rand_planes(H, W)[0]
        dt, _ = time_fn(lambda: box_filter(x, radius=2, depth=1), repeats=5)
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s (XLA)")

    @case_("SVGF_SPATIAL")
    def svgf_spatial():
        color, variance, normal, depth = _rand_planes(H, W)
        params = SVGFParams(iterations=5)
        from .ops.atrous import svgf_spatial_ref
        dt, _ = time_fn(lambda: svgf_spatial_ref(
            color, variance, normal, depth, params=params,
            detach_weights=True), repeats=5)
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s fwd")

    @case_("RAYMARCH")
    def raymarch_case():
        from .ops.raymarch import cornell_scene, cornell_camera, render_gbuffer
        cfg = CameraParams(width=512, height=512)
        scene, cam = cornell_scene(), cornell_camera()
        key = jax.random.PRNGKey(0)
        dt, _ = time_fn(
            lambda: render_gbuffer(scene, cam, cam, key, cam_cfg=cfg), repeats=3)
        print(f"\t{mpix_per_s(512, 512, dt):.1f} Mpix/s")

    @case_("TEMPORAL")
    def temporal_case():
        from .gbuffer import GBuffer, History
        color, _v, normal, depth = _rand_planes(H, W)
        motion = jnp.zeros((2, H, W)).at[0].set(1.3).at[1].set(-2.7)
        g = GBuffer(render=color, albedo=jnp.full((3, H, W), 0.7),
                    normal=normal, depth=depth, motion=motion)
        hist = History.zeros(H, W)
        params = SVGFParams()
        from .ops.temporal import temporal_accumulate
        dt, (integ, var, _h) = time_fn(
            lambda: temporal_accumulate(g, hist, params=params), repeats=5)
        assert np.isfinite(np.asarray(integ)).all()
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s")

    @case_("FILTER_CROSS")
    def filter_cross():
        from .config import FilterParams, FilterType
        color, _v, normal, depth = _rand_planes(H, W)
        albedo = jnp.full((3, H, W), 0.7)
        p = FilterParams(type=FilterType.CROSS)
        from .ops.filters import cross_bilateral_filter
        dt, out = time_fn(lambda: cross_bilateral_filter(
            color, albedo, normal, depth, params=p), repeats=5)
        assert np.isfinite(np.asarray(out)).all()
        print(f"\t{mpix_per_s(H, W, dt):.1f} Mpix/s")

    @case_("SHARDED_SPATIAL")
    def sharded_spatial():
        # the config-5 machinery end to end on every device this host has —
        # asserts parity vs the unsharded sweep so the case is a
        # correctness check, not just a smoke run
        from .ops.atrous import svgf_spatial_ref
        from .parallel.mesh import make_mesh
        from .parallel.sharded import svgf_spatial_sharded

        on_cpu = jax.devices()[0].platform == "cpu"
        h, w = (128, 128) if on_cpu else (H, W)
        color, variance, normal, depth = _rand_planes(h, w)
        params = SVGFParams(iterations=5, radius=1)
        mesh = make_mesh()
        want = svgf_spatial_ref(color, variance, normal, depth,
                                params=params, detach_weights=True)[0]
        dt, (got, _v) = time_fn(
            lambda: svgf_spatial_sharded(
                color, variance, normal, depth, mesh=mesh, params=params),
            repeats=3)
        err = float(jnp.abs(got - want).max())
        assert err < 1e-3, f"sharded/unsharded mismatch {err}"
        print(f"\t{mpix_per_s(h, w, dt):.1f} Mpix/s on a "
              f"{dict(zip(mesh.axis_names, mesh.devices.shape))} mesh "
              f"(max |err| {err:.2e})")

    @case_("DEVICE_STATS")
    def device_stats():
        # reference SKIPs this (test.cu:51-53); we run it
        print_device_properties()

    def _cornell_frame(size=128):
        from .ops.raymarch import cornell_scene, cornell_camera, render_gbuffer
        cam = cornell_camera()
        return render_gbuffer(cornell_scene(), cam, cam, jax.random.PRNGKey(0),
                              cam_cfg=CameraParams(width=size, height=size))

    @case_("IMAGE")
    def image_roundtrip():
        # the reference's SKIP(IMAGE) referenced a missing sponza fixture
        # (test.cu:55-61): write a rendered Cornell frame with save_frame and
        # round-trip its render.png through the PNG codec
        import os
        import tempfile
        from .io import load_png, save_png, save_frame
        from .io.dataset import frame_dir
        with tempfile.TemporaryDirectory() as d:
            save_frame(d, "cornell", 1, _cornell_frame())
            img = load_png(os.path.join(frame_dir(d, "cornell", 1),
                                        "render.png"))
            out = os.path.join(d, "roundtrip.png")
            save_png(out, img)
            back = load_png(out)
        assert np.array_equal(img, back), "png roundtrip mismatch"

    @case_("DENOISE_CORNELL")
    def denoise_cornell():
        import tempfile
        from .gbuffer import History
        from .io import save_frame
        from .models.svgf import svgf_denoise_frame
        g = _cornell_frame()
        out, _ = svgf_denoise_frame(
            g, History.zeros(*g.shape), params=SVGFParams(iterations=5))
        d = np.asarray(out.denoised)
        assert np.isfinite(d).all()
        root = tempfile.mkdtemp(prefix="rdt_out_")
        save_frame(root, "cornell", 1, out)
        print(f"\twrote {root}/cornell/1/denoised.png")


def print_help(prog: str):
    # reference print_help (main.cpp:5-10)
    print(f"Usage: {prog} [options]\n"
          "Options:\n"
          "  -t [label]   Run all tests, or those matching the regex label\n"
          "  -h           Show this help message")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "raymarchdenoiser.cli"
    if not argv or argv[0] == "-h":
        print_help(prog)
        return 0
    if argv[0] == "-t":
        _register_builtin_cases()
        wildcard = argv[1] if len(argv) > 1 else ".*"
        return 0 if testing.run(wildcard) else 1
    print(f"Unknown option: {argv[0]}", file=sys.stderr)
    print_help(prog)
    return 2


if __name__ == "__main__":
    sys.exit(main())
