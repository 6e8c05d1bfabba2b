"""Dataset generation: render animated G-buffer sequences to disk.

The reference ships one Cornell frame (``render/cornell/1/``) and references
a sponza sequence that was never checked in (``src/test.cu:13``, SURVEY.md
§2 C14).  This module *generates* such datasets with the framework's own
raymarcher: ``render/<scene>/<frame>/{render,albedo,normal,depth}.png`` plus
float .npz planes (motion vectors and exact depth don't survive 8-bit PNG).

CLI: ``python -m raymarchdenoiser.io.generate out_dir --frames 8``
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraParams, RaymarchParams
from ..gbuffer import GBuffer
from ..ops.raymarch import (
    Scene, Camera, cornell_scene, cornell_camera, render_gbuffer,
)
from .dataset import save_frame, frame_dir


def orbit_camera(t: float, radius: float = 1.7, dtype=jnp.float32) -> Camera:
    """Camera slowly orbiting/bobbing in front of the Cornell box.

    ``t`` in [0, 1) over the sequence; motion is small enough that most
    pixels reproject (temporal accumulation stays effective).
    """
    ang = 0.25 * np.sin(2 * np.pi * t)
    x = radius * np.sin(ang) * 0.4
    y = 0.08 * np.sin(4 * np.pi * t)
    z = -radius + 0.12 * np.cos(2 * np.pi * t) - 0.12
    return Camera(
        position=jnp.asarray([x, y, z], dtype),
        look_at=jnp.asarray([0.0, 0.0, 1.0], dtype),
        up=jnp.asarray([0.0, 1.0, 0.0], dtype),
    )


def generate_sequence(
    root: str,
    scene_name: str = "cornell_anim",
    frames: int = 8,
    *,
    scene: Optional[Scene] = None,
    cam_cfg: CameraParams = CameraParams(width=512, height=512),
    rm_params: RaymarchParams = RaymarchParams(),
    spp: int = 1,
    seed: int = 0,
    animate: bool = True,
    save_float: bool = True,
):
    """Render ``frames`` G-buffers; returns the list of GBuffers.

    Writes the reference's PNG layout; with ``save_float`` also writes
    ``planes.npz`` per frame (float32 planes incl. motion) so temporal tests
    don't suffer 8-bit quantization.
    """
    scene = scene if scene is not None else cornell_scene()
    key = jax.random.PRNGKey(seed)
    prev_cam = None
    out = []
    for f in range(frames):
        cam = orbit_camera(f / max(frames, 1)) if animate else cornell_camera()
        key, sub = jax.random.split(key)
        g = render_gbuffer(scene, cam, prev_cam, sub,
                           cam_cfg=cam_cfg, params=rm_params, spp=spp)
        save_frame(root, scene_name, f + 1, g)
        if save_float:
            np.savez(
                os.path.join(frame_dir(root, scene_name, f + 1), "planes.npz"),
                render=np.asarray(g.render), albedo=np.asarray(g.albedo),
                normal=np.asarray(g.normal), depth=np.asarray(g.depth),
                motion=np.asarray(g.motion),
            )
        out.append(g)
        prev_cam = cam
    return out


def write_cornell_fixture(root: str, size: int = 500, seed: int = 0) -> GBuffer:
    """Render the static-camera Cornell box at the reference fixture's shape
    (500×500, 1 spp) and write it as ``root/cornell/1/*.png`` — the layout of
    the reference's ``render/cornell/1/``.  Depth is divided by its maximum
    so it survives the 8-bit PNG.  Returns the rendered G-buffer."""
    cam = cornell_camera()
    g = render_gbuffer(cornell_scene(), cam, cam, jax.random.PRNGKey(seed),
                       cam_cfg=CameraParams(width=size, height=size))
    g = g.replace(depth=g.depth / jnp.maximum(jnp.max(g.depth), 1e-6))
    save_frame(root, "cornell", 1, g)
    return g


def load_float_frame(root: str, scene_name: str, frame: int) -> GBuffer:
    """Load the float .npz planes written by :func:`generate_sequence`."""
    d = np.load(os.path.join(frame_dir(root, scene_name, frame), "planes.npz"))
    return GBuffer(
        render=jnp.asarray(d["render"]), albedo=jnp.asarray(d["albedo"]),
        normal=jnp.asarray(d["normal"]), depth=jnp.asarray(d["depth"]),
        motion=jnp.asarray(d["motion"]), denoised=None,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--scene", default="cornell_anim")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--static", action="store_true", help="fixed camera")
    args = ap.parse_args(argv)
    generate_sequence(
        args.out_dir, args.scene, args.frames,
        cam_cfg=CameraParams(width=args.size, height=args.size),
        spp=args.spp, animate=not args.static,
    )
    print(f"wrote {args.frames} frames to {args.out_dir}/{args.scene}/")


if __name__ == "__main__":
    main()
