"""End-to-end differentiable pipeline: raymarch -> SVGF -> loss -> optimize.

BASELINE.md config 4: "backprop pixel loss through SVGF + raymarcher to
optimize material albedo/roughness on the Cornell scene".  This is the
flagship "model" of the framework — the composition the reference repo's
name promised (raymarch + denoiser) made differentiable end to end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import CameraParams, RaymarchParams, SVGFParams
from ..gbuffer import GBuffer, History
from ..ops.raymarch import Scene, Camera, render_gbuffer
from .svgf import svgf_denoise_frame


@functools.partial(jax.jit, static_argnames=("cam_cfg", "rm_params",
                                              "svgf_params", "spp"))
def render_and_denoise(
    scene: Scene,
    camera: Camera,
    prev_camera: Optional[Camera],
    history: History,
    key: jax.Array,
    *,
    cam_cfg: CameraParams = CameraParams(),
    rm_params: RaymarchParams = RaymarchParams(),
    svgf_params: SVGFParams = SVGFParams(),
    spp: int = 1,
) -> Tuple[GBuffer, History]:
    """One frame of the full pipeline (render + denoise), differentiable."""
    gbuf = render_gbuffer(scene, camera, prev_camera, key,
                          cam_cfg=cam_cfg, params=rm_params, spp=spp)
    return svgf_denoise_frame(gbuf, history, params=svgf_params)


class TrainState(NamedTuple):
    albedo: jax.Array      # (M, 3) material albedo table being optimized
    opt_state: optax.OptState
    history: History
    key: jax.Array


def make_train_step(
    base_scene: Scene,
    camera: Camera,
    target: jax.Array,                  # (3, H, W) clean reference render
    optimizer: optax.GradientTransformation,
    *,
    cam_cfg: CameraParams = CameraParams(),
    rm_params: RaymarchParams = RaymarchParams(),
    svgf_params: SVGFParams = SVGFParams(),
):
    """Build a jitted train step closing over static config.

    The differentiable parameters are the material albedo table; gradients
    flow through the à-trous filter's color path (detached weights / custom
    VJP), the temporal blend, and the raymarcher's shading.
    """

    def loss_fn(albedo, history, key):
        scene = base_scene.replace(
            materials=base_scene.materials.replace(albedo=albedo))
        out, new_hist = render_and_denoise(
            scene, camera, None, history, key,
            cam_cfg=cam_cfg, rm_params=rm_params, svgf_params=svgf_params)
        loss = jnp.mean((out.denoised - target) ** 2)
        return loss, new_hist

    @jax.jit
    def train_step(state: TrainState) -> Tuple[TrainState, jax.Array]:
        key, sub = jax.random.split(state.key)
        (loss, new_hist), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.albedo, state.history, sub)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.albedo)
        albedo = optax.apply_updates(state.albedo, updates)
        albedo = jnp.clip(albedo, 0.0, 1.0)
        return TrainState(albedo, opt_state, new_hist, key), loss

    return train_step


def init_train_state(
    albedo_init: jax.Array,
    optimizer: optax.GradientTransformation,
    height: int,
    width: int,
    key: jax.Array,
) -> TrainState:
    return TrainState(
        albedo=albedo_init,
        opt_state=optimizer.init(albedo_init),
        history=History.zeros(height, width),
        key=key,
    )
