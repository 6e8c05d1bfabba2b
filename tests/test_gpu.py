"""The compiled Triton march kernels on an NVIDIA GPU (marker ``gpu``).

These need the card: a Triton kernel compiles only for it, and the CPU
suite covers the same kernels in interpret mode (tests/test_raymarch.py).
They skip elsewhere; run them on the card with

    RDT_TEST_GPU=1 python -m pytest -m gpu tests/

(``chip_smoke.py`` runs them in its last phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchdenoiser.config import CameraParams, RaymarchParams
from raymarchdenoiser.ops.raymarch import (_raymarch_loop, _shadow_factor,
                                           camera_rays, cornell_camera,
                                           cornell_scene, random_scene,
                                           render_gbuffer, sdf_normal)

pytestmark = pytest.mark.gpu

RM = RaymarchParams()


def _march_both(scene, shape, rm=RM):
    from raymarchdenoiser.ops.pallas.march_triton import march_triton

    H, W = shape
    ro, rd, _ = camera_rays(cornell_camera(), CameraParams(width=W, height=H))
    with jax.default_matmul_precision("highest"):
        t1, h1 = march_triton(scene, ro, rd, rm)
        t0, h0 = jax.jit(_raymarch_loop, static_argnums=3)(scene, ro, rd, rm)
    return ro, rd, (np.asarray(t1), np.asarray(h1)), (np.asarray(t0),
                                                       np.asarray(h0))


@pytest.mark.parametrize("scene_name", ["cornell", "random53"])
@pytest.mark.parametrize("shape", [(256, 256), (29, 37)])
def test_compiled_march_matches_loop(scene_name, shape):
    """Both routes run the same f32 update per ray: hit masks agree and
    shared hits sit within hit_eps of each other."""
    scene = (cornell_scene() if scene_name == "cornell" else
             random_scene(n_spheres=24, n_boxes=24, n_materials=16, seed=3))
    _, _, (t1, h1), (t0, h0) = _march_both(scene, shape)
    assert (h1 == h0).mean() >= 0.999
    both = h1 & h0
    assert np.abs(t1 - t0)[both].max(initial=0.0) <= RM.hit_eps


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_compiled_shadow_matches_loop(omega):
    from raymarchdenoiser.ops.pallas.march_triton import shadow_triton

    scene = cornell_scene()
    rm = RaymarchParams(relax_omega=omega)
    ro, rd, _, (t0, _h0) = _march_both(scene, (128, 160), rm)
    p = ro + jnp.asarray(t0)[None] * rd
    n = sdf_normal(scene, p)
    lp = jnp.broadcast_to(scene.light_center[:, None, None], p.shape)
    v1 = np.asarray(shadow_triton(scene, p, n, lp, rm))
    v0 = np.asarray(jax.jit(_shadow_factor, static_argnums=4)(
        scene, p, n, lp, rm))
    assert (v1 == v0).mean() >= 0.999


def test_render_gbuffer_takes_triton_route():
    """On the GPU the compiled render holds both Triton marches."""
    cfg = CameraParams(width=64, height=64)
    cam = cornell_camera()
    text = render_gbuffer.lower(cornell_scene(), cam, cam,
                                jax.random.PRNGKey(0), cam_cfg=cfg,
                                params=RM).as_text()
    # one Triton custom call per march (the route's two lowering forms)
    calls = (text.count("__gpu$xla.gpu.triton")
             + text.count("triton_kernel_call"))
    assert calls == 2, calls
