"""G-buffer data model as a JAX pytree.

Redesign of the reference's ``GBuffer`` family
(``include/gbuffer.h:6-33``):

* reference: raw ``uchar4*`` device pointers (``render/denoised/normal/albedo``
  + ping-pong ``buffer[2]``), interleaved RGBA8.
* here: a frozen dataclass pytree (``pytree.py``) of **planar float32**
  arrays.  Planar ``(C, H, W)`` makes every stencil tap a contiguous shifted
  plane that XLA fuses elementwise, and each channel a unit-stride row for
  coalesced loads.
  uint8 quantization happens only at the PNG boundary (io/image.py), keeping
  the differentiable path in float (SURVEY.md §7 hard part (d)).

Ping-pong intermediates need no explicit buffers: under ``jax.jit`` the
à-trous level loop is a ``lax.fori_loop`` carry and XLA double-buffers it.

The reference's ``CudaGBuffer::openImages`` (declared, never defined —
``gbuffer.h:32``) is realized by :func:`raymarchdenoiser.io.dataset.load_frame`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from . import pytree


@pytree.dataclass
class GBuffer:
    """Per-frame geometry buffers. All color planes are planar (3, H, W) float.

    ``render`` is the noisy (1-spp) pathtraced color; ``albedo``/``normal``/
    ``depth`` are the guidance planes; ``motion`` holds screen-space motion
    vectors (2, H, W) in pixels for temporal reprojection; ``denoised`` is the
    filter output (reference ``gbuffer.h:9``).
    """

    render: jax.Array               # (3, H, W)
    albedo: jax.Array               # (3, H, W)
    normal: jax.Array               # (3, H, W), unit vectors in [-1, 1]
    depth: jax.Array                # (H, W)
    motion: Optional[jax.Array] = None    # (2, H, W) pixels (dy, dx)
    denoised: Optional[jax.Array] = None  # (3, H, W)

    @property
    def shape(self):
        """(H, W) — reference ``GBuffer::shape`` (gbuffer.h:7)."""
        return self.render.shape[-2:]

    @property
    def height(self) -> int:
        return self.render.shape[-2]

    @property
    def width(self) -> int:
        return self.render.shape[-1]


@pytree.dataclass
class History:
    """Temporal accumulation state carried frame-to-frame (SVGF).

    The reference has no temporal state (README intent only); this is the
    checkpointable "model state" of the denoiser: accumulated color, the
    first two luminance moments, accumulated frame count, and the previous
    frame's depth/normal for reprojection validity tests.
    """

    color: jax.Array        # (3, H, W) accumulated color
    moments: jax.Array      # (2, H, W) accumulated (E[l], E[l^2])
    length: jax.Array       # (H, W) history length (frames, float)
    prev_depth: jax.Array   # (H, W)
    prev_normal: jax.Array  # (3, H, W)

    @classmethod
    def zeros(cls, height: int, width: int, dtype=jnp.float32) -> "History":
        return cls(
            color=jnp.zeros((3, height, width), dtype),
            moments=jnp.zeros((2, height, width), dtype),
            length=jnp.zeros((height, width), dtype),
            prev_depth=jnp.zeros((height, width), dtype),
            prev_normal=jnp.zeros((3, height, width), dtype),
        )


def luminance(color: jax.Array) -> jax.Array:
    """Rec.709 luma of a planar (3, H, W) color plane -> (H, W)."""
    return 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]


def zeros_gbuffer(height: int, width: int, dtype=jnp.float32) -> GBuffer:
    return GBuffer(
        render=jnp.zeros((3, height, width), dtype),
        albedo=jnp.zeros((3, height, width), dtype),
        normal=jnp.zeros((3, height, width), dtype),
        depth=jnp.zeros((height, width), dtype),
        motion=jnp.zeros((2, height, width), dtype),
        denoised=jnp.zeros((3, height, width), dtype),
    )
