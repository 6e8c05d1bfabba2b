"""raymarchdenoiser — differentiable raymarcher + SVGF denoiser in JAX.

A from-scratch JAX framework with the capabilities of the CUDA reference
``VictorHerbert/RaymarchDenoiserCuda`` (see SURVEY.md), for NVIDIA GPUs:
planar float G-buffers, stencils that XLA fuses, an early-exit sphere-tracing
kernel through Pallas/Triton, ``shard_map`` + halo exchange to split frames
over several GPUs, and hand-written VJPs so pixel gradients flow back to
scene/material parameters.
"""

from .config import (
    FilterType,
    FilterParams,
    SVGFParams,
    CameraParams,
    RaymarchParams,
    WAVELET_SPLINE_5,
)
from .gbuffer import GBuffer, History, luminance, zeros_gbuffer

__version__ = "0.1.0"

__all__ = [
    "FilterType",
    "FilterParams",
    "SVGFParams",
    "CameraParams",
    "RaymarchParams",
    "WAVELET_SPLINE_5",
    "GBuffer",
    "History",
    "luminance",
    "zeros_gbuffer",
    "__version__",
]
