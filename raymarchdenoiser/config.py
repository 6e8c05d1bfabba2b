"""Configuration dataclasses (static, hashable).

Analogue of the reference's ``FilterParams`` POD config struct
(reference: ``include/filter.cuh:11-23``).  In the CUDA reference the config is
passed by value into kernels; here configs are frozen dataclasses used as
*static* arguments under ``jax.jit`` so every field is folded into the compiled
program (the XLA analogue of ``__constant__`` memory, reference
``src/filter.cu:10``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class FilterType(enum.Enum):
    """Filter families.

    Mirrors the reference enum ``FilterType {AVERAGE, GAUSSIAN, CROSS, WAVELET}``
    (``include/filter.cuh:12``).  The reference only implements AVERAGE
    (``src/filter.cu:41``); here all four are real.
    """

    AVERAGE = "average"
    GAUSSIAN = "gaussian"
    CROSS = "cross"        # cross-bilateral: edge-stopping on guidance planes
    WAVELET = "wavelet"    # edge-aware à-trous B3-spline wavelet (SVGF)


# B3-spline à-trous coefficients.  The reference declares (but never uses)
# ``__constant__ float waveletSpline[3] = {3/8, 1/4, 1/16}`` (src/filter.cu:10).
# The full separable 5-tap kernel is the symmetric expansion of that half:
WAVELET_SPLINE_5: Tuple[float, ...] = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Spatial-filter configuration (static under jit).

    Field-for-field superset of the reference ``FilterParams``
    (``include/filter.cuh:11-23``): ``type/depth/radius/sigma*`` keep their
    meaning; ``level`` (declared but unused there, filter.cuh:14) is the
    starting à-trous level — WAVELET applies levels ``level .. level+depth-1``
    with tap spacing ``2^i``; ``cacheInput/cacheBuffer`` (shared-memory
    staging switches of the CUDA kernels) have no analogue — XLA decides
    staging — and are dropped.
    """

    type: FilterType = FilterType.AVERAGE
    depth: int = 1            # number of iterated filter levels (à-trous iterations)
    level: int = 0            # starting à-trous level (dilation 2^level); WAVELET only
    radius: int = 2           # tap radius; (2r+1)^2 footprint at level 0
    sigma_space: float = 2.0  # gaussian spatial sigma (GAUSSIAN/CROSS)
    sigma_color: float = 4.0  # SVGF sigma_l (luminance edge-stopping)
    sigma_albedo: float = 0.5
    sigma_normal: float = 128.0  # SVGF sigma_n exponent
    sigma_depth: float = 1.0     # SVGF sigma_z

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if self.radius < 0:
            raise ValueError(f"radius must be >= 0, got {self.radius}")
        if self.level < 0:
            raise ValueError(f"level must be >= 0, got {self.level}")


@dataclasses.dataclass(frozen=True)
class SVGFParams:
    """Full SVGF pipeline configuration (spatial + temporal).

    The reference only *declares* the SVGF intent (README.md:1-10, sigma
    params at filter.cuh:16-19); this realizes it.
    """

    iterations: int = 5          # à-trous iterations (spacing 2^i at level i)
    radius: int = 2              # 5-tap B3 kernel => radius 2
    sigma_color: float = 4.0     # sigma_l
    sigma_normal: float = 128.0  # sigma_n
    sigma_depth: float = 1.0     # sigma_z
    temporal_alpha: float = 0.2        # EMA blend for color history
    temporal_moments_alpha: float = 0.2
    history_clamp: bool = True         # clamp history to neighborhood min/max
    variance_boost_frames: int = 4     # spatial variance fallback for short history
    feedback_level: int = 1      # à-trous level whose output feeds next frame's history
    # Reprojection search bound in pixels: bilinear history samples are
    # computed with streaming shifts for |motion| <= max_motion; larger
    # motion counts as disocclusion (so the bound decides which history is
    # kept).  None = exact gather-based reprojection for unbounded motion.
    max_motion: Optional[int] = 6
    # Cheaper-filter study (round 4): levels >= luma_only_from drop the
    # depth/normal edge-stopping terms and filter with the luminance weight
    # alone.  PER-SCENE OPTION ONLY (round-5 two-scene quality gate): on
    # Cornell's flat geometry lq3 measures ABOVE the full-weight baselines
    # (+0.06 dB), but on a scene with geometry structure at deep-dilation
    # scales it loses 0.82 dB PSNR / 0.023 SSIM (lq4: −0.43 dB) — the
    # deep-level geometry terms are doing real work there.  None = full
    # weights everywhere (default).  Quality-gate any use on YOUR scene
    # with tools/denoise_quality.py --scene.
    luma_only_from: Optional[int] = None
    # Cheaper-filter study part 3 (round 5, r3 verdict #2c): run levels >=
    # pyramid_from at HALF resolution (2x2-mean downsampled planes, level
    # index shifted by one so the world-space footprint matches) and add the
    # bilinear-upsampled coarse delta back.  EXPERIMENTAL, jnp-oracle only;
    # adjudicated on the two-scene quality gate before any kernel work —
    # see ROADMAP round-5 findings.
    pyramid_from: Optional[int] = None

    def __post_init__(self):
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.pyramid_from is not None and self.pyramid_from < 1:
            raise ValueError("pyramid_from must be >= 1 (level 0 has no "
                             "coarser footprint to move to)")


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Pinhole camera (static shape info only; pose is a runtime pytree)."""

    width: int = 512
    height: int = 512
    fov_y: float = 0.6911  # ~39.6 deg vertical (Cornell-ish)


@dataclasses.dataclass(frozen=True)
class RaymarchParams:
    """Sphere-tracing configuration (static under jit).

    The raymarcher exists in the reference only as repo-name intent; here a
    static step bound, masked convergence (the jnp loop) or per-tile early
    exit (the GPU kernel), and fused G-buffer emission.
    """

    max_steps: int = 64
    max_dist: float = 20.0
    hit_eps: float = 1e-3
    normal_eps: float = 1e-3
    samples_per_pixel: int = 1   # MC noise level of the "noisy render" plane
    shadow_steps: int = 32
    light_samples: int = 1
    # Over-relaxed sphere tracing (Keinert et al.): step ω·d with an
    # overlap test — if consecutive step spheres don't overlap, the step
    # may have crossed a surface and is rolled back to the conservative
    # one, so hits are identical to plain tracing within hit_eps.  1.0
    # (default) disables relaxation.  Its speed on the GPU kernel is
    # unmeasured; shadow accuracy at a fixed step budget is measurably
    # better with it
    # (tests/test_raymarch.py::test_relaxed_shadow_no_less_accurate_than_plain).
    relax_omega: float = 1.0


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """One benchmark configuration (BASELINE.md configs table)."""

    name: str
    width: int
    height: int
    iterations: int = 5
    frames: int = 1
    temporal: bool = False
    backward: bool = False
