#!/usr/bin/env python3
"""Regenerate golden outputs (run deliberately after intended semantic
changes): python3 tests/make_golden.py"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.image  # noqa: E402
import numpy as np  # noqa: E402

from raymarchdenoiser.config import SVGFParams  # noqa: E402
from raymarchdenoiser.gbuffer import History  # noqa: E402
from raymarchdenoiser.io.dataset import load_frame  # noqa: E402
from raymarchdenoiser.io.generate import write_cornell_fixture  # noqa: E402
from raymarchdenoiser.models.svgf import svgf_denoise_frame  # noqa: E402


def main():
    # the same fixture tests/conftest.py builds: rendered, written, reloaded
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        write_cornell_fixture(root)
        g = load_frame(root, "cornell", 1)
    small = jax.tree_util.tree_map(
        lambda x: (jax.image.resize(x, x.shape[:-2] + (256, 256), "linear")
                   if hasattr(x, "shape") and x.ndim >= 2 else x),
        g)
    out, _ = svgf_denoise_frame(
        small, History.zeros(256, 256), params=SVGFParams(iterations=5))
    dst = os.path.join(os.path.dirname(__file__), "golden")
    os.makedirs(dst, exist_ok=True)
    np.savez_compressed(os.path.join(dst, "cornell256_svgf5.npz"),
                        denoised=np.asarray(out.denoised))
    print("wrote", os.path.join(dst, "cornell256_svgf5.npz"))


if __name__ == "__main__":
    main()
