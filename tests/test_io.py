"""Image / dataset I/O tests (reference parity: the SKIP(IMAGE) round-trip the
reference never ran, src/test.cu:55-61, plus the openImages flow it never
defined, gbuffer.h:32)."""

import os

import numpy as np
import pytest

from raymarchdenoiser.io import (
    ImageIOError,
    load_png,
    save_png,
    to_planar_float,
    from_planar_float,
    load_frame,
    list_frames,
)


def test_png_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    save_png(p, img)
    back = load_png(p, channels=3)
    assert np.array_equal(back, img)


def test_load_missing_raises(tmp_path):
    with pytest.raises(ImageIOError):
        load_png(str(tmp_path / "nope.png"))


def test_planar_conversion_roundtrip(rng):
    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    planes = to_planar_float(img)
    assert planes.shape == (3, 13, 17)
    assert planes.dtype == np.float32
    assert planes.min() >= 0.0 and planes.max() <= 1.0
    back = from_planar_float(planes)
    assert np.array_equal(back, img)


def test_planar_conversion_numpy_vs_native(rng):
    from raymarchdenoiser.io import native

    if not native.available():
        pytest.skip("native lib not built")
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    a = native.u8_to_planar_f32(img)
    b = np.ascontiguousarray(img.astype(np.float32).transpose(2, 0, 1)) / 255.0
    np.testing.assert_allclose(a, b, atol=1e-7)


def test_cornell_frame_loads(cornell_frame):
    g = cornell_frame
    assert g.shape == (500, 500)
    assert g.render.shape == (3, 500, 500)
    assert g.albedo.shape == (3, 500, 500)
    assert g.normal.shape == (3, 500, 500)
    assert g.depth.shape == (500, 500)
    # normals unit length where defined
    n = np.asarray(g.normal)
    lens = np.sqrt((n ** 2).sum(axis=0))
    assert np.all(lens < 1.0 + 1e-4)


def test_list_frames(tmp_path):
    from raymarchdenoiser.gbuffer import zeros_gbuffer
    from raymarchdenoiser.io import save_frame

    save_frame(str(tmp_path), "cornell", 1, zeros_gbuffer(6, 5))
    assert list_frames(str(tmp_path), "cornell") == [1]


def test_save_frame_roundtrip(tmp_path, cornell_frame):
    from raymarchdenoiser.io import save_frame

    root = str(tmp_path)
    save_frame(root, "scene", 7, cornell_frame)
    g2 = load_frame(root, "scene", 7)
    np.testing.assert_allclose(
        np.asarray(g2.render), np.asarray(cornell_frame.render), atol=1 / 255.0 + 1e-6
    )
    np.testing.assert_allclose(
        np.asarray(g2.depth), np.asarray(cornell_frame.depth), atol=1 / 255.0 + 1e-6
    )
