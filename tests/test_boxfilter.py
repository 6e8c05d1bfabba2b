"""Parity tests: JAX box filter vs the independent C++ CPU oracle.

The C++ oracle (native/rdt_native.cpp) reimplements the reference kernels'
semantics (reference src/filter.cu:13-158) from spec; agreement of two
independent implementations is the correctness bar the reference itself never
had (its tests assert nothing — SURVEY.md §4).
"""

import numpy as np
import pytest

from raymarchdenoiser.io import native
from raymarchdenoiser.ops.boxfilter import box_filter, box_filter_u8

needs_native = pytest.mark.skipif(not native.available(), reason="native lib not built")


@needs_native
@pytest.mark.parametrize("radius,depth,quirk", [
    (2, 1, False),   # FILTER_TILED config (reference src/test.cu:81-90)
    (2, 1, True),    # FILTER_BASELINE config incl. grayscale quirk (src/test.cu:68-78)
    (1, 3, False),   # deeper ping-pong
    (3, 2, True),
    (0, 1, False),   # identity window
])
def test_u8_parity_vs_cpp_oracle(rng, radius, depth, quirk):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    want = native.box_filter_u8(img, radius, depth, quirk)
    got = np.asarray(box_filter_u8(img, radius=radius, depth=depth, grayscale_quirk=quirk))
    # float accumulation order may differ => the truncating uint8 cast can
    # disagree by 1 ULP when the exact average is within float eps of an
    # integer; allow <=1 difference on a tiny fraction of pixels.
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.001


@needs_native
def test_u8_parity_cornell(cornell_frame):
    from raymarchdenoiser.io.image import from_planar_float

    img = from_planar_float(np.asarray(cornell_frame.render))
    want = native.box_filter_u8(img, 2, 1, False)
    got = np.asarray(box_filter_u8(img, radius=2, depth=1))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.001


def test_float_box_filter_matches_direct(rng):
    x = rng.random((3, 33, 47), dtype=np.float32)
    got = np.asarray(box_filter(x, radius=2, depth=1))
    # direct O(r^2) computation
    H, W = x.shape[-2:]
    want = np.zeros_like(x)
    for i in range(H):
        for j in range(W):
            ys = slice(max(i - 2, 0), min(i + 3, H))
            xs = slice(max(j - 2, 0), min(j + 3, W))
            want[:, i, j] = x[:, ys, xs].mean(axis=(1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_float_box_filter_constant_preserved():
    x = np.full((1, 24, 40), 0.625, np.float32)
    y = np.asarray(box_filter(x, radius=3, depth=4))
    np.testing.assert_allclose(y, x, rtol=1e-6)


def _box_direct(x, radius, depth):
    """Iterated (2r+1)^2 mean over in-image taps, float64 NumPy."""
    x = x.astype(np.float64)
    H, W = x.shape[-2:]
    r = radius
    for _ in range(depth):
        xp = np.pad(x, [(0, 0), (r, r), (r, r)])
        m = np.pad(np.ones((H, W)), r)
        num = np.zeros_like(x)
        cnt = np.zeros((H, W))
        for dy in range(2 * r + 1):
            for dx in range(2 * r + 1):
                num += xp[:, dy:dy + H, dx:dx + W]
                cnt += m[dy:dy + H, dx:dx + W]
        x = num / cnt
    return x


@pytest.mark.parametrize("radius,depth", [(2, 1), (1, 2), (2, 3)])
def test_float_box_filter_iterated_matches_direct(rng, radius, depth):
    x = rng.random((3, 40, 48), dtype=np.float32)
    got = np.asarray(box_filter(x, radius=radius, depth=depth))
    np.testing.assert_allclose(got, _box_direct(x, radius, depth),
                               rtol=1e-5, atol=1e-6)


def test_float_box_filter_tall_image(rng):
    """A tall single-channel image (300 rows): the running sums stay exact
    far from the first row."""
    x = rng.random((1, 300, 64), dtype=np.float32)
    got = np.asarray(box_filter(x, radius=2, depth=2))
    np.testing.assert_allclose(got, _box_direct(x, 2, 2), rtol=1e-5,
                               atol=1e-6)
