"""Port parity: the SExtractor background, on the device and on the host.

``ops/background.py::stack_background`` (plain torch) is held against the
port's float64 host oracle ``pipeline/spots.py::_mesh_background`` and
against the JAX package's ``stack_background`` on the same numpy-seeded
fields, at the JAX tests' own bound: 5e-5 of the background's scale for
float32 input (a float32 mean summed in another order may flip a pixel that
sits within an ulp of a clip bound) and 1e-9 for float64 input (same
decisions, summation order only). The host numerics copied from the JAX
package (``_mesh_background``, ``sextractor_aperture_sums``,
``pairwise_zoom_bases``, ``reflect_window_index`` and the aperture
fractions) equal the JAX package's exactly.
"""

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu.ops import background as jax_bg
from fluorosequencingimageanalysis_tpu.pipeline import spots as jax_spots

from fluorosequencingimageanalysis_torch.ops import background as port_bg
from fluorosequencingimageanalysis_torch.pipeline import spots as port_spots

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

F32_BOUND, F64_BOUND = 5e-5, 1e-9
SHAPES = [
    ((128, 128), 10, 10),   # the reference sextractor defaults' regime
    ((97, 113), 8, 3),      # non-divisible dims, small odd filter
    ((64, 64), 64, 10),     # single box per axis (constant background)
    ((40, 40), 10, 2),      # even filter size (scipy rank m//2 semantics)
    ((16, 16), 20, 10),     # box larger than the image
]


def _field(rng, H, W, n_spots=20, base=500.0):
    yy, xx = np.mgrid[:H, :W]
    img = (base + 0.5 * yy + 0.3 * xx + 30 * np.sin(yy / 17.0)
           + rng.normal(0, 5, (H, W)))
    for _ in range(n_spots):
        h, w = rng.integers(2, H - 2), rng.integers(2, W - 2)
        img[h - 1:h + 2, w - 1:w + 2] += rng.uniform(100, 2000)
    return img


def _rel(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _port(img, box, filt):
    return port_bg.stack_background(img, box, filt, device="cpu").numpy()


@pytest.mark.parametrize("shape,box,filt", SHAPES)
def test_background_matches_host_oracle_and_jax(shape, box, filt):
    img = _field(np.random.default_rng(7), *shape)
    host = port_spots._mesh_background(img, box, filt)
    np.testing.assert_array_equal(
        host, jax_spots._mesh_background(img, box, filt))
    got = _port(img.astype(np.float32), box, filt)
    assert got.dtype == np.float32 and got.shape == shape
    assert _rel(got, host) < F32_BOUND
    ref = np.asarray(jax_bg.stack_background(img.astype(np.float32), box,
                                             filt))
    assert _rel(got, ref) < F32_BOUND
    got64 = _port(img, box, filt)
    assert got64.dtype == np.float64
    assert _rel(got64, host) < F64_BOUND
    assert _rel(got64, np.asarray(jax_bg.stack_background(img, box, filt))
                ) < F64_BOUND


@pytest.mark.parametrize("seed", range(10))
def test_background_fuzz_random_shapes_and_params(seed):
    rng = np.random.default_rng(1000 + seed)
    H = int(rng.integers(16, 160))
    W = int(rng.integers(16, 160))
    box = int(rng.integers(4, 33))
    filt = int(rng.integers(1, 12))
    base = float(rng.uniform(50, 5000))
    img = _field(rng, H, W, n_spots=int(rng.integers(0, 40)), base=base)
    host = port_spots._mesh_background(img, box, filt)
    got = _port(img.astype(np.float32), box, filt)
    assert _rel(got, host) < F32_BOUND, (seed, H, W, box, filt)
    ref = np.asarray(jax_bg.stack_background(img.astype(np.float32), box,
                                             filt))
    assert _rel(got, ref) < F32_BOUND, (seed, H, W, box, filt)


def test_background_batches_dtypes_and_subtraction():
    rng = np.random.default_rng(11)
    stack = np.stack([_field(rng, 96, 96) for _ in range(3)])
    f32 = stack.astype(np.float32)
    batched = _port(f32, 10, 10)
    singles = np.stack([_port(f, 10, 10) for f in f32])
    np.testing.assert_array_equal(batched, singles)
    assert batched.shape == stack.shape
    # Raw camera integers widen on the device (uint16 through its int16
    # view, bit-exact): the result of the float32 cast of the same frames.
    bright = np.round(stack * 60).clip(0, 65535)        # beyond int16
    assert bright.max() > 40000
    for dt in (np.uint16, np.int32):
        np.testing.assert_array_equal(_port(bright.astype(dt), 10, 4),
                                      _port(bright.astype(np.float32), 10, 4))
    # A tensor is used where it lies; the jitted core's name is an alias.
    t = torch.from_numpy(f32)
    assert port_bg.stack_background_jit is port_bg.stack_background
    np.testing.assert_array_equal(
        port_bg.stack_background(t, 10, 10).numpy(), batched)
    sub = port_bg.subtract_background_stack(bright.astype(np.uint16), 10, 4,
                                            device="cpu").numpy()
    np.testing.assert_array_equal(
        sub, bright.astype(np.float32) - _port(bright.astype(np.uint16),
                                               10, 4))
    ref = np.asarray(jax_bg.subtract_background_stack(
        bright.astype(np.uint16), 10, 4))
    assert np.abs(sub - ref).max() / np.abs(bright).max() < F32_BOUND
    # A constant box has std == 0 and takes its mean (the spline zoom
    # reproduces a constant to rounding only).
    flat = np.full((2, 20, 20), 7.0, np.float32)
    np.testing.assert_allclose(_port(flat, 10, 3), flat, rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_bg.stack_background(f32)


def test_masked_reductions_equal_numpy_nan_reductions():
    rng = np.random.default_rng(2)
    v = rng.normal(100, 5, (6, 11))
    valid = rng.random((6, 11)) < 0.7
    valid[:, 0] = True
    valid[3] = True
    nan = np.where(valid, v, np.nan)
    tv, tm = torch.from_numpy(v), torch.from_numpy(valid)
    np.testing.assert_allclose(port_bg._masked_median(tv, tm).numpy(),
                               np.nanmedian(nan, axis=-1), rtol=1e-14)
    mean, std = port_bg._masked_mean_std(tv, tm)
    np.testing.assert_allclose(mean.numpy(), np.nanmean(nan, axis=-1),
                               rtol=1e-14)
    np.testing.assert_allclose(std.numpy(), np.nanstd(nan, axis=-1),
                               rtol=1e-12)


def test_host_tables_equal_the_jax_packages():
    for n, k in [(9, 2), (9, 3), (7, 4), (12, 5), (5, 5), (3, 10)]:
        got = port_bg.reflect_window_index(n, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jax_bg.reflect_window_index(n, k))
    for key in [(7, 7, 10), (2, 4, 28), (4, 4, 10), (1, 5, 6), (1, 1, 10),
                (3, 2, 4)]:
        for a, b in zip(port_bg.pairwise_zoom_bases(*key),
                        jax_bg.pairwise_zoom_bases(*key)):
            np.testing.assert_array_equal(a, b)
    for radius, sub in [(3, None), (2.5, None), (3, 5)]:
        np.testing.assert_array_equal(
            port_spots._aperture_fracs(radius, sub),
            jax_spots._aperture_fracs(radius, sub))
    assert port_spots._circle_pixel_area(-0.5, 0.5, -0.5, 0.5, 3.0) == 1.0
    assert port_spots._circle_pixel_area(-0.5, 0.5, 2.5, 3.5, 3.0) == \
        jax_spots._circle_pixel_area(-0.5, 0.5, 2.5, 3.5, 3.0)


def test_host_sextractor_numerics_equal_the_jax_packages():
    rng = np.random.default_rng(5)
    img = _field(rng, 80, 72)
    boxes = rng.normal(500, 5, (12, 100))
    boxes[::3, :7] += 400
    clipped = port_spots.sigma_clip_boxes(boxes)
    np.testing.assert_array_equal(clipped, jax_spots.sigma_clip_boxes(boxes))
    assert np.isnan(clipped).any()
    np.testing.assert_array_equal(port_spots.sextractor_mode(clipped),
                                  jax_spots.sextractor_mode(clipped))
    hs = np.array([0, 3, 40, 79, 12])
    ws = np.array([0, 70, 36, 71, 5])       # corners and edges included
    got = port_spots.sextractor_aperture_sums(img, hs, ws, 3, 10, 10)
    np.testing.assert_array_equal(
        got, jax_spots.sextractor_aperture_sums(img, hs, ws, 3, 10, 10))
    assert got.dtype == np.float64 and got.shape == (5,)
    sub = img - port_spots._mesh_background(img, 10, 10)
    for h, w, v in zip(hs, ws, got):
        assert np.isclose(v, port_spots._aperture_sum(sub, h, w, 3),
                          rtol=1e-12, atol=1e-9)
        assert port_spots._aperture_sum(sub, h, w, 3) == \
            jax_spots._aperture_sum(sub, h, w, 3)
    with pytest.raises(ValueError, match="inside the image"):
        port_spots.sextractor_aperture_sums(img, np.array([-1]),
                                            np.array([3]), 3, 10, 10)
