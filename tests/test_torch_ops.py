"""Port parity: fluorosequencingimageanalysis_torch ops vs the JAX package.

Inputs are made from numpy seeds and handed to both sides. Unless a test
says otherwise, selections (medians, masks, top-k order, NMS keep masks,
gathers) must match exactly, and float results within the tolerance stated
beside each comparison.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluorosequencingimageanalysis_tpu.ops import candidates as jc
from fluorosequencingimageanalysis_tpu.ops import consolidate as jcons
from fluorosequencingimageanalysis_tpu.ops import gaussian as jg
from fluorosequencingimageanalysis_tpu.ops import photometry as jp
from fluorosequencingimageanalysis_tpu.ops import quality as jq
from fluorosequencingimageanalysis_tpu.ops import registration as jr
from fluorosequencingimageanalysis_tpu.ops.pallas_candidates import (
    candidate_map_fused as pallas_candidate_map)
from fluorosequencingimageanalysis_tpu.utils import rounding as jround

from fluorosequencingimageanalysis_torch.ops import candidates as tc
from fluorosequencingimageanalysis_torch.ops import consolidate as tcons
from fluorosequencingimageanalysis_torch.ops import gaussian as tg
from fluorosequencingimageanalysis_torch.ops import photometry as tp
from fluorosequencingimageanalysis_torch.ops import quality as tq
from fluorosequencingimageanalysis_torch.ops import registration as tr
from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
    candidate_map_fused, candidate_map_plain)
from fluorosequencingimageanalysis_torch.utils import rounding as tround

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


def _t(x):
    return torch.tensor(np.asarray(x))


def _planted(shape, seed, n_spots=6, amp=3000.0, sigma2=3.0):
    rng = np.random.default_rng(seed)
    img = rng.normal(400.0, 10.0, shape)
    h, w = shape[-2:]
    hh, ww = np.indices((h, w))
    for _ in range(n_spots):
        ch, cw = rng.uniform(3, h - 3), rng.uniform(3, w - 3)
        img = img + amp * np.exp(-((hh - ch) ** 2 + (ww - cw) ** 2) / sigma2)
    return img.astype(np.float32)


# -- gaussian / quality / rounding ------------------------------------------

def test_gauss2d_matches_jax():
    # float64 on both sides: same formula, so agreement to rounding.
    rng = np.random.default_rng(0)
    p = np.stack([rng.uniform(300, 500, 40), rng.uniform(500, 4000, 40),
                  rng.uniform(2, 3, 40), rng.uniform(2, 3, 40),
                  rng.uniform(0.75, 2, 40), rng.uniform(0.75, 2, 40),
                  rng.uniform(0, 360, 40)], axis=-1)
    ref = np.asarray(jg.gauss2d_image(jnp.asarray(p), (5, 7),
                                      dtype=jnp.float64))
    got = tg.gauss2d_image(_t(p), (5, 7), dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-9)
    assert tg.PSF_PARAM_NAMES == jg.PSF_PARAM_NAMES


def test_quality_metrics_match_jax_including_flat_patch():
    # float32 sums over 25 pixels in another order: rtol 1e-5. A flat patch
    # fitted exactly gives NaN R^2 and NaN S/N on both sides.
    rng = np.random.default_rng(1)
    sub = rng.normal(400, 30, (32, 5, 5)).astype(np.float32)
    fit = (sub + rng.normal(0, 5, sub.shape)).astype(np.float32)
    sub[0] = 400.0
    fit[0] = 400.0
    for jf, tf in [(jq.r_squared, tq.r_squared), (jq.rmse, tq.rmse)]:
        ref = np.asarray(jf(jnp.asarray(sub), jnp.asarray(fit)))
        got = tf(_t(sub), _t(fit)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jq.illumina_s_n(jnp.asarray(sub)))
    got = tq.illumina_s_n(_t(sub)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert np.isnan(got[0]) and np.isnan(
        tq.r_squared(_t(sub[:1]), _t(fit[:1])).numpy()[0])
    np.testing.assert_array_equal(tq.edge_ring_indices(5),
                                  jq.edge_ring_indices(5))


def test_py2_round_device_matches_jax_on_halves_and_negatives():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, -0.49999997,
                  3.2, -3.7, 0.0, -0.0, 1e6 + 0.5, -(1e6 + 0.5), 7.0],
                 np.float32)
    x = np.concatenate(
        [x, np.random.default_rng(2).uniform(-600, 600, 500)
         .astype(np.float32)])
    ref = np.asarray(jround.py2_round_device_i32(jnp.asarray(x)))
    got = tround.py2_round_device_i32(_t(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert got[:6].tolist() == [1, 2, 3, -1, -2, -3]


# -- candidates ---------------------------------------------------------------

def test_default_correlation_matrix_is_the_jax_one():
    np.testing.assert_array_equal(tc.DEFAULT_CORRELATION_MATRIX,
                                  jc.DEFAULT_CORRELATION_MATRIX)
    assert tc.DEFAULT_CORRELATION_MATRIX.dtype == np.float64


@pytest.mark.parametrize("n,lo,hi", [(7, 2, 2), (5, 2, 1), (3, 4, 5),
                                     (1, 2, 2)])
def test_symmetric_padding_is_numpy_symmetric(n, lo, hi):
    a = np.arange(n * 4, dtype=np.float32).reshape(4, n)
    ref = np.pad(a, ((lo, hi), (lo, hi)), mode="symmetric")
    np.testing.assert_array_equal(tc.pad_symmetric(_t(a), lo, hi).numpy(),
                                  ref)


@pytest.mark.parametrize("size", [3, 4, 5])
def test_median_filter_matches_jax(size):
    # A median is a selection: exact. Even sizes follow scipy's rank rule.
    img = np.random.default_rng(size).normal(0, 1, (13, 17)) \
        .astype(np.float32)
    ref = np.asarray(jc.median_filter_2d(jnp.asarray(img), size))
    got = tc.median_filter_2d(_t(img), size).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kshape", [(5, 5), (4, 4), (3, 5)])
def test_correlate_2d_same_matches_jax(kshape):
    # float64 both sides: summation order only.
    rng = np.random.default_rng(3)
    img = rng.normal(0, 1, (2, 11, 14))
    ker = rng.normal(0, 1, kshape)
    ref = np.stack([np.asarray(jc.correlate_2d_same(jnp.asarray(i),
                                                    jnp.asarray(ker)))
                    for i in img])
    got = tc.correlate_2d_same(_t(img), _t(ker)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


def test_candidate_map_matches_jax():
    # float32 median + conv; the Pallas kernel's own bound (rtol 2e-4,
    # atol 5e-2 on maps of ~1e7). The masks agree exactly here.
    img = _planted((64, 80), seed=4)
    cm_j, mask_j = jc.candidate_map(jnp.asarray(img))
    cm_t, mask_t = tc.candidate_map(_t(img))
    np.testing.assert_allclose(cm_t.numpy(), np.asarray(cm_j), rtol=2e-4,
                               atol=5e-2)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("h,w", [(48, 100), (33, 257), (70, 130),
                                 (96, 384)])
def test_kernel_a_twin_matches_jax_recipe_and_pallas_kernel(h, w):
    """candidate_map_plain (kernel A's twin) against the JAX recipe and
    the Pallas kernel in interpret mode, over test_pallas_kernels.py's
    shape sweep (non-128 widths, odd heights, heights not divisible by
    the row block), at the Pallas kernel's own bound."""
    rng = np.random.default_rng(2)
    img = rng.normal(400, 10, (h, w)).astype(np.float32)
    hh, ww = np.indices((h, w)).astype(np.float32)
    img += 3000 * np.exp(-(((hh - h // 2) ** 2) +
                           ((ww - w // 2) ** 2)) / 3.0)
    kern = np.asarray(jc.DEFAULT_CORRELATION_MATRIX, np.float32)
    ref, _ = jc.candidate_map(jnp.asarray(img))
    fused = pallas_candidate_map(jnp.asarray(img), kern, block_rows=16,
                                 interpret=True)
    got = candidate_map_plain(_t(img), kern).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=5e-2)
    np.testing.assert_allclose(got, np.asarray(fused), rtol=2e-4, atol=5e-2)


def test_candidate_map_fused_on_cpu_is_the_twin():
    img = _planted((3, 40, 52), seed=5)
    kern = tc.DEFAULT_CORRELATION_MATRIX
    before = candidate_map_fused.launches
    got = candidate_map_fused(_t(img), kern)
    np.testing.assert_array_equal(got.numpy(),
                                  candidate_map_plain(_t(img), kern).numpy())
    single = candidate_map_fused(_t(img[1]), kern)
    np.testing.assert_array_equal(single.numpy(), got.numpy()[1])
    # Other median sizes / template shapes take the plain recipe, as the
    # JAX package does.
    alt = candidate_map_fused(_t(img), kern[:3, :3], median_filter_size=3)
    ref = np.asarray(jc.candidate_maps_batch(
        jnp.asarray(img), median_filter_size=3,
        correlation_matrix=jc.HashableArray(kern[:3, :3].astype(
            np.float32))))
    np.testing.assert_allclose(alt.numpy(), ref, rtol=2e-4, atol=5e-2)
    assert candidate_map_fused.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        candidate_map_fused(torch.empty((1, 8, 8), device="meta"), kern)


@pytest.mark.parametrize("max_candidates", [16, 64, 40 * 40])
def test_threshold_and_extract_matches_jax(max_candidates):
    # From the SAME correlation maps: the mask, the count, the score order
    # with its index tie-break and the (2, 2) padding must be exact. The
    # 40x40 case needs more slots than pixels (padding path).
    rng = np.random.default_rng(6)
    cms = np.maximum(rng.normal(0, 1, (3, 40, 40)), 0).astype(np.float32)
    ref = jc._threshold_and_extract_batch(jnp.asarray(cms), max_candidates,
                                          2.0)
    got = tc._threshold_and_extract_batch(_t(cms), max_candidates, 2.0)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].dtype == torch.int32 and got[3].dtype == torch.int32
    np.testing.assert_array_equal(
        tc._candidate_mask_batch(_t(cms), 1.5).numpy(),
        np.asarray(jc._candidate_mask_batch(jnp.asarray(cms), 1.5)))


def test_topk_lowest_index_breaks_ties_like_lax_top_k():
    import jax
    x = np.array([[3.0, 1.0, 3.0, -np.inf, 2.0, 3.0, 1.0, -np.inf]],
                 np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 8)
    gv, gi = tc.topk_lowest_index(_t(x), 8)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def test_find_candidates_batch_matches_jax():
    imgs = _planted((2, 64, 96), seed=7, n_spots=10)
    ref = jc.find_candidates_batch(jnp.asarray(imgs), max_candidates=64,
                                   use_pallas=False)
    got = tc.find_candidates_batch(_t(imgs), max_candidates=64)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_gathers_match_jax_including_border_windows():
    img = np.random.default_rng(8).normal(0, 1, (20, 24)).astype(np.float32)
    # Centers on and past the border follow JAX's index rule.
    hs = np.array([2, 10, 17, 0, 19, 5, -1], np.int32)
    ws = np.array([2, 12, 21, 3, 23, 0, 30], np.int32)
    ref = np.asarray(jc.gather_patches(jnp.asarray(img), jnp.asarray(hs),
                                       jnp.asarray(ws), radius=2))
    got = tc.gather_patches(_t(img), _t(hs), _t(ws), radius=2).numpy()
    np.testing.assert_array_equal(got, ref)
    ref = np.asarray(jc.gather_patches_dynslice(
        jnp.asarray(img), jnp.asarray(hs), jnp.asarray(ws), 4))
    got = tc.gather_patches_dynslice(_t(img), _t(hs), _t(ws), 4).numpy()
    np.testing.assert_array_equal(got, ref)
    # The batched form equals the per-image one.
    batch = np.stack([img, img[::-1].copy()])
    hb, wb = np.stack([hs, hs[::-1]]), np.stack([ws, ws[::-1]])
    got_b = tc.gather_patches(_t(batch), _t(hb), _t(wb), radius=2).numpy()
    np.testing.assert_array_equal(
        got_b[1], tc.gather_patches(_t(batch[1]), _t(hb[1]), _t(wb[1]),
                                    radius=2).numpy())


# -- consolidate --------------------------------------------------------------

@pytest.mark.parametrize("radius", [4.0, 2.5])
def test_consolidate_matches_jax_chains_nan_and_ties(radius):
    rng = np.random.default_rng(9)
    n = 96
    ch = rng.uniform(0, 30, n).astype(np.float32)
    cw = rng.uniform(0, 30, n).astype(np.float32)
    # A rival chain spaced under the default radius, an exact boundary pair,
    # NaN and tied R^2 values, and invalid slots.
    ch[:6] = np.float32(50.0)
    cw[:6] = np.arange(6, dtype=np.float32) * 3.5
    ch[6:8], cw[6:8] = np.float32(70.0), np.array([0.0, 4.0], np.float32)
    r2 = rng.uniform(0.5, 1.0, n).astype(np.float32)
    r2[[1, 3, 10]] = np.nan
    r2[[20, 21, 22]] = np.float32(0.9)
    valid = rng.uniform(size=n) > 0.15
    valid[:8] = True
    ref = np.asarray(jcons.consolidate(
        jnp.asarray(ch), jnp.asarray(cw), jnp.asarray(r2),
        jnp.asarray(valid), radius))
    got = tcons.consolidate(_t(ch), _t(cw), _t(r2), _t(valid),
                            radius).numpy()
    np.testing.assert_array_equal(got, ref)
    # Batched images are independent.
    both = tcons.consolidate(_t(np.stack([ch, ch])), _t(np.stack([cw, cw])),
                             _t(np.stack([r2, r2])),
                             _t(np.stack([valid, ~valid])), radius)
    np.testing.assert_array_equal(both.numpy()[0], got)


def test_consolidate_score_ranks_nan_at_minus_inf():
    r2 = np.array([0.5, np.nan, 0.9], np.float32)
    v = np.array([True, True, False])
    np.testing.assert_array_equal(
        tcons._score(_t(r2), _t(v)).numpy(),
        np.asarray(jcons._score(jnp.asarray(r2), jnp.asarray(v))))


# -- registration -------------------------------------------------------------

def _shifted_pair(shape, shift, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, shape)
    f = np.fft.fft2(base)
    ky = np.fft.fftfreq(shape[0])[:, None]
    kx = np.fft.fftfreq(shape[1])[None, :]
    moved = np.real(np.fft.ifft2(f * np.exp(
        -2j * np.pi * (ky * shift[0] + kx * shift[1]))))
    return base.astype(np.float32), moved.astype(np.float32)


@pytest.mark.parametrize("u,shift", [(1, (3.0, -5.0)), (5, (1.4, -2.6)),
                                     (20, (-4.35, 2.15))])
def test_phase_correlate_matches_jax(u, shift):
    # Offsets are quantised to 1/u px: equal on planted shifts. The error
    # and phase are float32 values: rtol 1e-3.
    a, b = _shifted_pair((48, 64), shift, seed=10)
    ref = [np.asarray(x) for x in jr.phase_correlate_jit(
        jnp.asarray(a), jnp.asarray(b), u)]
    got = [x.numpy() for x in tr.phase_correlate_jit(_t(a), _t(b), u)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], -shift[0], atol=1.0 / u)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-3, atol=1e-3)


def test_phase_correlate_stack_and_single_row_guard():
    frames = np.stack([_shifted_pair((32, 40), s, seed=11)[1]
                       for s in [(0, 0), (1.5, 2.0), (-2.0, 0.5)]])
    ref = jr.phase_correlate_stack(jnp.asarray(frames), 10)
    got = tr.phase_correlate_stack(_t(frames)[None], 10)
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy()[0], np.asarray(r))
    # Two-row images: mid_row == 1 forces the row shift to 0.
    rng = np.random.default_rng(12)
    a = rng.normal(0, 1, (2, 32)).astype(np.float32)
    b = np.roll(a, 3, axis=1)
    ref = jr.phase_correlate_jit(jnp.asarray(a), jnp.asarray(b), 4)
    got = tr.phase_correlate_jit(_t(a), _t(b), 4)
    assert float(got[0]) == float(ref[0]) == 0.0
    assert float(got[1]) == float(ref[1])


def test_complex_argmax_is_lexicographic():
    z = np.zeros((2, 3), np.complex64)
    z[0, 1] = 2 + 1j
    z[1, 2] = 2 + 3j   # same real part, larger imaginary part wins
    assert int(tr._complex_argmax(_t(z))) == 5


# -- photometry ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["mexican_hat", "simple", "maximum"])
def test_photometry_matches_jax(method):
    # float32 sums of up to 361 pixels in another order: rtol 1e-5. The
    # brim median (312 values, even) averages the two middle values.
    img = _planted((48, 56), seed=13, n_spots=8)
    rng = np.random.default_rng(14)
    hs = rng.integers(9, 48 - 9, 20).astype(np.int32)
    ws = rng.integers(9, 56 - 9, 20).astype(np.int32)
    args = (jnp.asarray(img), jnp.asarray(hs), jnp.asarray(ws))
    targs = (_t(img), _t(hs), _t(ws))
    if method == "mexican_hat":
        ref = jp.mexican_hat_batch(*args, brim_size=6, radius=9)
        got = tp.mexican_hat_batch(*targs, brim_size=6, radius=9)
    elif method == "simple":
        ref = jp.simple_batch(*args, radius=2)
        got = tp.simple_batch(*targs, radius=2)
    else:
        ref = jp.maximum_batch(*args, radius=5, top=3)
        got = tp.maximum_batch(*targs, radius=5, top=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-2)


def test_photometry_index_sets_match_jax():
    np.testing.assert_array_equal(tp.crown_flat_indices(9, 6),
                                  jp.crown_flat_indices(9, 6))
    np.testing.assert_array_equal(tp.brim_flat_indices(9, 6),
                                  jp.brim_flat_indices(9, 6))
    # A 3x3 window with a 1-px brim: 8 brim pixels, an even count, whose
    # median is the midpoint (torch.median would take the lower value).
    patch = np.array([[0, 9, 2, 7, 100, 3, 5, 1, 8]], np.float32)
    red = tp.patch_reduction("mexican_hat", 1, brim_size=1)
    ref = np.asarray(jp.patch_reduction("mexican_hat", 1, brim_size=1)(
        jnp.asarray(patch)))
    np.testing.assert_array_equal(red(_t(patch)).numpy(), ref)
    assert float(ref[0]) == 100.0 - 4.0
    with pytest.raises(ValueError):
        tp.patch_reduction("nope", 2)
