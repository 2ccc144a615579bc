"""SExtractor photometry, the host numerics.

Counterpart of the numpy/scipy functions of
fluorosequencingimageanalysis_tpu/pipeline/spots.py, copied: the sigma
clip, the SExtractor mode, the mesh background (the float64 oracle that
ops/background.py is held against) and the exact circular-aperture sums of
the ``sextractor`` photometry method. The ``Spot``, ``Image`` and
``CircularAperture`` classes of that module are not ported.
"""

from __future__ import annotations

import numpy as np


def sigma_clip_boxes(boxes, sigma=3.0, maxiters=10):
    """Vectorized astropy-style sigma clipping over (N, P) box rows.

    Iteratively rejects values outside median +- sigma*std (population
    std, median-centered — astropy.stats.SigmaClip defaults, the clipper
    photutils' Background2D applies per box) until no value is rejected
    or maxiters passes. Returns a float64 copy with rejected entries NaN.
    """
    data = np.array(boxes, dtype=np.float64)
    for _ in range(maxiters):
        med = np.nanmedian(data, axis=-1, keepdims=True)
        std = np.nanstd(data, axis=-1, keepdims=True)
        bad = (data < med - sigma * std) | (data > med + sigma * std)
        if not bad.any():
            break
        data[bad] = np.nan
    return data


def sextractor_mode(clipped):
    """photutils.background.SExtractorBackground over (N, P) sigma-clipped
    (NaN-masked) box rows: mode = 2.5*median - 1.5*mean, falling back to
    the median in crowded boxes (|mean - median|/std > 0.3) and to the
    mean when std == 0 — the actual SExtractor estimator the reference's
    ``method='sextractor'`` selects (flexlibrary.py:457-470), NOT a plain
    box median."""
    med = np.nanmedian(clipped, axis=-1)
    mean = np.nanmean(clipped, axis=-1)
    std = np.nanstd(clipped, axis=-1)
    mode = 2.5 * med - 1.5 * mean
    crowded = np.abs(mean - med) > 0.3 * std
    return np.where(std == 0, mean, np.where(crowded, med, mode))


def _mesh_background(image, box_size, filter_size):
    """SExtractor background map, photutils-Background-style
    (flexlibrary.py:457-470 calls photutils.background.Background with
    method='sextractor'):

    1. pad the image to a box_size multiple by edge replication
       (photutils' edge_method='pad'),
    2. per box: 3-sigma clip (median-centered, <=10 iters), then the
       SExtractor mode estimator (see sextractor_mode),
    3. median-filter the low-resolution mesh (filter_size, scipy default
       'reflect' edges),
    4. cubic-spline zoom the mesh back to full resolution with box
       centers as knots (scipy zoom, order=3, mode='reflect',
       grid_mode=True — the BkgZoomInterpolator recipe), crop the pad.

    tests/photutils_oracle.py holds an independent scalar implementation
    of the same spec, which tests/test_sextractor_numerics.py holds the JAX
    package's copy of this function against.
    """
    image = np.asarray(image, dtype=np.float64)
    H, W = image.shape
    nh = max(1, int(np.ceil(H / box_size)))
    nw = max(1, int(np.ceil(W / box_size)))
    padded = np.pad(image, ((0, nh * box_size - H), (0, nw * box_size - W)),
                    mode="edge")
    boxes = padded.reshape(nh, box_size, nw, box_size) \
        .transpose(0, 2, 1, 3).reshape(nh * nw, box_size * box_size)
    mesh = sextractor_mode(sigma_clip_boxes(boxes)).reshape(nh, nw)
    from scipy.ndimage import median_filter, zoom
    k = min(filter_size, nh, nw)
    if k > 1:
        mesh = median_filter(mesh, size=k)
    if nh == 1 and nw == 1:
        return np.full((H, W), mesh[0, 0])
    # Per-axis spline order: an axis with few boxes only degrades ITS
    # order (a spline of order k needs k+1 knots), not the other's — a
    # 1xN strip mesh still interpolates cubically along its long axis.
    # Tensor-product spline interpolation is separable, so two 1-D
    # zoom passes equal the single 2-D call when the orders agree.
    order_h = min(3, nh - 1)
    order_w = min(3, nw - 1)
    if order_h == order_w:
        up = zoom(mesh, box_size, order=order_h,
                  mode="reflect", grid_mode=True)
    else:
        up = zoom(mesh, (1.0, float(box_size)), order=order_w,
                  mode="reflect", grid_mode=True)
        up = zoom(up, (float(box_size), 1.0), order=order_h,
                  mode="reflect", grid_mode=True)
    return up[:H, :W]


def sextractor_aperture_sums(image, hs, ws, aperture_radius,
                             box_size, filter_size):
    """SExtractor photometry of one image at integer centers (hs, ws):
    subtract the mesh background (_mesh_background), then measure every
    center as one windowed dot product with the exact circular-overlap
    kernel (_aperture_fracs) — flexlibrary.py:243-262 semantics, edge
    truncation included via zero padding (outside pixels contribute
    nothing to an aperture sum either way).

    Used by the experiment path (fast_experiment.run_experiment_stack).
    Returns float64 [len(hs)].
    """
    fr = _aperture_fracs(aperture_radius)
    r_int = (fr.shape[0] - 1) // 2
    dd = np.arange(-r_int, r_int + 1)
    image = np.asarray(image)
    hs = np.asarray(hs)
    ws = np.asarray(ws)
    H, W = image.shape[:2]
    if len(hs) and (hs.min() < 0 or hs.max() >= H or
                    ws.min() < 0 or ws.max() >= W):
        # Negative centers would WRAP through the padded array (Python
        # negative indexing) into the opposite border — a silently wrong
        # aperture sum. Callers track in-frame positions; anything else
        # is a bug upstream, so fail loudly.
        raise ValueError("aperture centers must lie inside the image")
    data = (image.astype(np.float64)
            - _mesh_background(image, box_size, filter_size))
    padded = np.pad(data, r_int)
    hs = hs + r_int
    ws = ws + r_int
    wins = padded[hs[:, None, None] + dd[None, :, None],
                  ws[:, None, None] + dd[None, None, :]]
    return np.einsum("nij,ij->n", wins, fr)


_APERTURE_FRAC_CACHE = {}


def _circle_pixel_area(x0, x1, y0, y1, r):
    """EXACT area of circle(0, 0, r) ∩ [x0, x1] x [y0, y1].

    Closed form: the vertical extent at abscissa t inside the circle is
    L(t) = min(y1, g(t)) - max(y0, -g(t)) with g(t) = sqrt(r^2 - t^2);
    the integral splits at the abscissae where g crosses |y0| or |y1|
    (all sign changes of L occur at those same points), and on each
    piece both branches are a constant or the circular arc, whose
    antiderivative is (t*g + r^2*asin(t/r))/2.
    """
    a, b = max(x0, -r), min(x1, r)
    if a >= b:
        return 0.0
    cuts = {a, b}
    for y in (y0, y1):
        if abs(y) < r:
            s = float(np.sqrt(r * r - y * y))
            for t in (-s, s):
                if a < t < b:
                    cuts.add(t)
    cuts = sorted(cuts)

    def gi(t):  # antiderivative of g
        return 0.5 * (t * np.sqrt(max(r * r - t * t, 0.0))
                      + r * r * np.arcsin(np.clip(t / r, -1.0, 1.0)))

    area = 0.0
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        mid = 0.5 * (lo + hi)
        g_mid = np.sqrt(max(r * r - mid * mid, 0.0))
        top = min(y1, g_mid)
        bot = max(y0, -g_mid)
        if top <= bot:
            continue
        seg = gi(hi) - gi(lo)
        area += (y1 * (hi - lo) if y1 < g_mid else seg) \
            - (y0 * (hi - lo) if y0 > -g_mid else -seg)
    return float(area)


def _aperture_fracs(radius, subsample=None):
    """(2r+3)^2 pixel-overlap fractions for an integer-centered circular
    aperture — position-independent, so computed once per (radius,
    subsample). subsample=None (default) computes the EXACT analytic
    circle-pixel overlap areas — photutils aperture_photometry's default
    method='exact', which is what the reference's sextractor metric uses
    (flexlibrary.py:257-259); an integer subsamples each pixel
    (method='subpixel')."""
    key = (float(radius), subsample)
    if key not in _APERTURE_FRAC_CACHE:
        r_int = int(np.ceil(radius)) + 1
        if subsample is None:
            d = np.arange(-r_int, r_int + 1)
            fr = np.array([[_circle_pixel_area(x - 0.5, x + 0.5,
                                               y - 0.5, y + 0.5, radius)
                            for x in d] for y in d])
        else:
            offs = (np.arange(subsample) + 0.5) / subsample - 0.5
            d = np.arange(-r_int, r_int + 1)
            dy = d[:, None, None, None] + offs[None, None, :, None]
            dx = d[None, :, None, None] + offs[None, None, None, :]
            fr = np.mean(dy ** 2 + dx ** 2 <= radius ** 2, axis=(2, 3))
        _APERTURE_FRAC_CACHE[key] = fr
    return _APERTURE_FRAC_CACHE[key]


def _aperture_sum(image, h, w, radius, subsample=None):
    """Circular-aperture sum with exact subpixel overlap (photutils
    aperture_photometry stand-in, method='exact' by default).

    For integer centers the overlap kernel is position-independent, so
    the sum is one windowed dot product (a per-pixel scalar loop was
    ~1 ms per call — prohibitive at spots x frames scale)."""
    image = np.asarray(image, dtype=np.float64)
    fr = _aperture_fracs(radius, subsample)
    r_int = (fr.shape[0] - 1) // 2
    h0, h1 = max(0, h - r_int), min(image.shape[0], h + r_int + 1)
    w0, w1 = max(0, w - r_int), min(image.shape[1], w + r_int + 1)
    win = image[h0:h1, w0:w1]
    k = fr[h0 - (h - r_int):fr.shape[0] - ((h + r_int + 1) - h1),
           w0 - (w - r_int):fr.shape[1] - ((w + r_int + 1) - w1)]
    return float(np.sum(win * k))
