"""Spot and Image: the object layer, and the SExtractor host numerics.

Counterpart of fluorosequencingimageanalysis_tpu/pipeline/spots.py, whose
numpy code is copied (tests/test_torch_import.py holds the copies equal to
it): ``Spot``, ``CircularAperture`` and ``Image`` with the reference's API
(flexlibrary.py:74-506), the sigma clip, the SExtractor mode, the mesh
background (the float64 oracle that ops/background.py is held against) and
the exact circular-aperture sums of the ``sextractor`` photometry method.

An ``Image`` measures all of its spots for one (method, parameters) at once
on the device (``ops/photometry.py``) and caches the values, so a per-spot
``Spot.photometry`` call is a lookup; edge spots (truncated squares) take
the exact host functions. The image's array is uploaded once per device
and kept with it (``Image.device_image``). The device is the process
default, ``_device.default_device()`` ("cuda" unless ``FSIA_TORCH_DEVICE``
or ``set_default_device`` names another): the reference's classes take no
device argument.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .._device import default_device, resolve_device
from ..ops import photometry as photometry_ops
from ..utils import profiling
from ..utils.rounding import py2_round

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


class Spot:
    """A square of pixels possibly containing a luminescent spot.

    Parity: flexlibrary.py:74-321. gaussian_fit follows the
    pflib 12-tuple convention (h_0, w_0, H, A, sigma_h, sigma_w, theta,
    sub_img, fit_img, rmse, r_2, s_n).
    """

    def __init__(self, parent_Image, h, w, size, gaussian_fit=None):
        self.parent_Image = parent_Image
        if size % 2 == 0:
            raise AttributeError("Spot.size must be odd.")
        self.size = size
        r = (size - 1) // 2
        shape = parent_Image.image.shape
        if not (0 <= h - r and h + r < shape[0] and
                0 <= w - r and w + r < shape[1]):
            if (gaussian_fit is None or not
                (r <= gaussian_fit[0] < shape[0] - r) and
                    (r <= gaussian_fit[1] < shape[1] - r)):
                raise AttributeError(
                    "Spot area of size " + str(size) + " at " + str((h, w)) +
                    " with gaussian_fit " + str(gaussian_fit) +
                    " does not fit into parent_Image.image.shape of " +
                    str(shape))
        self.h, self.w = h, w
        self.gaussian_fit = gaussian_fit

    def image_slice(self, radius=None):
        if radius is None:
            radius = (self.size - 1) // 2
        img = self.parent_Image.image
        return img[max(0, self.h - radius):
                   min(img.shape[0], self.h + radius + 1),
                   max(0, self.w - radius):
                   min(img.shape[1], self.w + radius + 1)]

    def valid_slice(self, radius=None):
        if radius is None:
            radius = (self.size - 1) // 2
        sl = self.image_slice(radius=radius)
        return sl.shape[0] == sl.shape[1] == 2 * radius + 1

    # -- photometry metrics (parity: flexlibrary.py:160-317) ---------------

    def simple_photometry_metric(self, return_invalid=True):
        if not return_invalid and not self.valid_slice():
            return None
        return self.parent_Image._spot_photometry(self, "simple", {})

    def mexican_hat_photometry_metric(self, brim_size=6, radius=9,
                                      return_invalid=True):
        if radius is None:
            radius = (self.size - 1) // 2
        if not return_invalid and not self.valid_slice(radius=radius):
            return None
        return self.parent_Image._spot_photometry(
            self, "mexican_hat", {"brim_size": brim_size, "radius": radius})

    def gaussian_volume_photometry_metric(self, scaling=10 ** 6, default=0,
                                          return_invalid=True):
        if not return_invalid and not self.valid_slice():
            return None
        if self.gaussian_fit is None:
            return default
        return (float(scaling) * self.gaussian_fit[3] *
                self.gaussian_fit[4] * self.gaussian_fit[5])

    def gaussian_sigmas_photometry_metric(self, scaling=10 ** 6,
                                          return_invalid=True):
        # Parity note (flexlibrary.py:232-241): the reference checks
        # valid_slice but then unconditionally falls through to the
        # gaussian_fit branch; the fit-less default is -1e9.
        if self.gaussian_fit is None:
            return -10 ** 9
        return (float(scaling) * self.gaussian_fit[4] * self.gaussian_fit[5])

    def sextractor_photometry_metric(self, radius=3, box_size=10,
                                     filter_size=10, return_invalid=True,
                                     **kwargs):
        if not return_invalid and not self.valid_slice(radius=radius):
            return None
        data = self.parent_Image.get_background_subtracted(
            box_size=box_size, filter_size=filter_size)
        return _aperture_sum(data, self.h, self.w, radius)

    def maximum_photometry_metric(self, radius=5, top=1,
                                  background_adjust="none",
                                  return_invalid=True):
        if not return_invalid and not self.valid_slice(radius=radius):
            return None
        return photometry_ops.maximum_host(self.parent_Image.image, self.h,
                                           self.w, radius=radius, top=top,
                                           background_adjust=background_adjust)

    def photometry(self, method="mexican_hat", photometry_method=None,
                   return_invalid=True, **kwargs):
        if photometry_method is not None:
            method = photometry_method
        if method == "mexican_hat":
            return self.mexican_hat_photometry_metric(
                return_invalid=return_invalid, **kwargs)
        elif method == "gaussian_volume":
            return self.gaussian_volume_photometry_metric(
                return_invalid=return_invalid, **kwargs)
        elif method == "simple":
            return self.simple_photometry_metric(
                return_invalid=return_invalid, **kwargs)
        elif method == "sextractor":
            return self.sextractor_photometry_metric(
                return_invalid=return_invalid, **kwargs)
        elif method == "maximum":
            return self.maximum_photometry_metric(
                return_invalid=return_invalid, **kwargs)
        elif method == "sigmas":
            return self.gaussian_sigmas_photometry_metric(
                return_invalid=return_invalid, **kwargs)
        raise ValueError("Uknown method specified.")

    def illumina_s_n(self):
        # Host NumPy (called per-spot inside tracking loops; a device
        # dispatch per spot would dominate). Same math as
        # ops.quality.illumina_s_n / pflib.py:261-281.
        sl = np.asarray(self.image_slice(), dtype=np.float64)
        if sl.ndim != 2 or sl.shape[0] != sl.shape[1]:
            # Truncated edge slices must raise like the reference
            # (pflib.py:275-277), not yield a number the gates act on.
            raise ValueError("sub_img must be square, but has shape " +
                             str(sl))
        # Element ORDER matters for bit parity: the reference builds
        # top row, bottom row, then (left, right) PER interior row
        # (pflib.py:278-280); numpy's pairwise mean/std are order-
        # sensitive, and the value feeds the discrete s_n < cutoff
        # tracking gate. sl[1:-1, [0, -1]].ravel() is exactly that
        # per-row interleaving.
        edge = np.concatenate([sl[0, :], sl[-1, :],
                               sl[1:-1, [0, -1]].ravel()])
        # Saturated-flat edges have std == 0; the reference divides by it
        # anyway (pflib.py:281) and yields nan (flat patch: 0/0) or inf —
        # values the s_n < cutoff gates compare against as-is. Keep the
        # value (reference parity, pinned in tests/test_compat.py) but
        # suppress numpy's RuntimeWarning from leaking into user runs.
        with np.errstate(divide="ignore", invalid="ignore"):
            return float((sl.max() - edge.mean()) / edge.std())


class CircularAperture:
    """Minimal photutils.CircularAperture stand-in: (w, h) positions plus
    radius, enough for the Image.photometry_apertures cache contract
    (flexlibrary.py:477-486)."""

    def __init__(self, positions, r):
        self.positions = np.asarray(positions, dtype=float)
        self.r = float(r)

    def __repr__(self):
        return f"CircularAperture(positions={self.positions.tolist()}, " \
               f"r={self.r})"


class Image:
    """A fluorosequencing image, its metadata, and its Spots.

    Parity: flexlibrary.py:323-506. The photutils background/
    aperture caches are replaced by (a) a batched-photometry cache and (b) a
    SExtractor-style background mesh estimator (see get_photometry_background).
    """

    def __init__(self, image=None, metadata=None, spots=None,
                 photometry_background=None, photometry_apertures=None):
        self.metadata = metadata if metadata is not None else {}
        if image is not None:
            self.image = np.asarray(image)
        elif "filepath" in self.metadata:
            from ..utils.imageio import read_image_array
            self.image = read_image_array(self.metadata["filepath"])
        else:
            raise AttributeError(
                "Image.image must be defined: it was neither passed at "
                "initialization nor given a filepath to be read from.")
        self.spots = list(spots) if spots is not None else []
        self.photometry_background = (photometry_background
                                      if photometry_background is not None
                                      else {})
        self.photometry_apertures = (photometry_apertures
                                     if photometry_apertures is not None
                                     else {})
        # {(method, kwargs_key): {id(spot): value}}
        self._photometry_cache = {}

    def find_gaussian_psfs(self, pflib_args=None, spots_append=True):
        """Run the spot finder on this image (flexlibrary.py:426-455), on
        the process default device unless ``pflib_args`` names one."""
        from ..models.detect import find_peptides
        if pflib_args is None:
            pflib_args = {}
        new_fits = find_peptides(self.image, **pflib_args)
        if not spots_append:
            self.spots = []
        for (h, w), new_fit in new_fits.items():
            self.spots.append(Spot(self, py2_round(h), py2_round(w), 5,
                                   gaussian_fit=new_fit))
        return len(new_fits)

    # -- batched photometry ------------------------------------------------

    @staticmethod
    def _required_radius(method, kwargs):
        # 'simple' never reaches here: _spot_radius short-circuits it to
        # the per-spot (size - 1) // 2 rule before consulting this table.
        if method == "mexican_hat":
            return kwargs.get("radius", 9)
        if method == "maximum":
            return kwargs.get("radius", 5)
        return 0

    def _spot_photometry(self, spot, method, kwargs):
        """Batched-with-cache photometry for one spot.

        The cache stores (spot, value) so a hit is honored only when the
        entry's spot IS the caller (a recycled id() from a dead Spot can
        never return a stale value). Spots not in self.spots (supported
        by the reference, which has no cache) are measured individually
        on the host path. Note: in-place mutation of self.image after a
        measurement will serve cached values; call photometry_cache_clear
        (or rebuild the Image) after mutating, as the reference recomputes
        per call.

        A miss measures only the listed spots the cache lacks: all of them
        the first time, then those appended since (the interpolated spots
        of fill_in_trace arrive one by one; re-measuring the whole image
        for each would cost a full batch per hole)."""
        key = (method, tuple(sorted(kwargs.items())))
        cache = self._photometry_cache.setdefault(key, {})
        hit = cache.get(id(spot))
        if hit is None or hit[0] is not spot:
            missing = [s for s in self.spots
                       if cache.get(id(s), (None,))[0] is not s]
            cache.update(self._compute_photometries(method, kwargs,
                                                    missing))
            hit = cache.get(id(spot))
        if hit is None or hit[0] is not spot:
            radius = self._spot_radius(spot, method, kwargs)
            value = self._host_photometry(spot, method, kwargs, radius)
            # Cache the un-listed spot too (identity-pinned like every
            # entry): otherwise each repeat query on a spot outside
            # self.spots would rebuild the FULL batched cache above just
            # to miss again — N queries costing N whole-image dispatches.
            cache[id(spot)] = (spot, value)
            return value
        return hit[1]

    def photometry_cache_clear(self):
        """Drop the batched photometry cache (after mutating .image)."""
        self._photometry_cache = {}
        self._device_images = {}

    def device_image(self):
        """``self.image`` as float32 on the process default device
        (``_device.default_device()``): uploaded once per device and kept
        with the image while ``self.image`` is the same array (assigning
        another array uploads it anew; after mutating the array in place
        call photometry_cache_clear)."""
        dev = resolve_device(default_device())
        cache = self.__dict__.setdefault("_device_images", {})
        hit = cache.get(dev)
        if hit is None or hit[0] is not self.image:
            host = np.ascontiguousarray(self.image, dtype=np.float32)
            hit = (self.image, torch.from_numpy(host).to(dev))
            cache[dev] = hit
        return hit[1]

    def __getstate__(self):
        # A pickled Image (inside pickled traces) carries no device copy:
        # it loads on a machine without the device.
        state = dict(self.__dict__)
        state.pop("_device_images", None)
        return state

    def _spot_radius(self, spot, method, kwargs):
        if method == "simple":
            # The reference's simple metric sums the spot's OWN slice
            # (flexlibrary.py:160-170): radius follows spot.size.
            return (spot.size - 1) // 2
        return self._required_radius(method, kwargs)

    def _host_photometry(self, spot, method, kwargs, radius):
        """Exact host-path measurement of one spot (edge fallbacks)."""
        if method == "mexican_hat":
            return float(photometry_ops.mexican_hat_host(
                self.image, spot.h, spot.w,
                brim_size=kwargs.get("brim_size", 6), radius=radius))
        if method == "simple":
            return float(photometry_ops.simple_host(self.image, spot.h,
                                                    spot.w, radius=radius))
        if method == "maximum":
            return float(photometry_ops.maximum_host(
                self.image, spot.h, spot.w, radius=radius,
                top=kwargs.get("top", 1),
                background_adjust=kwargs.get("background_adjust", "none")))
        raise ValueError(method)

    def _compute_photometries(self, method, kwargs, spots=None):
        """Measure ``spots`` (None: every current spot) in one batched
        dispatch (one per distinct window radius — 'simple' follows each
        spot's size), timed as the ``objects/photometry`` stage."""
        with profiling.stage("objects/photometry"):
            if method == "maximum":
                # Validate ONCE for every spot, so interior and edge spots
                # behave identically (the host path / reference raise on
                # 'multiplicative', flexlibrary.py:275-284).
                ba = kwargs.get("background_adjust", "none")
                if ba == "multiplicative":
                    raise NotImplementedError(
                        "Not sure what to do if median is 0. This may be a "
                        "poor metric.")
                if ba not in ("none", "additive"):
                    raise ValueError(str(ba) + " is not a valid option.")
            batch_top0 = method == "maximum" and kwargs.get("top", 1) == 0
            interior, edge = {}, []
            H, W = self.image.shape[:2]
            for s in self.spots if spots is None else spots:
                radius = self._spot_radius(s, method, kwargs)
                # top=0 must keep the reference's Py2 slice quirk ([-0:] is
                # the WHOLE window) for every spot — host path only.
                if (not batch_top0 and radius <= s.h < H - radius
                        and radius <= s.w < W - radius):
                    interior.setdefault(radius, []).append(s)
                else:
                    edge.append(s)
            values = {}
            img = None
            for radius, group in interior.items():
                if img is None:
                    img = self.device_image()
                hs = torch.tensor([s.h for s in group], dtype=torch.int64,
                                  device=img.device)
                ws = torch.tensor([s.w for s in group], dtype=torch.int64,
                                  device=img.device)
                if method == "mexican_hat":
                    out = photometry_ops.mexican_hat_batch(
                        img, hs, ws, brim_size=kwargs.get("brim_size", 6),
                        radius=radius)
                elif method == "simple":
                    out = photometry_ops.simple_batch(img, hs, ws,
                                                      radius=radius)
                elif method == "maximum":
                    out = photometry_ops.maximum_batch(
                        img, hs, ws, radius=radius, top=kwargs.get("top", 1),
                        median_adjust=(kwargs.get("background_adjust", "none")
                                       == "additive"))
                else:
                    raise ValueError(method)
                out = out.cpu().numpy().astype(np.float64)
                for s, v in zip(group, out):
                    values[id(s)] = (s, float(v))
            for s in edge:
                radius = self._spot_radius(s, method, kwargs)
                values[id(s)] = (s, self._host_photometry(s, method, kwargs,
                                                          radius))
            return values

    def get_photometry_aperture(self, spot, radius=3):
        """Cached per-spot circular aperture (flexlibrary.py:472-496).

        The reference caches photutils.CircularAperture objects; photutils
        is not a dependency here, so a lightweight stand-in with the same
        (positions, r) attributes is cached under the same
        ``photometry_apertures[radius]`` contract.
        """
        if radius not in self.photometry_apertures or \
                len(self.photometry_apertures[radius]) != len(self.spots):
            # In photutils the coordinates are swapped: (w, h).
            self.photometry_apertures[radius] = [
                CircularAperture([s.w, s.h], r=radius) for s in self.spots]
        for i, s in enumerate(self.spots):
            if spot is s:
                return self.photometry_apertures[radius][i]
        raise Exception("argument spot not in self.spots; locals() = " +
                        str(locals()))

    # -- background estimation (sextractor metric support) -----------------

    def get_photometry_background(self, box_size=10, filter_size=10,
                                  method="sextractor"):
        """SExtractor-style mesh background (cached per parameters).

        Stand-in for photutils.background.Background
        (flexlibrary.py:457-470): per-box background = 2.5*median - 1.5*mean
        (the SExtractor mode estimator), median-filtered mesh, bilinear
        upsample to full resolution. Returns the background ARRAY.
        """
        key = (box_size, filter_size, method)
        if key not in self.photometry_background:
            self.photometry_background[key] = _mesh_background(
                self.image, box_size, filter_size)
        return self.photometry_background[key]

    def get_background_subtracted(self, box_size=10, filter_size=10):
        """image - sextractor background, cached: N spots on one image
        must not pay N full-frame subtractions."""
        key = ("subtracted", box_size, filter_size)
        if key not in self.photometry_background:
            self.photometry_background[key] = (
                self.image - self.get_photometry_background(
                    box_size=box_size, filter_size=filter_size,
                    method="sextractor"))
        return self.photometry_background[key]

    def append_photometry_apertures(self):
        """Cache-coherence hook after appending a Spot (flexlibrary.py:498).

        Our photometry cache recomputes lazily when it misses a spot, so this
        only needs to exist for API parity.
        """
        return self.photometry_apertures






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
