"""SExtractor mesh background estimation over image stacks, on one device
or split over a device list.

Counterpart of fluorosequencingimageanalysis_tpu/ops/background.py: the
device form of the host ``pipeline.spots._mesh_background`` (the photutils
``Background`` stand-in of the sextractor photometry metric; reference call
site flexlibrary.py:446-486). The whole estimator runs over a
``[frames, H, W]`` stack in plain torch:

- per-box sigma clipping and the SExtractor mode estimator are masked
  reductions over all (frame, box) rows at once; exactly ``clip_maxiters``
  rounds run (a box with nothing left to reject is a fixpoint of the
  update, so this equals the host's early-exit loop and needs no host read
  per round);
- the mesh median filter is a reflect-index gather + sort (scipy
  ``median_filter`` rank convention: element ``k*k // 2`` of the sorted
  window, window spanning ``[i - k//2, i + (k-1)//2]``);
- the cubic ``BkgZoomInterpolator`` upsample is two float32 matrix
  products against host-precomputed spline basis matrices:
  ``scipy.ndimage.zoom`` is linear in the mesh, so applying it to basis
  meshes once per (nh, nw, box_size) yields matrices that reproduce it
  (TF32 is pinned off in ``_device``).

``pairwise_zoom_bases`` and ``reflect_window_index`` are the JAX package's,
copied (numpy and scipy).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import is_device_list, resolve_device, shares

_REFLECT_INDEX_CACHE: dict = {}
_PAIR_BASIS_CACHE: dict = {}
# Device copies of the zoom bases and window indices, keyed by their host
# key, the device and the dtype.
_DEVICE_CACHE: dict = {}


def pairwise_zoom_bases(nh: int, nw: int, box_size: int) -> tuple:
    """(A_h [nh*box, nh], A_w [nw*box, nw]) reproducing the host mesh
    upsample (pipeline.spots._mesh_background's zoom branch) as two
    matmuls, exactly.

    The host recipe is per-axis spline orders min(3, n-1) via one 2-D
    zoom (equal orders) or two sequential passes (mixed orders). Either
    way the operator is verified-linear and EXACTLY separable (rank-1 in
    the (h,i)x(w,j) pairing, checked by SVD of the full small-case
    operator) — but its axis factors include scipy's approximate IIR
    prefilter boundary handling (error ~pole^n on short axes: 1.7e-3 at
    n=2 for cubic), which a plain per-axis 1-D zoom basis does not
    capture; the defect even breaks exact constant reproduction
    (zoom(ones) != ones at the boundary). So each factor is extracted
    from the actual host computation with single-box basis meshes
    against a fixed reference box: f(e_i x e_j0)[:, w0] = A_h[:, i] *
    A_w[w0, j0] isolates A_h's columns up to ONE shared scalar
    (symmetrically for A_w), and that scalar — the tensor element
    A_h[h0, i0]*A_w[w0, j0] = f(e_i0 x e_j0)[h0, w0] — divides out.
    Cached per (nh, nw, box_size); float64.
    """
    key = (nh, nw, box_size)
    if key not in _PAIR_BASIS_CACHE:
        from scipy.ndimage import zoom

        order_h = min(3, nh - 1)
        order_w = min(3, nw - 1)

        def host_zoom(mesh):
            # Mirror of pipeline.spots._mesh_background's branch.
            if order_h == order_w:
                return zoom(mesh, box_size, order=order_h,
                            mode="reflect", grid_mode=True)
            up = zoom(mesh, (1.0, float(box_size)), order=order_w,
                      mode="reflect", grid_mode=True)
            return zoom(up, (float(box_size), 1.0), order=order_h,
                        mode="reflect", grid_mode=True)

        # Reference box at the mesh center, sampled at its center pixel
        # (the spline basis peaks there — well-conditioned division).
        i0, j0 = nh // 2, nw // 2
        h0 = i0 * box_size + box_size // 2
        w0 = j0 * box_size + box_size // 2

        def basis(i, j):
            m = np.zeros((nh, nw))
            m[i, j] = 1.0
            return host_zoom(m)

        Ah = np.empty((nh * box_size, nh), np.float64)
        for i in range(nh):
            Ah[:, i] = basis(i, j0)[:, w0]      # A_h[:, i] * A_w[w0, j0]
        Aw = np.empty((nw * box_size, nw), np.float64)
        for j in range(nw):
            Aw[:, j] = basis(i0, j)[h0, :]      # A_w[:, j] * A_h[h0, i0]
        gamma = Ah[h0, i0]                       # = A_h[h0,i0] * A_w[w0,j0]
        Ah /= gamma                              # divides the shared scale
        # Loud build-time check of the tensor factorization on a random
        # mesh (never silently wrong if a scipy version breaks the
        # per-axis structure).
        probe = np.random.default_rng(0).normal(size=(nh, nw))
        want = host_zoom(probe)
        got = Ah @ probe @ Aw.T
        err = np.abs(want - got).max() / max(1.0, np.abs(want).max())
        if err > 1e-10:
            raise AssertionError(
                f"zoom basis factorization failed for {key}: {err}")
        _PAIR_BASIS_CACHE[key] = (Ah, Aw)
    return _PAIR_BASIS_CACHE[key]


def reflect_window_index(n: int, k: int) -> np.ndarray:
    """[n, k] int32 gather map for a size-k scipy filter window along an
    axis of length n with mode='reflect' ((d c b a | a b c d | d c b a),
    scipy's default boundary). Window offsets follow scipy's even-size
    origin convention: [i - k//2, i + (k-1)//2]."""
    key = (n, k)
    if key not in _REFLECT_INDEX_CACHE:
        idx = np.arange(n)[:, None] + (np.arange(k) - k // 2)[None, :]
        p = np.mod(idx, 2 * n)
        _REFLECT_INDEX_CACHE[key] = np.where(
            p < n, p, 2 * n - 1 - p).astype(np.int32)
    return _REFLECT_INDEX_CACHE[key]


def widen(stack, dtype=torch.float32):
    """``stack`` in the float ``dtype``. uint16 (torch has no arithmetic
    on it) is read through an int16 view and widened with ``& 0xFFFF``,
    bit-exact."""
    if stack.dtype == dtype:
        return stack
    if stack.dtype == torch.uint16:
        return (stack.view(torch.int16).to(torch.int32) & 0xFFFF).to(dtype)
    return stack.to(dtype)


def _to_device(array, device):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _over_frames(fn, stack, device):
    """``fn`` over the frames of a [T, H, W] or [H, W] ``stack`` split
    into contiguous shares, one per data device of the device list or
    ``Mesh`` ``device``: each share goes to its device (tensor or array),
    every share's ``fn`` is enqueued before any result is gathered, and
    the results return in frame order on the first data device."""
    if not isinstance(stack, torch.Tensor):
        stack = np.asarray(stack)
    single = stack.ndim == 2
    frames = stack[None] if single else stack
    spans = shares(frames.shape[0], device)
    parts = [fn(frames[lo:hi].to(d) if isinstance(frames, torch.Tensor)
                else _to_device(frames[lo:hi], d)) for lo, hi, d in spans]
    out = torch.cat([p.to(spans[0][2]) for p in parts])
    return out[0] if single else out


def _on_device(kind, key, build, device, dtype):
    """The host table ``build()`` as a tensor on ``device``, cached."""
    ck = (kind, key, str(device), dtype)
    if ck not in _DEVICE_CACHE:
        _DEVICE_CACHE[ck] = torch.as_tensor(build(), dtype=dtype,
                                            device=device)
    return _DEVICE_CACHE[ck]


def _masked_median(v, valid):
    """np.nanmedian over the last axis with ``valid`` as the non-NaN mask
    (averages the two middle elements for even valid counts)."""
    s = torch.sort(torch.where(valid, v, torch.inf), dim=-1).values
    n = valid.sum(dim=-1)
    lo = torch.gather(s, -1, ((n - 1) // 2)[..., None])[..., 0]
    hi = torch.gather(s, -1, (n // 2)[..., None])[..., 0]
    return 0.5 * (lo + hi)


def _masked_mean_std(v, valid):
    """np.nanmean / np.nanstd (population, two-pass centered so float32
    does not cancel catastrophically on bright backgrounds)."""
    n = valid.sum(dim=-1).to(v.dtype)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    mean = torch.where(valid, v, zero).sum(dim=-1) / n
    var = torch.where(valid, (v - mean[..., None]) ** 2,
                      zero).sum(dim=-1) / n
    return mean, torch.sqrt(var)


def stack_background(stack, box_size=10, filter_size=10, clip_sigma=3.0,
                     clip_maxiters=10, device="cuda"):
    """SExtractor background maps for a [T, H, W] stack or one [H, W]
    image, shaped like the input, in the compute dtype: float32 for any
    input except float64, which stays float64 (the hard sigma-clip and
    crowded-box comparisons then make the decisions of the float64 host
    oracle; in float32 a pixel within an ulp of med +- 3 sigma can flip,
    which shifts that box's mode by about noise / N).

    ``stack``: a tensor (used on its own device; ``device`` is ignored) or
    an array in any camera dtype (uploaded to ``device``). Returns a
    tensor on that device. A device list or a ``_device.Mesh`` in
    ``device`` splits the frames over its data devices (the JAX package's
    ``mesh=``): each share goes to its device, tensor or array, every
    share's maps are enqueued before any is gathered, and the maps return
    in frame order on the first data device. Frames are independent, so
    each frame's map is the one-device map of the same share shape.

    Spec (host oracle: pipeline.spots._mesh_background): pad to a box
    multiple by edge replication, 3-sigma clip each box (median-centered
    bounds, population spread, ``clip_maxiters`` rounds), SExtractor mode
    2.5*median - 1.5*mean with the crowded (|mean - med| > 0.3*std ->
    median) and flat (std == 0 -> mean) fallbacks, median-filter the mesh,
    cubic-spline zoom back to full resolution, crop the pad.
    """
    if is_device_list(device):
        return _over_frames(lambda x: stack_background(
            x, box_size=box_size, filter_size=filter_size,
            clip_sigma=clip_sigma, clip_maxiters=clip_maxiters),
            stack, device)
    if not isinstance(stack, torch.Tensor):
        stack = _to_device(np.asarray(stack), resolve_device(device))
    single = stack.ndim == 2
    if single:
        stack = stack[None]
    T, H, W = stack.shape
    dt = torch.float64 if stack.dtype == torch.float64 else torch.float32
    x = widen(stack, dt)
    nh = -(-H // box_size)
    nw = -(-W // box_size)
    pad_h, pad_w = nh * box_size - H, nw * box_size - W
    if pad_h or pad_w:
        # Edge replication by index (the pad may exceed the image).
        ih = torch.arange(H + pad_h, device=x.device).clamp_(max=H - 1)
        iw = torch.arange(W + pad_w, device=x.device).clamp_(max=W - 1)
        x = x[:, ih[:, None], iw[None, :]]
    boxes = (x.reshape(T, nh, box_size, nw, box_size)
             .permute(0, 1, 3, 2, 4)
             .reshape(T, nh * nw, box_size * box_size))

    valid = torch.ones(boxes.shape, dtype=torch.bool, device=x.device)
    for _ in range(int(clip_maxiters)):
        med = _masked_median(boxes, valid)
        _, std = _masked_mean_std(boxes, valid)
        keep = ((boxes >= (med - clip_sigma * std)[..., None])
                & (boxes <= (med + clip_sigma * std)[..., None]))
        valid = valid & keep

    med = _masked_median(boxes, valid)
    mean, std = _masked_mean_std(boxes, valid)
    mode = 2.5 * med - 1.5 * mean
    mode = torch.where(std == 0, mean,
                       torch.where(torch.abs(mean - med) > 0.3 * std, med,
                                   mode))
    mesh = mode.reshape(T, nh, nw)

    k = min(filter_size, nh, nw)
    if k > 1:
        ih = _on_device("win", (nh, k), lambda: reflect_window_index(nh, k),
                        x.device, torch.int64)
        iw = _on_device("win", (nw, k), lambda: reflect_window_index(nw, k),
                        x.device, torch.int64)
        wins = mesh[:, ih, :][:, :, :, iw]          # [T, nh, k, nw, k]
        wins = wins.permute(0, 1, 3, 2, 4).reshape(T, nh, nw, k * k)
        mesh = torch.sort(wins, dim=-1).values[..., (k * k) // 2]

    key = (nh, nw, box_size)
    Ah = _on_device("Ah", key, lambda: pairwise_zoom_bases(*key)[0],
                    x.device, dt)
    Aw = _on_device("Aw", key, lambda: pairwise_zoom_bases(*key)[1],
                    x.device, dt)
    up = torch.matmul(torch.matmul(Ah, mesh), Aw.T)
    out = up[:, :H, :W]
    return out[0] if single else out


# The name the JAX package gives the jitted core of its estimator.
stack_background_jit = stack_background


def subtract_background_stack(stack, box_size=10, filter_size=10,
                              clip_sigma=3.0, clip_maxiters=10,
                              device="cuda"):
    """stack - stack_background(stack) on the device, in the estimator's
    compute dtype. api.Pipeline.run_zstack subtracts inline instead (it
    needs the background map for ``return_background``); both go through
    ``stack_background``. A device list or a ``_device.Mesh`` splits
    the frames over its data devices as ``stack_background`` does."""
    if is_device_list(device):
        return _over_frames(lambda x: subtract_background_stack(
            x, box_size=box_size, filter_size=filter_size,
            clip_sigma=clip_sigma, clip_maxiters=clip_maxiters),
            stack, device)
    if not isinstance(stack, torch.Tensor):
        stack = _to_device(np.asarray(stack), resolve_device(device))
    bg = stack_background(stack, box_size=box_size, filter_size=filter_size,
                          clip_sigma=clip_sigma, clip_maxiters=clip_maxiters)
    return widen(stack, bg.dtype) - bg
