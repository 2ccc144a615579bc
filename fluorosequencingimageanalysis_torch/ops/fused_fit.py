"""Kernel B: fused patch gather + LM fit + fit quality, and its plain twin.

``fit_quality`` launches csrc/fit_quality.cu (one fit per thread) on CUDA
tensors and runs ``fit_quality_plain`` on CPU tensors. The twin is the
composition of models/detect.py::_fit_quality_core in the JAX package with
the "gather" strategy: 5x5 gather -> fit_gaussians_batched -> model image
-> R^2, RMSE, Illumina S/N -> image-coordinate centers ``p + h - 2.5``.
"""

from __future__ import annotations

import ctypes

import torch

from .candidates import gather_patches
from .gaussian import gauss2d_image
from .lm import fit_gaussians_batched
from .quality import illumina_s_n, r_squared, rmse


def fit_quality_plain(images, hs, ws, num_iters, theta_starts=1):
    """(params (B, K, 7), center_h, center_w, rmse, r2, s_n (B, K))."""
    B, K = hs.shape
    flat = gather_patches(images, hs, ws, radius=2).reshape(B * K, 5, 5)
    params, _cost = fit_gaussians_batched(flat, num_iters=num_iters,
                                          theta_starts=theta_starts)
    fit_imgs = gauss2d_image(params, (5, 5), dtype=images.dtype)
    r2 = r_squared(flat, fit_imgs).reshape(B, K)
    rm = rmse(flat, fit_imgs).reshape(B, K)
    sn = illumina_s_n(flat).reshape(B, K)
    params = params.reshape(B, K, 7)
    center_h = params[:, :, 2] + hs.to(params.dtype) - 2.5
    center_w = params[:, :, 3] + ws.to(params.dtype) - 2.5
    return params, center_h, center_w, rm, r2, sn


def _launch(images, hs, ws, num_iters, theta_starts):
    from .. import _build
    lib = _build.load("fit_quality")
    fn = lib.fit_quality_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 +
                   [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    B, H, W = images.shape
    K = hs.shape[1]
    params = torch.empty((B, K, 7), dtype=torch.float32, device=images.device)
    outs = [torch.empty((B, K), dtype=torch.float32, device=images.device)
            for _ in range(5)]
    stream = torch.cuda.current_stream(images.device).cuda_stream
    with torch.cuda.device(images.device):
        err = fn(images.data_ptr(), hs.data_ptr(), ws.data_ptr(), B, H, W,
                 K, int(num_iters), int(theta_starts), params.data_ptr(),
                 *[o.data_ptr() for o in outs], stream)
    if err != 0:
        raise RuntimeError(f"fit_quality kernel launch failed: CUDA error "
                           f"{err}")
    fit_quality.launches += 1
    center_h, center_w, rm, r2, sn = outs
    return params, center_h, center_w, rm, r2, sn


def fit_quality(images, hs, ws, num_iters, theta_starts=1):
    """Fit a 5x5 Gaussian at every (hs, ws) candidate of (B, H, W) images.

    hs, ws: (B, K) int32 centers at least 2 px from every edge. Returns
    (params (B, K, 7), center_h, center_w, rmse, r2, s_n (B, K)). CUDA
    tensors go through the hand-written kernel (float32 images, int32
    coordinates, all contiguous on one device); CPU tensors through
    ``fit_quality_plain``.
    """
    if images.device.type == "cpu":
        return fit_quality_plain(images, hs, ws, num_iters, theta_starts)
    if images.device.type != "cuda":
        raise ValueError(f"fit_quality: unsupported device {images.device}")
    if images.dtype != torch.float32:
        raise TypeError(f"fit_quality: float32 images required, got "
                        f"{images.dtype}")
    if hs.dtype != torch.int32 or ws.dtype != torch.int32:
        raise TypeError("fit_quality: int32 hs/ws required")
    if images.ndim != 3 or hs.ndim != 2 or hs.shape != ws.shape or \
            hs.shape[0] != images.shape[0]:
        raise ValueError(f"fit_quality: images (B, H, W) and hs/ws (B, K) "
                         f"required, got {tuple(images.shape)}, "
                         f"{tuple(hs.shape)}, {tuple(ws.shape)}")
    if hs.device != images.device or ws.device != images.device:
        raise ValueError("fit_quality: images, hs and ws must share a device")
    if not (images.is_contiguous() and hs.is_contiguous() and
            ws.is_contiguous()):
        raise ValueError("fit_quality: contiguous inputs required")
    if num_iters < 0 or theta_starts < 1:
        raise ValueError("fit_quality: num_iters >= 0 and theta_starts >= 1 "
                         "required")
    return _launch(images, hs, ws, num_iters, theta_starts)


fit_quality.launches = 0
