"""Subpixel FFT image registration (Guizar-Sicairos et al. 2008).

Counterpart of fluorosequencingimageanalysis_tpu/ops/registration.py: the
integer shift from the peak of the FFT cross-power, refined to
1/upsample_factor px by an upsampled DFT evaluated as matrix products in a
1.5 * upsample_factor neighbourhood. FFTs go through ``torch.fft``; the
three small complex products of ``_dftups`` stay ``torch.matmul``, as the
JAX package leaves them to XLA. Every function but the single-pair
``phase_correlate`` takes a batch of image pairs along leading axes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import default_device, resolve_device


def _complex_argmax(z):
    """Flat argmax over the last two axes with numpy's lexicographic
    complex order (real part, then imaginary part on exact real ties,
    then the first flat index)."""
    flat = z.reshape(*z.shape[:-2], -1)
    max_real = flat.real.amax(dim=-1, keepdim=True)
    tied_imag = torch.where(flat.real == max_real, flat.imag,
                            torch.full_like(flat.imag, -torch.inf))
    return torch.argmax(tied_imag, dim=-1)


def _ifftshift_arange(n, dtype, device):
    return torch.fft.ifftshift(torch.arange(n, dtype=dtype, device=device))


def _dftups(data, up_rows: int, up_cols: int, upsample_factor: int,
            row_offset, col_offset):
    """Upsampled DFT of (..., rows, cols) ``data`` by matrix products: the
    (up_rows, up_cols) window at (row_offset, col_offset) of the FFT of
    ``data`` embedded in an upsample_factor-times larger array.
    row_offset / col_offset: floats or tensors of the leading shape."""
    rows, cols = data.shape[-2:]
    real_dt = torch.float64 if data.dtype == torch.complex128 \
        else torch.float32
    dev = data.device
    lead = data.shape[:-2]
    row_offset = torch.as_tensor(row_offset, dtype=real_dt,
                                 device=dev).expand(lead)
    col_offset = torch.as_tensor(col_offset, dtype=real_dt,
                                 device=dev).expand(lead)
    col_base = (_ifftshift_arange(cols, real_dt, dev)[:, None] -
                math.floor(cols / 2))
    col_samples = (torch.arange(up_cols, dtype=real_dt, device=dev) -
                   col_offset[..., None])[..., None, :]
    col_kernel = torch.exp((-2j * math.pi / (cols * upsample_factor)) *
                           (col_base @ col_samples))
    row_samples = (torch.arange(up_rows, dtype=real_dt, device=dev) -
                   row_offset[..., None])[..., :, None]
    row_base = (_ifftshift_arange(rows, real_dt, dev)[None, :] -
                math.floor(rows / 2))
    row_kernel = torch.exp((-2j * math.pi / (rows * upsample_factor)) *
                           (row_samples @ row_base))
    return row_kernel @ data @ col_kernel


def phase_correlate_jit(ref_image, reg_image, upsample_factor: int = 1):
    """(row_shift, col_shift, error, diffphase) registering ``reg_image``
    onto ``ref_image`` for (..., H, W) batches of pairs."""
    ref_f = torch.fft.fft2(ref_image)
    reg_f = torch.fft.fft2(reg_image)
    rows, cols = ref_f.shape[-2:]
    real_dt = ref_f.real.dtype
    mid_row = math.floor(rows / 2.0)
    mid_col = math.floor(cols / 2.0)

    cross = torch.fft.ifft2(ref_f * torch.conj(reg_f))
    amax = _complex_argmax(cross)
    row_max = amax // cols
    col_max = amax % cols
    row_shift = torch.where(row_max > mid_row, row_max - rows,
                            row_max).to(real_dt)
    col_shift = torch.where(col_max > mid_col, col_max - cols,
                            col_max).to(real_dt)

    if upsample_factor == 1:
        rfzero = torch.sum(torch.abs(ref_f) ** 2, dim=(-2, -1)) / (rows * cols)
        rgzero = torch.sum(torch.abs(reg_f) ** 2, dim=(-2, -1)) / (rows * cols)
        ccmax = torch.gather(cross.reshape(*cross.shape[:-2], -1), -1,
                             amax[..., None])[..., 0]
        error = torch.sqrt(torch.abs(
            1.0 - ccmax * torch.conj(ccmax) / (rgzero * rfzero)))
        diffphase = torch.atan2(ccmax.imag, ccmax.real)
        return row_shift, col_shift, error, diffphase

    u = upsample_factor
    row_shift = torch.round(row_shift * u) / u
    col_shift = torch.round(col_shift * u) / u
    up_px = int(np.ceil(u * 1.5))
    dftshift = float(np.fix(up_px / 2.0))
    norm = mid_row * mid_col * u ** 2
    cross_up = torch.conj(_dftups(reg_f * torch.conj(ref_f), up_px, up_px, u,
                                  dftshift - row_shift * u,
                                  dftshift - col_shift * u)) / norm
    amax_up = _complex_argmax(cross_up)
    row_up = (amax_up // up_px).to(real_dt) - dftshift
    col_up = (amax_up % up_px).to(real_dt) - dftshift
    row_shift = row_shift + row_up / u
    col_shift = col_shift + col_up / u
    ccmax = torch.gather(cross_up.reshape(*cross_up.shape[:-2], -1), -1,
                         amax_up[..., None])[..., 0]
    rg00 = _dftups(ref_f * torch.conj(ref_f), 1, 1, u, 0.0,
                   0.0)[..., 0, 0] / norm
    rf00 = _dftups(reg_f * torch.conj(reg_f), 1, 1, u, 0.0,
                   0.0)[..., 0, 0] / norm
    error = torch.sqrt(torch.abs(1.0 - ccmax * torch.conj(ccmax) /
                                 (rg00 * rf00)))
    diffphase = torch.atan2(ccmax.imag, ccmax.real)

    # Single-row/column images cannot shift along that dimension.
    if mid_row == 1:
        row_shift = torch.zeros_like(row_shift)
    if mid_col == 1:
        col_shift = torch.zeros_like(col_shift)
    return row_shift, col_shift, error, diffphase


def phase_correlate(ref_image, reg_image, upsample_factor: int = 1):
    """Single-pair API with the reference's signature and return types
    (phase_correlate.py:11-134): (row_shift, col_shift, error, diffphase)
    as Python floats. Raises on mismatched or non-2D shapes like the
    reference. The pair is registered in float64 on the process default
    device (``_device.default_device()``)."""
    ref_image = np.asarray(ref_image)
    reg_image = np.asarray(reg_image)
    if ref_image.shape != reg_image.shape:
        raise ValueError("Error: images must be same size for phase_correlate")
    if ref_image.ndim != 2:
        raise ValueError("Error: phase_correlate only supports 2D images")
    dev = resolve_device(default_device())
    pair = torch.from_numpy(np.stack([ref_image, reg_image]).astype(
        np.float64)).to(dev)
    r, c, e, d = phase_correlate_jit(pair[0], pair[1], int(upsample_factor))
    return float(r), float(c), float(e), float(d)


def phase_correlate_stack(frames, upsample_factor: int = 20):
    """Register consecutive frames of (..., C, H, W) stacks.

    Returns (row_shifts, col_shifts, errors, diffphases), each (..., C),
    with entry 0 fixed at 0 (the first frame defines the reference grid).
    """
    if frames.shape[-3] < 2:  # no pairs (some FFT backends reject size 0)
        z = frames.new_zeros(frames.shape[:-2])
        return z, z, z, z
    r, c, e, d = phase_correlate_jit(frames[..., :-1, :, :],
                                     frames[..., 1:, :, :], upsample_factor)
    pad = [torch.zeros_like(x[..., :1]) for x in (r, c, e, d)]
    return tuple(torch.cat([z, x], dim=-1)
                 for z, x in zip(pad, (r, c, e, d)))
