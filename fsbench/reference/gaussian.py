"""The reference-convention 2D Gaussian PSF model.

A frozen copy of the port's ops/gaussian.py, including
agpy's axis quirk: ``p2`` ("h_0") is the model's center_y and ``p3`` ("w_0")
its center_x, evaluated as ``rotgauss(rows, cols)``, so at theta=0 p3 is the
row center and p2 the column center.
"""

from __future__ import annotations

import math

import torch

PSF_PARAM_NAMES = ("H", "A", "h_0", "w_0", "sigma_h", "sigma_w", "theta")

_DEG2RAD = math.pi / 180.0


def gauss2d_ref(params, h_grid, w_grid):
    """Evaluate the model
    ``H + A exp(-((rcen_x - xp)/sh)^2/2 - ((rcen_y - yp)/sw)^2/2)``.

    params: (..., 7) ``(H, A, p2, p3, sh, sw, theta_deg)``; h_grid, w_grid:
    row and column index grids of one shape. Returns
    ``params.shape[:-1] + grid.shape``.
    """
    H = params[..., 0, None, None]
    A = params[..., 1, None, None]
    c2 = params[..., 2, None, None]
    c3 = params[..., 3, None, None]
    sh = params[..., 4, None, None]
    sw = params[..., 5, None, None]
    rota = params[..., 6, None, None] * _DEG2RAD
    cos_r = torch.cos(rota)
    sin_r = torch.sin(rota)
    rcen_x = c3 * cos_r - c2 * sin_r
    rcen_y = c3 * sin_r + c2 * cos_r
    xp = h_grid * cos_r - w_grid * sin_r
    yp = h_grid * sin_r + w_grid * cos_r
    return H + A * torch.exp(-(((rcen_x - xp) / sh) ** 2 +
                               ((rcen_y - yp) / sw) ** 2) / 2.0)


def gauss2d_image(params, shape=(5, 5), dtype=torch.float32):
    """The model over an index grid of ``shape`` (the "fit image")."""
    kw = dict(dtype=dtype, device=params.device)
    h_grid, w_grid = torch.meshgrid(torch.arange(shape[0], **kw),
                                    torch.arange(shape[1], **kw),
                                    indexing="ij")
    return gauss2d_ref(params, h_grid, w_grid)
