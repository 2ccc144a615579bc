"""The reference's ``cross_correlation`` module (agpy's 1D spectral
cross-correlation lag fit; unused by the pipeline, kept for API parity): a
copy of the repo's root ``cross_correlation.py`` shim. Host code (numpy
and scipy); the reference drives lmfit, here scipy minimises the same chi^2.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize_scalar


def shift(data, deltax, phase=0):
    """FFT-based sub-pixel 1D shift (cross_correlation.py:23-31)."""
    data = np.asarray(data)
    nx = data.size
    Nx = np.fft.ifftshift(np.linspace(-np.fix(nx / 2),
                                      np.ceil(nx / 2) - 1, nx))
    return np.fft.ifft(np.fft.fft(data) *
                       np.exp(1j * 2 * np.pi * (-deltax * Nx / nx)) *
                       np.exp(-1j * phase))


def chi2(arr1, arr2, lag):
    """Per-point residual between arr1 and arr2 shifted by lag
    (cross_correlation.py:33-49): out-of-range samples zeroed, normalized
    by sqrt of the overlap count."""
    arr1 = np.asarray(arr1, dtype=float)
    xv = np.arange(arr1.size)
    shifted = np.real(shift(arr2, lag))
    shifted[(xv - lag > xv.max()) + (xv - lag < xv.min())] = 0
    arr1cp = arr1 * (xv >= lag) * (xv <= (xv + lag).max())
    ngood = (shifted != 0).sum()
    if np.any(np.isnan(shifted)):
        raise ValueError("Uncaught NAN")
    return (arr1cp - shifted) / max(ngood, 1) ** 0.5


class LagFitResult:
    """Result of fit_lag: fitted lag + chi² (duck-types the lmfit result
    the reference returns enough for `.params['lag'].value` access)."""

    class _Param:
        def __init__(self, value):
            self.value = value

    def __init__(self, lag, chisqr):
        self.lag = lag
        self.chisqr = chisqr
        self.params = {"lag": self._Param(lag)}
        self.success = True


def fit_lag(arr1, arr2, kind="linear"):
    """Fit the lag between two 1D arrays by minimizing sum(chi2**2)
    (cross_correlation.py:7-21)."""
    arr1 = np.asarray(arr1, dtype=float)
    arr2 = np.asarray(arr2, dtype=float)
    if arr1.size != arr2.size:
        raise ValueError("Size mismatch")

    def objective(lag):
        return float(np.sum(chi2(arr1, arr2, lag) ** 2))

    half = arr1.size / 2.0
    res = minimize_scalar(objective, bounds=(-half, half), method="bounded",
                          options={"xatol": 1e-6})
    return LagFitResult(float(res.x), float(res.fun))
