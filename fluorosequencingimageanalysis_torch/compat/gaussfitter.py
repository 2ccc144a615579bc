"""The agpy ``gaussfitter`` surface the pipeline uses (the reference's
agpy/gaussfitter.py): a copy of the repo's root ``gaussfitter.py`` shim on
the port.

The default elliptical+rotated+vheight case on 5x5 data (the pipeline's
only use, pflib.py:199-214) runs the port's batched LM
(ops/lm.py::fit_gaussians_batched) on the process default device
(``_device.default_device()``); reduced modes (circle / no-rotate /
no-vheight) take scipy bounded least squares with the exact agpy parameter
conventions, on the host.
"""

import numpy as np
from numpy.ma import median
from scipy.optimize import least_squares


def moments(data, circle, rotate, vheight, estimator=median, **kwargs):
    """Moment-based initial parameters (gaussfitter.py:29-61)."""
    data = np.asarray(data)
    total = np.abs(data).sum()
    Y, X = np.indices(data.shape)
    y = np.argmax((X * np.abs(data)).sum(axis=1) / total)
    x = np.argmax((Y * np.abs(data)).sum(axis=0) / total)
    col = data[int(y), :]
    width_x = np.sqrt(np.abs((np.arange(col.size) - y) * col).sum() /
                      np.abs(col).sum())
    row = data[:, int(x)]
    width_y = np.sqrt(np.abs((np.arange(row.size) - x) * row).sum() /
                      np.abs(row).sum())
    width = (width_x + width_y) / 2.0
    height = estimator(data.ravel())
    amplitude = data.max() - height
    mylist = [amplitude, x, y]
    if np.isnan(width_y) or np.isnan(width_x) or np.isnan(height) or \
            np.isnan(amplitude):
        raise ValueError("something is nan")
    if vheight == 1:
        mylist = [height] + mylist
    if circle == 0:
        mylist = mylist + [width_x, width_y]
        if rotate == 1:
            mylist = mylist + [0.0]
    else:
        mylist = mylist + [width]
    return mylist


def twodgaussian(inpars, circle=False, rotate=True, vheight=True, shape=None):
    """The agpy 2D Gaussian closure (gaussfitter.py:63-140), with its exact
    parameter-popping convention (center_y then center_x)."""
    inpars_old = inpars
    inpars = list(inpars)
    if vheight == 1:
        height = float(inpars.pop(0))
    else:
        height = 0.0
    amplitude, center_y, center_x = (float(inpars.pop(0)),
                                     float(inpars.pop(0)),
                                     float(inpars.pop(0)))
    if circle == 1:
        width = float(inpars.pop(0))
        width_x = width_y = width
        rotate = 0
    else:
        width_x = float(inpars.pop(0))
        width_y = float(inpars.pop(0))
    if rotate == 1:
        rota = np.pi / 180.0 * float(inpars.pop(0))
        rcen_x = center_x * np.cos(rota) - center_y * np.sin(rota)
        rcen_y = center_x * np.sin(rota) + center_y * np.cos(rota)
    else:
        rota = 0.0
        rcen_x = center_x
        rcen_y = center_y
    if len(inpars) > 0:
        raise ValueError("There are still input parameters:" + str(inpars) +
                         " and you've input: " + str(inpars_old) +
                         " circle=%d, rotate=%d, vheight=%d" %
                         (circle, rotate, vheight))

    def rotgauss(x, y):
        if rotate == 1:
            xp = x * np.cos(rota) - y * np.sin(rota)
            yp = x * np.sin(rota) + y * np.cos(rota)
        else:
            xp = x
            yp = y
        return height + amplitude * np.exp(
            -(((rcen_x - xp) / width_x) ** 2 +
              ((rcen_y - yp) / width_y) ** 2) / 2.0)

    if shape is not None:
        return rotgauss(*np.indices(shape))
    return rotgauss


def gaussfit(data, err=None, params=(), autoderiv=True, return_all=False,
             circle=False,
             fixed=np.repeat(False, 7),
             limitedmin=[False, False, False, False, True, True, True],
             limitedmax=[False, False, False, False, False, False, True],
             usemoment=np.array([], dtype="bool"),
             minpars=np.repeat(0, 7), maxpars=[0, 0, 0, 0, 0, 0, 360],
             rotate=1, vheight=1, quiet=True, returnmp=False,
             returnfitimage=False, **kwargs):
    """Bounded 2D Gaussian fit (gaussfitter.py:142-255)."""
    data = np.asarray(data, dtype=np.float64)
    usemoment = np.array(usemoment, dtype="bool")
    params = np.array(params, dtype="float")
    fixed = np.array(fixed)
    if usemoment.any() and len(params) == len(usemoment):
        moment = np.array(moments(data, circle, rotate, vheight, **kwargs),
                          dtype="float")
        params[usemoment] = moment[usemoment]
    elif params.size == 0:
        params = np.array(moments(data, circle, rotate, vheight, **kwargs),
                          dtype="float")
    if vheight == 0:
        vheight = 1
        params = np.concatenate([[0], params])
        fixed = np.concatenate([[1], np.asarray(fixed)[:len(params) - 1]])
    # Clip out-of-range starts (gaussfitter.py:201-204).
    n_par = len(params)
    for i in range(n_par):
        if limitedmax[i] and params[i] > maxpars[i]:
            params[i] = maxpars[i]
        if limitedmin[i] and params[i] < minpars[i]:
            params[i] = minpars[i]

    full = (circle == 0 and rotate == 1 and vheight == 1 and n_par == 7 and
            not np.any(np.asarray(fixed)[:7]) and data.shape == (5, 5) and
            err is None)
    if full:
        import torch

        from .._device import default_device, resolve_device
        from ..ops.lm import fit_gaussians_batched
        lo = np.array([minpars[i] if limitedmin[i] else -1e30
                       for i in range(7)], dtype=np.float64)
        hi = np.array([maxpars[i] if limitedmax[i] else 1e30
                       for i in range(7)], dtype=np.float64)
        dev = resolve_device(default_device())

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[None])).to(dev)

        p_fit, _ = fit_gaussians_batched(put(data), p0=put(params),
                                         lo=put(lo), hi=put(hi),
                                         num_iters=120)
        p_fit = p_fit[0].cpu().numpy()
    else:
        # Reduced modes / errors / non-5x5 data: exact scipy fallback.
        lo = np.array([minpars[i] if limitedmin[i] else -np.inf
                       for i in range(n_par)], dtype=np.float64)
        hi = np.array([maxpars[i] if limitedmax[i] else np.inf
                       for i in range(n_par)], dtype=np.float64)
        for i in range(n_par):
            if i < len(fixed) and fixed[i]:
                lo[i] = params[i] - 1e-12
                hi[i] = params[i] + 1e-12

        def resid(p):
            model = twodgaussian(p, circle, rotate, vheight)(
                *np.indices(data.shape))
            r = (model - data)
            if err is not None:
                r = r / err
            return r.ravel()

        sol = least_squares(resid, np.clip(params, lo, hi), bounds=(lo, hi),
                            method="trf", xtol=1e-12, ftol=1e-12,
                            max_nfev=2000)
        p_fit = sol.x

    if returnmp:
        class _MP:  # minimal mpfit-result stand-in
            pass
        mp = _MP()
        mp.params = p_fit
        mp.perror = None
        returns = mp
    elif return_all == 0:
        returns = p_fit
    elif return_all == 1:
        returns = (p_fit, None)
    if returnfitimage:
        fitimage = twodgaussian(p_fit, circle, rotate, vheight)(
            *np.indices(data.shape))
        returns = (returns, fitimage)
    return returns


# ---------------------------------------------------------------------------
# 1D variants (gaussfitter.py:257-550)
# ---------------------------------------------------------------------------

def onedmoments(Xax, data, vheight=True, estimator=median, negamp=None,
                veryverbose=False, **kwargs):
    """(height, amplitude, x, width_x) 1D moments (gaussfitter.py:257-305)."""
    Xax = np.asarray(Xax, dtype=float)
    data = np.asarray(data, dtype=float)
    dx = np.mean(Xax[1:] - Xax[:-1])
    integral = (data * dx).sum()
    height = estimator(data)
    Lpeakintegral = (integral - height * len(Xax) * dx -
                     (data[data > height] * dx).sum())
    Lamplitude = data.min() - height
    Lwidth_x = 0.5 * (np.abs(Lpeakintegral / Lamplitude))
    Hpeakintegral = (integral - height * len(Xax) * dx -
                     (data[data < height] * dx).sum())
    Hamplitude = data.max() - height
    Hwidth_x = 0.5 * (np.abs(Hpeakintegral / Hamplitude))
    Lstddev = Xax[data < data.mean()].std()
    Hstddev = Xax[data > data.mean()].std()
    if negamp:
        xcen, amplitude, width_x = (Xax[np.argmin(data)], Lamplitude,
                                    Lwidth_x)
    elif negamp is None:
        if Hstddev < Lstddev:
            xcen, amplitude, width_x = (Xax[np.argmax(data)], Hamplitude,
                                        Hwidth_x)
        else:
            xcen, amplitude, width_x = (Xax[np.argmin(data)], Lamplitude,
                                        Lwidth_x)
    else:
        xcen, amplitude, width_x = (Xax[np.argmax(data)], Hamplitude,
                                    Hwidth_x)
    mylist = [amplitude, xcen, width_x]
    if np.isnan(width_x) or np.isnan(height) or np.isnan(amplitude):
        raise ValueError("something is nan")
    if vheight:
        mylist = [height] + mylist
    return mylist


def onedgaussian(x, H, A, dx, w):
    """H + A*exp(-(x-dx)^2 / (2 w^2)) (gaussfitter.py:307-312)."""
    return H + A * np.exp(-(np.asarray(x) - dx) ** 2 / (2.0 * w ** 2))


def _bounded_lsq(resid, p0, lo, hi):
    sol = least_squares(resid, np.clip(p0, lo, hi), bounds=(lo, hi),
                        method="trf", xtol=1e-12, ftol=1e-12, max_nfev=2000)
    try:
        cov = np.linalg.pinv(sol.jac.T @ sol.jac)
        perror = np.sqrt(np.maximum(np.diag(cov), 0.0))
    except Exception:
        perror = np.zeros_like(sol.x)
    chi2 = float(np.sum(sol.fun ** 2))
    return sol.x, perror, chi2


def _bounds_from_parinfo(params, fixed, limitedmin, limitedmax, minpars,
                         maxpars):
    n = len(params)
    lo = np.array([minpars[i] if limitedmin[i] else -np.inf
                   for i in range(n)], dtype=float)
    hi = np.array([maxpars[i] if limitedmax[i] else np.inf
                   for i in range(n)], dtype=float)
    for i in range(n):
        if fixed[i]:
            lo[i] = params[i] - 1e-12
            hi[i] = params[i] + 1e-12
    return lo, hi


def onedgaussfit(xax, data, err=None, params=[0, 1, 0, 1],
                 fixed=[False, False, False, False],
                 limitedmin=[False, False, False, True],
                 limitedmax=[False, False, False, False],
                 minpars=[0, 0, 0, 0], maxpars=[0, 0, 0, 0], quiet=True,
                 shh=True, veryverbose=False, vheight=True, negamp=False,
                 usemoments=False):
    """Bounded 1D Gaussian fit (gaussfitter.py:314-381).
    Returns (params, model, perror, chi2)."""
    data = np.asarray(data, dtype=float)
    if xax is None:
        xax = np.arange(len(data))
    xax = np.asarray(xax, dtype=float)
    params = list(params)
    fixed = list(fixed)
    if vheight is False:
        height = params[0]
        fixed[0] = True
    if usemoments:
        params = onedmoments(xax, data, vheight=vheight, negamp=negamp,
                             veryverbose=veryverbose)
        if vheight is False:
            params = [height] + params

    def resid(p):
        r = data - onedgaussian(xax, *p)
        return r / err if err is not None else r

    lo, hi = _bounds_from_parinfo(params, fixed, limitedmin, limitedmax,
                                  minpars, maxpars)
    mpp, mpperr, chi2 = _bounded_lsq(resid, np.asarray(params, float),
                                     lo, hi)
    return mpp, onedgaussian(xax, *mpp), mpperr, chi2


def n_gaussian(pars=None, a=None, dx=None, sigma=None):
    """Sum-of-N-gaussians closure (gaussfitter.py:384-409)."""
    if pars is not None and len(pars) % 3 == 0:
        a = [pars[ii] for ii in range(0, len(pars), 3)]
        dx = [pars[ii] for ii in range(1, len(pars), 3)]
        sigma = [pars[ii] for ii in range(2, len(pars), 3)]
    elif not (len(dx) == len(sigma) == len(a)):
        raise ValueError("Wrong array lengths! dx: %i  sigma: %i  a: %i" %
                         (len(dx), len(sigma), len(a)))

    def g(x):
        x = np.asarray(x, dtype=float)
        v = np.zeros(len(x))
        for i in range(len(dx)):
            v += a[i] * np.exp(-(x - dx[i]) ** 2 / (2.0 * sigma[i] ** 2))
        return v
    return g


def multigaussfit(xax, data, ngauss=1, err=None, params=[1, 0, 1],
                  fixed=[False, False, False],
                  limitedmin=[False, False, True],
                  limitedmax=[False, False, False], minpars=[0, 0, 0],
                  maxpars=[0, 0, 0], quiet=True, shh=True,
                  veryverbose=False):
    """Multi-Gaussian bounded fit (gaussfitter.py:411-500).
    Returns (params, model, perror, chi2)."""
    data = np.asarray(data, dtype=float)
    if len(params) != ngauss and (len(params) // 3) > ngauss:
        ngauss = len(params) // 3
    if isinstance(params, np.ndarray):
        params = params.tolist()
    params = list(params)
    fixed = list(fixed)
    limitedmin = list(limitedmin)
    limitedmax = list(limitedmax)
    minpars = list(minpars)
    maxpars = list(maxpars)
    for name in ("params", "fixed", "limitedmin", "limitedmax", "minpars",
                 "maxpars"):
        parlist = locals()[name]
        if len(parlist) != 3 * ngauss:
            if len(parlist) == 3:
                parlist *= ngauss
            elif name == "params":
                parlist[:] = [1, 0, 1] * ngauss
            elif name in ("fixed", "limitedmax"):
                parlist[:] = [False, False, False] * ngauss
            elif name == "limitedmin":
                parlist[:] = [False, False, True] * ngauss
            else:
                parlist[:] = [0, 0, 0] * ngauss
    if xax is None:
        xax = np.arange(len(data))
    xax = np.asarray(xax, dtype=float)

    def resid(p):
        r = data - n_gaussian(pars=list(p))(xax)
        return r / err if err is not None else r

    lo, hi = _bounds_from_parinfo(params, fixed, limitedmin, limitedmax,
                                  minpars, maxpars)
    mpp, mpperr, chi2 = _bounded_lsq(resid, np.asarray(params, float),
                                     lo, hi)
    return mpp, n_gaussian(pars=list(mpp))(xax), mpperr, chi2


def collapse_gaussfit(cube, xax=None, axis=2, negamp=False, usemoments=True,
                      nsigcut=1.0, mppsigcut=1.0, return_errors=False,
                      **kwargs):
    """Per-spectrum 1D fits over a cube (gaussfitter.py:502-549)."""
    cube = np.asarray(cube, dtype=float)
    std_coll = cube.std(axis=axis)
    std_coll[std_coll == 0] = np.nan
    mean_std = median(std_coll[std_coll == std_coll])
    if axis > 0:
        cube = cube.swapaxes(0, axis)
    shape = cube.shape[1:]
    width_arr = np.full(shape, np.nan)
    amp_arr = np.full(shape, np.nan)
    chi2_arr = np.full(shape, np.nan)
    offset_arr = np.full(shape, np.nan)
    width_err = np.full(shape, np.nan)
    amp_err = np.full(shape, np.nan)
    offset_err = np.full(shape, np.nan)
    if xax is None:
        xax = np.arange(cube.shape[0])
    extremum = np.min if negamp else np.max
    for i in range(cube.shape[1]):
        for j in range(cube.shape[2]):
            if np.abs(extremum(cube[:, i, j])) > (mean_std * nsigcut):
                mpp, gfit, mpperr, chi2 = onedgaussfit(
                    xax, cube[:, i, j],
                    err=np.ones(cube.shape[0]) * mean_std, negamp=negamp,
                    usemoments=usemoments, **kwargs)
                if np.abs(mpp[1]) > (mpperr[1] * mppsigcut):
                    width_arr[i, j] = mpp[3]
                    offset_arr[i, j] = mpp[2]
                    chi2_arr[i, j] = chi2
                    amp_arr[i, j] = mpp[1]
                    width_err[i, j] = mpperr[3]
                    offset_err[i, j] = mpperr[2]
                    amp_err[i, j] = mpperr[1]
    if return_errors:
        return (width_arr, offset_arr, amp_arr, width_err, offset_err,
                amp_err, chi2_arr)
    return width_arr, offset_arr, amp_arr, chi2_arr
