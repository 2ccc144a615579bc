"""The reference's ``psf_fitter`` module (agpy's Airy / Gaussian radial PSF
fitting; unused by the pipeline, kept for API parity): a copy of the repo's
root ``psf_fitter.py`` shim over ``compat/gaussfitter`` and
``compat/mpfit``. Host code.
"""

from __future__ import annotations

import numpy as np
import scipy.special

from .gaussfitter import moments, twodgaussian  # noqa: F401 (parity import)
from .mpfit import mpfit


def _airy_func(rr, amplitude=1.0, width=1.0):
    """Radially symmetric Airy value at normalized radius
    (psf_fitter.py:8-13)."""
    return amplitude * (2.0 * scipy.special.j1(rr / width) /
                        (rr / width)) ** 2


def _gaussian_func(rr, amplitude=1.0, sigma=1.0):
    """Radially symmetric Gaussian value at normalized radius
    (psf_fitter.py:15-20)."""
    return amplitude * np.exp(-(rr ** 2) / (2.0 * sigma ** 2))


def airy(inpars, circle=True, rotate=False, vheight=True, shape=None,
         fwhm=False):
    """2D Airy-disk closure with the agpy parameter-popping convention
    (psf_fitter.py:22-116): inpars = (height, amplitude, center_y,
    center_x, width[, width_y][, rota])."""
    inpars_old = inpars
    inpars = list(inpars)
    height = float(inpars.pop(0)) if vheight == 1 else 0.0
    amplitude, center_y, center_x = (float(inpars.pop(0)),
                                     float(inpars.pop(0)),
                                     float(inpars.pop(0)))
    if circle == 1:
        width_x = width_y = float(inpars.pop(0))
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
    if fwhm:
        # Airy first zero at 1.61633 half-widths (psf_fitter.py:93-95).
        width_x /= 2.0 * 1.61633
        width_y /= 2.0 * 1.61633

    def rotairy(x, y):
        if rotate == 1:
            xp = x * np.cos(rota) - y * np.sin(rota)
            yp = x * np.sin(rota) + y * np.cos(rota)
        else:
            xp, yp = x, y
        rr = np.sqrt(((rcen_x - xp) / width_x) ** 2 +
                     ((rcen_y - yp) / width_y) ** 2)
        with np.errstate(divide="ignore", invalid="ignore"):
            airy_func = (2.0 * scipy.special.j1(rr) / rr) ** 2
        airy_func = np.where(rr == 0, 1.0, airy_func)
        return height + amplitude * airy_func

    if shape is not None:
        return rotairy(*np.indices(shape))
    return rotairy


def psffit(data, err=None, params=[], autoderiv=True, return_all=False,
           circle=True, fixed=np.repeat(False, 7),
           limitedmin=[False, False, False, False, True, True, True],
           limitedmax=[False, False, False, False, False, False, True],
           usemoment=np.array([], dtype="bool"),
           minpars=np.repeat(0, 7), maxpars=[0, 0, 0, 0, 0, 0, 360],
           rotate=0, vheight=1, quiet=True, returnmp=False,
           returnfitimage=False, psffunction=airy, extra_pars=None,
           return_parinfo=False, **kwargs):
    """Bounded PSF fit for Airy or Gaussian forms (psf_fitter.py:117-230).
    Same parinfo-style bound semantics as gaussfit, driven through the
    mpfit-compatible class."""
    usemoment = np.array(usemoment, dtype="bool")
    params = np.array(params, dtype="float")
    fixed = np.array(fixed).copy()
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
    n_par = len(params)
    for i in range(n_par):
        if limitedmax[i] and params[i] > maxpars[i]:
            params[i] = maxpars[i]
        if limitedmin[i] and params[i] < minpars[i]:
            params[i] = minpars[i]

    def fcn(p, fjac=None):
        model = psffunction(p, circle, rotate, vheight)(
            *np.indices(data.shape))
        r = np.ravel(data - model)
        if err is not None:
            r = r / np.ravel(err)
        return [0, r]

    parinfo = [{"value": float(params[i]),
                "fixed": bool(fixed[i]) if i < len(fixed) else False,
                "limited": [int(limitedmin[i]), int(limitedmax[i])],
                "limits": [float(minpars[i]), float(maxpars[i])]}
               for i in range(n_par)]
    if extra_pars is not None:
        parinfo += list(extra_pars)
    mp = mpfit(fcn, parinfo=parinfo, quiet=quiet)
    if mp.status == 0:
        raise Exception(mp.errmsg)
    p_fit = mp.params

    if returnmp:
        returns = mp
    elif return_parinfo:
        returns = (p_fit, parinfo)
    elif return_all == 0:
        returns = p_fit
    else:
        returns = (p_fit, mp.perror)
    if returnfitimage:
        fitimage = psffunction(p_fit, circle, rotate, vheight)(
            *np.indices(data.shape))
        returns = (returns, fitimage)
    return returns
