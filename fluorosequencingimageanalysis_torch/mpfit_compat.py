"""mpfit-compatible Levenberg-Marquardt fitter (host-side).

A copy of fluorosequencingimageanalysis_tpu/mpfit_compat.py (numpy and
scipy only; tests/test_torch_import.py holds it equal to that module).

The reference vendors the MINPACK-lineage ``mpfit`` class
(agpy/mpfit/mpfit.py:597, FORTRAN->IDL->Python port) and the pipeline
reaches it through agpy's gaussfit. This module reproduces the *interface
contract* — the ``fcn(p, fjac=None, **functkw) -> [status, residuals]``
callback, the ``parinfo`` semantics (value / fixed / limited / limits /
tied / parname / step / relstep / mpside; mpmaxstep raises
NotImplementedError — the reference pipeline never sets it), and the result
attributes (params, perror, covar, fnorm, niter, nfev, status, errmsg,
dof) — on top of scipy's bounded trust-region least squares. It is NOT a
port of mpfit's internals: the pipeline's hot path (thousands of 5x5 PSF
fits) runs on the batched LM of ops/lm.py and kernel B on the device; this
class exists for API parity with user code that drives mpfit directly.

Status codes follow mpfit.py:754-790: 1 = converged (ftol), 2 = xtol,
5 = maxiter reached, <=0 = error (errmsg set).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares


class _LMResult:
    def __init__(self, x, fun, jac, status, nfev):
        self.x = x
        self.fun = fun
        self.jac = jac
        self.status = status  # scipy convention: 1 gtol, 2 ftol, 3 xtol,
        self.nfev = nfev      # 0 max iterations


def _lm_maxstep(residuals, fd_jacobian, x0, lo, hi, maxstep,
                ftol=1e-10, xtol=1e-10, gtol=1e-10, maxiter=200):
    """Bounded Levenberg-Marquardt with mpfit's per-iteration step cap.

    Used only when parinfo sets 'mpmaxstep' (the one parinfo key scipy's
    TRF cannot express). Semantics follow mpfit's step handling
    (agpy/mpfit/mpfit.py:1175-1231): compute the damped
    step, shorten it (alpha) so no bound is crossed, then divide alpha by
    max(|step_i| / maxstep_i) when that ratio exceeds 1 — every accepted
    iteration moves each capped parameter by at most its mpmaxstep.
    """
    x = np.asarray(x0, float).copy()
    f = residuals(x)
    cost = float(np.sum(f ** 2))
    lam = 1e-3
    nfev = 1
    status = 0
    cap = np.where(maxstep > 0, maxstep, np.inf)
    for _ in range(max(int(maxiter), 1)):
        J = fd_jacobian(x)
        g = J.T @ f
        # Pegged parameters (mpfit.py:1072-1091): a parameter sitting ON
        # a limit whose gradient points OUT of the feasible box gets its
        # Jacobian column zeroed, so the solve optimizes the others
        # instead of producing an outward step whose bound clip would
        # shrink alpha to 0 — a zero step the cost test would "accept"
        # and the ftol check would misreport as convergence.
        pegl = x <= lo
        pegh = x >= hi
        out_l = pegl & (g > 0)   # step ~ -g would go below the limit
        out_h = pegh & (g < 0)
        Jm = J
        if out_l.any() or out_h.any():
            Jm = J.copy()
            Jm[:, out_l | out_h] = 0.0
            g = Jm.T @ f
        if np.max(np.abs(g), initial=0.0) < gtol:
            status = 1
            break
        jtj = Jm.T @ Jm
        diag = np.maximum(np.diagonal(jtj), 1e-300)
        accepted = False
        for _try in range(40):
            try:
                s = np.linalg.solve(jtj + lam * np.diag(diag), -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            # Pegged-step clip (mpfit.py:1186-1190): a pegged parameter
            # may only step back INTO the box.
            s = np.where(pegl, np.maximum(s, 0.0), s)
            s = np.where(pegh, np.minimum(s, 0.0), s)
            # Bound clip: shorten to land exactly on the first-crossed
            # limit (mpfit.py:1183-1202's alpha).
            alpha = 1.0
            nz = np.abs(s) > np.finfo(float).eps
            low_hit = nz & (x + s < lo)
            if low_hit.any():
                alpha = min(alpha, np.min((lo[low_hit] - x[low_hit]) /
                                          s[low_hit]))
            hi_hit = nz & (x + s > hi)
            if hi_hit.any():
                alpha = min(alpha, np.min((hi[hi_hit] - x[hi_hit]) /
                                          s[hi_hit]))
            # mpmaxstep (mpfit.py:1205-1210): one global alpha rescale.
            mrat = np.max(np.abs(alpha * s) / cap, initial=0.0)
            if mrat > 1.0:
                alpha = alpha / mrat
            xn = np.clip(x + alpha * s, lo, hi)
            if not np.any(xn != x):
                # A zero step (everything pegged/capped away) is not
                # progress — treat like a failed damping trial, not an
                # accepted iterate that ftol would misread as converged.
                lam *= 10.0
                continue
            fn = residuals(xn)
            nfev += 1
            costn = float(np.sum(fn ** 2))
            if costn <= cost:
                accepted = True
                break
            lam *= 10.0
        if not accepted:
            status = 3  # cannot improve within damping range
            break
        step = xn - x
        x, f = xn, fn
        lam = max(lam * 0.3, 1e-12)
        if cost - costn <= ftol * max(cost, 1e-300):
            cost = costn
            status = 2
            break
        if np.max(np.abs(step), initial=0.0) <= \
                xtol * max(np.max(np.abs(x), initial=0.0), 1e-300):
            cost = costn
            status = 3
            break
        cost = costn
    return _LMResult(x, f, fd_jacobian(x), status, nfev)


class mpfit:
    blas_enorm32 = None  # mpfit module-level artifacts some callers poke
    blas_enorm64 = None

    def __init__(self, fcn, xall=None, functkw={}, parinfo=None,
                 ftol=1.e-10, xtol=1.e-10, gtol=1.e-10, damp=0.,
                 maxiter=200, factor=100., nprint=1, iterfunct="default",
                 iterkw={}, nocovar=0, rescale=0, autoderivative=1,
                 quiet=0, diag=None, epsfcn=None, debug=0):
        self.niter = 0
        self.nfev = 0
        self.status = 0
        self.errmsg = ""
        self.params = None
        self.perror = None
        self.covar = None
        self.fnorm = None
        self.dof = 0

        # -- parinfo unpacking (mpfit.py:895-982 semantics) ----------------
        if xall is None:
            if parinfo is None:
                self.errmsg = "ERROR: must pass parameters in P or PARINFO"
                return
            xall = np.array([float(p.get("value", 0.0)) for p in parinfo])
        xall = np.asarray(xall, dtype=float).copy()
        npar = len(xall)
        if parinfo is not None and len(parinfo) != npar:
            self.errmsg = "ERROR: number of parameters must match parinfo"
            return

        def pinfo(key, default):
            if parinfo is None:
                return [default] * npar
            return [p.get(key, default) for p in parinfo]

        fixed = [bool(f) for f in pinfo("fixed", 0)]
        limited = pinfo("limited", [0, 0])
        limits = pinfo("limits", [0.0, 0.0])
        ptied = [str(t) if t else "" for t in pinfo("tied", "")]
        self.parnames = pinfo("parname", "")
        qanytied = any(t.strip() for t in ptied)
        # Finite-difference controls (mpfit.py:935-965): 'step' is an
        # ABSOLUTE step, 'relstep' a relative one, 'mpside' the sidedness
        # (0/1 -> forward, -1 -> backward, 2 -> central).
        steps = [float(s) for s in pinfo("step", 0.0)]
        relsteps = [float(s) for s in pinfo("relstep", 0.0)]
        mpsides = [int(s) for s in pinfo("mpside", 0)]
        # 'mpmaxstep' (max parameter change per iteration,
        # mpfit.py:958-982, applied at :1205-1210: after the bound clip,
        # alpha /= max(|step_i| / maxstep_i) whenever that ratio exceeds
        # 1). scipy's TRF cannot express a per-iteration per-parameter
        # hard cap, so when any mpmaxstep is set the fit runs through the
        # small bounded-LM loop below (_lm_maxstep) instead — same
        # callback/parinfo surface, steps provably capped, final params
        # agreeing with the true vendored mpfit on the oracle tests.
        maxsteps = [float(s) for s in pinfo("mpmaxstep", 0.0)]
        use_maxstep = any(s != 0.0 for s in maxsteps)

        free_idx = [i for i in range(npar)
                    if not fixed[i] and not ptied[i].strip()]
        nfree = len(free_idx)
        if nfree == 0:
            self.errmsg = "ERROR: no free parameters"
            return

        # Out-of-bound starts are an error in mpfit (mpfit.py:1003-1008).
        for i in free_idx:
            if (limited[i][0] and xall[i] < limits[i][0]) or \
                    (limited[i][1] and xall[i] > limits[i][1]):
                self.errmsg = "ERROR: parameter %d is not within PARINFO " \
                              "limits" % i
                return

        lo = np.array([limits[i][0] if limited[i][0] else -np.inf
                       for i in free_idx])
        hi = np.array([limits[i][1] if limited[i][1] else np.inf
                       for i in free_idx])

        def tie(p):
            # mpfit evaluates tied expressions in terms of the full p
            # vector (mpfit.py:1446-1458).
            if qanytied:
                for i, expr in enumerate(ptied):
                    if expr.strip():
                        p[i] = eval(expr, {"__builtins__": {}},
                                    {"p": p, "numpy": np, "np": np})
            return p

        abort = {"flag": False, "status": 0}

        def residuals(xfree):
            p = xall.copy()
            p[free_idx] = xfree
            p = tie(p)
            self.nfev += 1
            status, fvec = fcn(p, fjac=None, **functkw)
            if status < 0:
                abort["flag"] = True
                abort["status"] = status
                return np.zeros(1)
            fvec = np.asarray(fvec, dtype=float)
            if damp > 0:
                # mpfit's damping: residuals squashed through tanh
                # (mpfit.py:625-632).
                fvec = np.tanh(fvec / damp) * damp
            return fvec

        # Custom finite-difference Jacobian honoring per-parameter
        # step/relstep/mpside (fdjac2 semantics, mpfit.py:1512-1612:
        # explicit steps win over the machine-epsilon default, and the
        # step flips sign away from a violated upper bound).
        use_custom_fd = any(steps[i] or relsteps[i] or mpsides[i] == 2 or
                            mpsides[i] == -1 for i in free_idx)
        machep_sqrt = np.sqrt(np.finfo(float).eps)

        def fd_jacobian(xfree):
            f0 = residuals(xfree)
            m = f0.size
            jac = np.zeros((m, nfree))
            for a, i in enumerate(free_idx):
                h = machep_sqrt * abs(xfree[a])
                if steps[i]:
                    h = steps[i]
                if relsteps[i]:
                    h = relsteps[i] * abs(xfree[a])
                if h == 0.0:
                    h = machep_sqrt
                side = mpsides[i]
                if side != 2:
                    if side == -1:
                        h = -h
                    # Bound-aware sign flip (mpfit.py:1566-1570).
                    if limited[i][1] and xfree[a] + h > limits[i][1]:
                        h = -h
                    xp = xfree.copy()
                    xp[a] = xfree[a] + h
                    jac[:, a] = (residuals(xp) - f0) / h
                else:
                    xp, xm = xfree.copy(), xfree.copy()
                    xp[a] = xfree[a] + h
                    xm[a] = xfree[a] - h
                    jac[:, a] = (residuals(xp) - residuals(xm)) / (2 * h)
            return jac

        x0 = np.clip(xall[free_idx], lo, hi)
        try:
            if use_maxstep:
                ms_free = np.array([abs(maxsteps[i]) for i in free_idx])
                sol = _lm_maxstep(residuals, fd_jacobian, x0, lo, hi,
                                  ms_free, ftol=ftol, xtol=xtol, gtol=gtol,
                                  maxiter=maxiter)
            else:
                sol = least_squares(residuals, x0, bounds=(lo, hi),
                                    method="trf", ftol=ftol, xtol=xtol,
                                    gtol=gtol,
                                    jac=fd_jacobian if use_custom_fd
                                    else "2-point",
                                    max_nfev=maxiter * (nfree + 1))
        except Exception as e:  # pragma: no cover - defensive
            self.errmsg = "ERROR: " + str(e)
            self.status = 0
            return
        if abort["flag"]:
            self.status = abort["status"]
            self.errmsg = "ERROR: user function signaled abort"
            return

        p = xall.copy()
        p[free_idx] = sol.x
        self.params = tie(p)
        m = sol.fun.size
        self.dof = max(m - nfree, 0)
        self.fnorm = float(np.sum(sol.fun ** 2))
        self.niter = getattr(sol, "nfev", self.nfev)
        if sol.status == 0:
            self.status = 5  # maxiter / max_nfev reached (mpfit status 5)
        elif sol.status in (2, 3):
            self.status = 1  # ftol-style convergence
        elif sol.status == 1:
            self.status = 4  # gtol convergence (mpfit status 4)
        else:
            self.status = 2  # xtol convergence

        if not nocovar:
            try:
                jtj = sol.jac.T @ sol.jac
                cv = np.linalg.pinv(jtj)
                self.covar = np.zeros((npar, npar))
                for a, ia in enumerate(free_idx):
                    for b, ib in enumerate(free_idx):
                        self.covar[ia, ib] = cv[a, b]
                self.perror = np.zeros(npar)
                d = np.diagonal(self.covar)
                wh = np.nonzero(d >= 0)[0]
                self.perror[wh] = np.sqrt(np.maximum(d[wh], 0.0))
            except Exception:  # pragma: no cover - degenerate jacobian
                self.covar = None
                self.perror = None

    def __str__(self):
        return ("mpfit(status=%s, params=%s)" %
                (self.status, self.params))

    def enorm(self, vec):
        """Euclidean norm (mpfit.py enorm helper)."""
        return float(np.sqrt(np.sum(np.asarray(vec, dtype=float) ** 2)))
