"""The reference's ``mpfitexpr`` module (agpy's expression-string fit
wrapper; unused by the pipeline, kept for API parity): a copy of the repo's
root ``mpfitexpr.py`` shim over ``compat/mpfit``. Host code.
"""

import re

import numpy
import scipy

from . import mpfit as _mpfit_module


def mpfitexpr(func, x, y, err, start_params, check=True, full_output=False,
              imports=None, **kw):
    """Fit expression ``func`` (e.g. ``'p[0]+p[2]*(x-p[1])'``) to (x, y, err).

    Returns (params, yfit), or (mpfit_result, yfit) with full_output=True.
    """
    env = {"numpy": numpy, "scipy": scipy}
    if imports is not None:
        for name in imports:
            env[name] = __import__(name)

    def myfunc(p, fjac=None, x=None, y=None, err=None):
        return [0, eval("(y-(%s))/err" % func, env,
                        {"p": p, "x": x, "y": y, "err": err})]

    matcher = re.compile(r"[^a-zA-Z]p\[(\d+)\]")
    maxp = -1
    for m in re.finditer(matcher, func):
        maxp = max(maxp, int(m.group(1)))
    if check:
        if maxp == -1:
            raise Exception("wrong function format")
        if maxp + 1 != len(start_params):
            raise Exception("the length of the start_params != the length "
                            "of the parameter verctor of the function")
    fa = {"x": x, "y": y, "err": err}
    res = _mpfit_module.mpfit(myfunc, start_params, functkw=fa, **kw)
    yfit = eval(func, dict(env), {"x": x, "p": res.params})
    if full_output:
        return (res, yfit)
    return (res.params, yfit)
