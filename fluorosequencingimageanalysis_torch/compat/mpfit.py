"""The ``mpfit`` import surface (agpy/mpfit/mpfit.py of the reference,
reached via agpy's path insertion, pflib.py:22-23 / gaussfitter.py
imports). The class lives in mpfit_compat; the pipeline's PSF fits use
the batched LM (ops/lm.py) and kernel B instead.
"""

from ..mpfit_compat import mpfit  # noqa
