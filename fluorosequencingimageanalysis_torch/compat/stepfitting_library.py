"""The reference's ``stepfitting_library`` module
(stepfitting_library.py), on the port's copy of the step fitters."""

from ..stepfitting import *  # noqa
from ..stepfitting import (  # noqa
    _pairwise, _fit_plateau, _split_plateau, _best_split, _fit_steps,
    _plateau_squared_residuals, _plateaus_squared_residuals,
    _merge_plateaus, _consecutive_integers, _t_test_filter_singlepass,
    _filter_upsteps_singlepass, _filter_small_steps_singlepass,
    _triplewise)
