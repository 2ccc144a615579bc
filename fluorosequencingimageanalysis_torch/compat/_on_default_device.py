"""The port's functions that the reference's modules re-export and that
reach a device, run on the process default device.

The port's own functions take ``device=`` ("cuda" by default); the
reference's modules take none. These wrappers pass
``_device.default_device()``, read at each call, so ``compat.MCsimlib``,
``compat.peptide_simulator`` and the apps follow ``--device``,
``FSIA_TORCH_DEVICE`` and ``_device.set_default_device`` as the rest of
``compat/`` does. An explicit ``device=`` still wins.
"""

import functools

from .._device import default_device
from ..inference import lognormal as _lognormal
from ..sim import dye_sim as _dye_sim


def _on_default_device(fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        kwargs.setdefault("device", default_device())
        return fn(*args, **kwargs)
    return call


photometries_lognormal_fit_v8 = _on_default_device(
    _lognormal.photometries_lognormal_fit_v8)
simulate_dye_counts_batched = _on_default_device(
    _dye_sim.simulate_dye_counts_batched)
simulate_photometries_batched = _on_default_device(
    _dye_sim.simulate_photometries_batched)
simulate_and_fit_batched = _on_default_device(
    _dye_sim.simulate_and_fit_batched)


def _photometries_lognormal_fit_MP_v8(photometries, beta, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=True, max_deviation=3,
                                      quench_factor=0, quench_factors=None):
    """The reference's signature (MCsimlib.py:5496-5558): the batched v8
    fit on the default device (num_processes accepted, unused)."""
    return photometries_lognormal_fit_v8(
        photometries, beta, beta_sigma, max_possible=max_possible,
        allow_upsteps=allow_upsteps, allow_multidrop=allow_multidrop,
        max_deviation=max_deviation, quench_factor=quench_factor,
        quench_factors=quench_factors)
