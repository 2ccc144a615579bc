"""The reference's ``phase_correlate`` module (phase_correlate.py), on the
port's batched registration (ops/registration.py)."""

from ..ops.registration import (  # noqa
    phase_correlate, phase_correlate_jit, phase_correlate_stack, _dftups)

__all__ = ["phase_correlate", "_dftups"]
