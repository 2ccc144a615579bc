"""The reference's ``peptide_simulator`` module (peptide_simulator.py), on
the port's sim layer; the batched simulators run on the process default
device (``compat/_on_default_device``)."""

from ..sim.events import (  # noqa
    FluorEvent, _define_reserved_character, _make_mock, _make_edman,
    _make_tirf, _make_dud, _increment_cycle, _make_count_dyes,
    _make_strip_surface, _make_get_dye_positions, simulate_dye_counts,
    simulate_photometries, peptide_simulation, convert_to_oldstyle)
from ._on_default_device import (  # noqa
    simulate_dye_counts_batched, simulate_photometries_batched)
