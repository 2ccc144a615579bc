"""Native (C++) host cores, loaded via ctypes.

The pieces that are serial, host-side and hot (the tracker, the step-fit
cores, the track-CSV parser, the Monte-Carlo signal sampler) are C++ with
a plain C ABI, built with ``g++`` at first use into ``_build/``
(``_build.py``); a failed build raises, there is no Python fallback.
"""

from .randsiggen import random_signal_batch, monte_carlo_trie_native
from .trackcsv import parse_track_csv_native, read_track_photometries_arrays

__all__ = ["random_signal_batch", "monte_carlo_trie_native",
           "parse_track_csv_native", "read_track_photometries_arrays"]
