from .proteome import (load_proteome, homogenize, cleave, attach,
                       homogenize_attached, _dp, _exposures, window_filter)
from .signals import random_signal, monte_carlo_trie
from .trie import SignalTrie, SlimSignalTrie, PolyfluorSignalTrie
from .polyfluor import PolyfluorSignal, PolyfluorPeptide, PolyfluorPeptide_v2
from .events import (FluorEvent, simulate_dye_counts, simulate_photometries,
                     peptide_simulation, convert_to_oldstyle)
from .dye_sim import simulate_dye_counts_batched

__all__ = [
    "load_proteome", "homogenize", "cleave", "attach", "homogenize_attached",
    "_dp", "_exposures", "window_filter", "random_signal", "monte_carlo_trie",
    "SignalTrie", "SlimSignalTrie", "PolyfluorSignalTrie", "PolyfluorSignal",
    "PolyfluorPeptide", "PolyfluorPeptide_v2", "FluorEvent",
    "simulate_dye_counts", "simulate_photometries", "peptide_simulation",
    "convert_to_oldstyle", "simulate_dye_counts_batched",
]
