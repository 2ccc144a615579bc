"""The reference's ``jupyter_development`` helpers (jupyter_development.py),
on the port's notebook.py and plotting.py (host code)."""

from ..notebook import (  # noqa
    _pairwise, grab_ON_OFFS, ON_OFF_adjust_photometries, signal_to_sequence,
    sequence_to_signal, sequence_to_category, r_squared, make_histx,
    fast_mode, qq, generate_intensities, generate_sequences, split_heatmap,
    unwind_photometries, diff_signals, fasta_to_dict, match_diagnostic,
    sig, signal_to_cumulative, grab_ith_intensities, grab_ith_jth_intensities,
    gmm_raw_photometries, signal_correlation, IncompatibilityKey,
    incompatibility_scores_cache)

# The reference keeps duplicate copies of the heatmap emitters here
# (jupyter_development.py:585,674); we re-export the plotting module's.
from ..plotting import (  # noqa
    single_drops_heatmap_v2, double_drops_heatmap_v2, colors)
