"""The reference's ``MCsimlib`` module surface (MCsimlib.py), on the port:
a copy of the repo's root ``MCsimlib.py`` shim with its imports pointed at
the PyTorch package (sim/, inference/, the native sampler). The batched v8
fit runs on the process default device (``compat/_on_default_device``);
``have_native`` is not re-exported (the port's native cores have no Python
fallback to report on)."""

# Proteome prep + analytic model (sim/proteome.py)
from ..sim.proteome import (  # noqa
    _dp, load_proteome, homogenize, cleave, attach, homogenize_attached,
    discard, truncate_heads, edman_failure_gaps, edman_failure_gaps_MP,
    _split_peptides_for_mp, _exposures, window_filter, perfect)

# MC generators + tries (sim/)
from ..sim.signals import (  # noqa
    random_signal, monte_carlo_trie, monte_carlo_trie_MP,
    monte_carlo_dictionary, monte_carlo_dictionary_MP)
from ..sim.trie import (  # noqa
    SignalTrie, SlimSignalTrie, PolyfluorSignalTrie)
from ..sim.polyfluor import (  # noqa
    PolyfluorSignal, PolyfluorPeptide, PolyfluorPeptide_v2)

# Track ingestion + plateau/cluster fits + remainder adjust (inference/)
from ..inference.photometries import (  # noqa
    read_track_photometries_csv, _pairwise, _r_2, _check_no_downsteps,
    _plateau_fit, _all_plateau_fits, _remainder_adjust, _remainder_adjust_2)
from ..inference.calibration import (  # noqa
    optimal_bin_size, optimal_bin_size_MP, _get_m0Dm1, last_drop_method,
    last_drop_method_v2)
from ..inference.lognormal import (  # noqa
    _intensities_to_signal_lognormal_v8)
from ._on_default_device import (  # noqa
    _photometries_lognormal_fit_MP_v8, photometries_lognormal_fit_v8)
from ..inference.photometries import (  # noqa
    unwind_photometries, write_photometries_dict_to_csv)

# Signal algebra + background correction (inference/background.py)
from ..inference.background import (  # noqa
    is_multidrop, discard_late_signals, head_truncate, counts_to_percent,
    sum_signals, average_signals, signals_std, generate_adjacent_positions,
    interpolate_signal, outlier_z_scores, iterative_peak_finding,
    iterative_peak_finding_v2, iterative_peak_finding_v3,
    subtract_false_positives, expected_background)

# Legacy fitter generations v1-v7 + nearest neighbor (inference/lognormal_legacy.py)
from ..inference.lognormal_legacy import (  # noqa
    _intensities_to_signal_lognormal, _photometries_lognormal_fit_MP,
    _per_cycle_intensities_to_signal_lognormal,
    _intensities_to_signal_lognormal_v2, _photometries_lognormal_fit_MP_v2,
    _intensities_to_signal_lognormal_v3, _photometries_lognormal_fit_MP_v3,
    _intensities_to_signal_lognormal_v4, _photometries_lognormal_fit_MP_v4,
    _intensities_to_signal_lognormal_v5, _photometries_lognormal_fit_MP_v5,
    _intensities_to_signal_lognormal_v6, _photometries_lognormal_fit_MP_v6,
    _intensities_to_signal_lognormal_v7, _photometries_lognormal_fit_MP_v7,
    _find_deltas, _lognormal_nearest_neighbor, _lognormal_nearest_neighbor_MP)

# GMM / cluster fitters + parameter sweeps (inference/gmm.py)
from ..inference.gmm import (  # noqa
    _gmm_photometries, _gmm_photometries_MP, _per_cycle_gmm_MP, _gmm_adjust,
    _cluster_fit, _cluster_fit_2, _collate_means_into_fit,
    _find_experiment_levels, _translate_plateaus_into_signal,
    _translate_plateaus_into_signal_2, _translate_plateaus_into_signal_3,
    _parallel_cluster_fit, _save_clustered_photometries_csv,
    _parameter_sweep, _parameter_sweep_2, _parallel_parameter_sweep,
    _ps_results_analysis)

# FWHM calibration (inference/calibration.py)
from ..inference.calibration import (  # noqa
    fwhm_method, fwhm_method_v2)

# Native (C++) batch signal sampler — fills the reference's documented-but-
# missing ``randsiggen`` C slot (MCsimlib.py:1823-1830).
from ..native.randsiggen import (  # noqa
    random_signal_batch, monte_carlo_trie_native)

# Nested-pool helpers (MCsimlib.py:3475-3487). Retained for API parity;
# the port's parallelism is batched device programs, not process pools.
import multiprocessing
import multiprocessing.pool


class NoDaemonProcess(multiprocessing.Process):
    """Process whose daemon flag is pinned False so it may spawn children
    (MCsimlib.py:3475-3482)."""

    @property
    def daemon(self):
        return False

    @daemon.setter
    def daemon(self, value):
        pass

    # Py2-style accessor aliases (the reference defines the property via
    # _get_daemon/_set_daemon, MCsimlib.py:3476-3482).
    def _get_daemon(self):
        return False

    def _set_daemon(self, value):
        pass


class MyPool(multiprocessing.pool.Pool):
    """Pool of NoDaemonProcesses, allowing nested pools
    (MCsimlib.py:3484-3487)."""

    @staticmethod
    def Process(ctx, *args, **kwds):
        proc = NoDaemonProcess(*args, **kwds)
        return proc
