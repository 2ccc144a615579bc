from .photometries import (read_track_photometries_csv, unwind_photometries,
                           write_photometries_dict_to_csv)
from .calibration import (optimal_bin_size, optimal_bin_size_MP, _get_m0Dm1,
                          last_drop_method, last_drop_method_v2)
from .lognormal import (_intensities_to_signal_lognormal_v8,
                        _photometries_lognormal_fit_MP_v8,
                        photometries_lognormal_fit_v8)
from . import background

__all__ = [
    "read_track_photometries_csv", "unwind_photometries",
    "write_photometries_dict_to_csv", "optimal_bin_size",
    "optimal_bin_size_MP", "_get_m0Dm1", "last_drop_method",
    "last_drop_method_v2", "_intensities_to_signal_lognormal_v8",
    "_photometries_lognormal_fit_MP_v8", "photometries_lognormal_fit_v8",
    "background",
]
