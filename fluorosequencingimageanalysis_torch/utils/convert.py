"""PipelineConfig -> keyword arguments of the port's experiment step.

The one place that says which config fields the port reads. Either
package's PipelineConfig works (they have the same fields). Ignored:

- ``detect.use_pallas`` and ``detect.gather_strategy``: backend choices of
  the JAX package; the port takes its CUDA kernels on CUDA tensors and
  their plain twins on CPU tensors;
- ``detect.single_field_cap``, the stepfit / lognormal sections and the
  sextractor photometry fields: surfaces the port does not have yet.
"""

from __future__ import annotations

import numpy as np

IGNORED_DETECT_FIELDS = ("use_pallas", "gather_strategy")


def step_kwargs(config, correlation_matrix=None):
    """``experiment_step`` keyword arguments from a PipelineConfig and an
    optional (numpy) correlation template (None = the default one)."""
    det = config.detect
    phot = config.photometry
    return dict(
        median_filter_size=det.median_filter_size,
        c_std=det.c_std,
        r_2_threshold=det.r_2_threshold,
        consolidation_radius=det.consolidation_radius,
        max_candidates=det.max_candidates,
        num_iters=det.num_iters,
        theta_starts=det.theta_starts,
        correlation_matrix=(None if correlation_matrix is None
                            else np.asarray(correlation_matrix,
                                            dtype=np.float64)),
        upsample_factor=config.registration.upsample_factor,
        photometry_method=phot.method,
        photometry_radius=phot.radius,
        photometry_brim=phot.brim_size,
        photometry_min=phot.photometry_min,
    )
