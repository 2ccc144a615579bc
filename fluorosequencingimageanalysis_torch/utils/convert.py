"""What the two packages share: configuration and result containers.

``step_kwargs`` is the one place that says which config fields the port's
experiment step reads. Either package's PipelineConfig works (they have
the same fields). Ignored:

- ``detect.use_pallas`` and ``detect.gather_strategy``: backend choices of
  the JAX package; the port takes its CUDA kernels on CUDA tensors and
  their plain twins on CPU tensors;
- the lognormal section: a surface the port does not have yet.
  (``detect.single_field_cap`` and the stepfit section are read by
  ``api.Pipeline.run_timetrace`` and ``stepfit``.)

``port_config`` turns either package's config into the port's classes, and
``spot_find_result`` / ``numpy_spot_find_result`` carry a SpotFindResult
between the packages by its field names (the JAX package returns numpy or
jax arrays, the port tensors or numpy), so tests can feed both sides the
same thing. ``timetrace_result_arrays`` flattens either package's
``run_timetrace`` result into comparable numpy arrays. ``port_mixture``
makes a fitted port ``GaussianMixture`` from a fit's weights, means and
covariances (a scikit-learn estimator's or a ``BatchedGMM1D``'s). Nothing
here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as _config
from ..models.detect import SpotFindResult, _numpy_fields

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


def port_config(config):
    """The port's PipelineConfig (or section config) with the values of
    ``config``, which may be either package's."""
    cls = getattr(_config, type(config).__name__)
    values = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        values[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**values)


def spot_find_result(res, device="cpu"):
    """The port's SpotFindResult of tensors on ``device`` from any
    SpotFindResult (either package's; numpy, jax or tensor fields). Integer
    fields take the device schema's int32."""
    fields = []
    for name in SpotFindResult._fields:
        a = getattr(res, name)
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))        # a writable copy (jax arrays are not)
        if name in ("cand_h", "cand_w", "cand_count"):
            t = t.to(torch.int32)
        fields.append(t.to(device))
    return SpotFindResult(*fields)


def numpy_spot_find_result(res, cls=SpotFindResult):
    """``res`` with host numpy fields, as ``cls`` (pass the JAX package's
    SpotFindResult class to go back to it)."""
    return cls(*_numpy_fields(res))


def _plateau_arrays(plateaus):
    """(starts, stops, heights) arrays of a plateau-triple list."""
    starts = np.asarray([p[0] for p in plateaus], np.int64)
    stops = np.asarray([p[1] for p in plateaus], np.int64)
    heights = np.asarray([p[2] for p in plateaus], np.float64)
    return starts, stops, heights


def timetrace_result_arrays(out):
    """A ``run_timetrace`` result (either package's) as numpy: h0, w0
    [N] float64; rec_h, rec_w [T, N] int64; present [T, N] bool;
    photometries [N, T] float64; and, per trace in order, ``step_fits``,
    ``plateaus`` (before the t-test merge) as (starts, stops, heights)
    arrays and ``ck`` as the Chung-Kennedy-filtered trace. The result's
    dicts are keyed by (h0, w0), so traces are looked up by those keys."""
    tr = out["traces"]
    keys = list(zip(tr["h"], tr["w"]))
    inter = out["step_fit_intermediates"]
    return {
        "h0": np.asarray(tr["h"], np.float64),
        "w0": np.asarray(tr["w"], np.float64),
        "rec_h": np.asarray(tr["rec_h"], np.int64),
        "rec_w": np.asarray(tr["rec_w"], np.int64),
        "present": np.asarray(tr["present"], bool),
        "photometries": np.asarray(out["photometries"], np.float64),
        "step_fits": [_plateau_arrays(out["step_fits"][k].trace)
                      for k in keys],
        "plateaus": [_plateau_arrays(inter[k]["plateaus"].trace)
                     for k in keys],
        "ck": [np.asarray(inter[k]["ck_filtered_photometries"].trace,
                          np.float64) for k in keys],
    }


def port_mixture(weights, means, covariances, covariance_type="full"):
    """A fitted ``ops.mixture.GaussianMixture`` with these parameters (1D):
    its ``predict``, ``predict_proba``, ``score_samples``, ``bic`` and
    ``aic`` score X as the fit they came from does. ``covariances`` may
    come in any of the shapes scikit-learn or ``BatchedGMM1D`` keep them
    in."""
    from ..ops.mixture import GaussianMixture, _flat, _shape
    weights = np.asarray(weights, np.float64).reshape(-1)
    k = weights.shape[0]
    g = GaussianMixture(n_components=k, covariance_type=covariance_type)
    cov = _flat(covariances, covariance_type, k)
    g.weights_ = weights
    g.means_ = np.asarray(means, np.float64).reshape(k, 1)
    g.covariances_ = _shape(cov, covariance_type, "cov")
    g.precisions_cholesky_ = _shape(1.0 / np.sqrt(cov), covariance_type,
                                    "cov")
    g.precisions_ = g.precisions_cholesky_ ** 2
    return g
