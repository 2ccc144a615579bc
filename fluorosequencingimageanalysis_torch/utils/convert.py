"""What the two packages share: configuration and result containers.

``step_kwargs`` is the one place that says which config fields the port's
experiment step reads. Either package's PipelineConfig works (they have
the same fields). Ignored:

- ``detect.use_pallas`` and ``detect.gather_strategy``: backend choices of
  the JAX package; the port takes its CUDA kernels on CUDA tensors and
  their plain twins on CPU tensors;
- ``detect.single_field_cap`` and the stepfit / lognormal sections:
  surfaces the port does not have yet.

``port_config`` turns either package's config into the port's classes, and
``spot_find_result`` / ``numpy_spot_find_result`` carry a SpotFindResult
between the packages by its field names (the JAX package returns numpy or
jax arrays, the port tensors or numpy), so tests can feed both sides the
same thing. Nothing here imports the JAX package.
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
