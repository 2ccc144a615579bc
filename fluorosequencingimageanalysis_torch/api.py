"""The port's front door: ``Pipeline(device=...).run_stack(stack)``.

Counterpart of fluorosequencingimageanalysis_tpu/api.py ``Pipeline``'s
``run_stack``, on one device. The JAX Pipeline's artifact store, mesh
padding and stage profiler are not ported yet.

    from fluorosequencingimageanalysis_torch.api import Pipeline
    out = Pipeline(device="cuda").run_stack(stack)   # [F, C, H, W]
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .config import PipelineConfig

# Dtypes the step takes as they are: float32, and raw camera integers,
# which upload as-is (half the bytes of float32 for uint16) and are cast
# on the device. Anything else is cast to float32 on the host.
_NATIVE_STACK_DTYPES = ("float32", "uint8", "uint16", "int16", "int32")


def _normalize_stack(stack):
    """Host-side dtype normalisation; tensors pass through untouched."""
    if isinstance(stack, torch.Tensor):
        return stack
    stack = np.asarray(stack)
    if stack.dtype.name not in _NATIVE_STACK_DTYPES:
        stack = stack.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(stack))


class Pipeline:
    """Config-driven experiment step on one device."""

    def __init__(self, config: PipelineConfig | None = None,
                 device="cuda"):
        """
        Arguments:
            config: PipelineConfig (defaults mirror the reference's); the
                JAX package's PipelineConfig works too.
            device: where the step runs ("cuda", "cuda:1", "cpu", ...). A
                CUDA device must exist; CPU runs the kernels' plain twins.
        """
        self.config = config if config is not None else PipelineConfig()
        self.device = resolve_device(device)

    def run_stack(self, stack, max_candidates=None, max_spots=None,
                  keys=None, photometry_method=None,
                  photometry_min="config"):
        """Align + detect + fit + photometry over a [F, C, H, W] stack.

        ``stack``: numpy array or tensor; integer camera dtypes upload
        as-is and are cast to float32 on the device. ``keys``: optional
        names of the outputs to return. ``photometry_method`` /
        ``photometry_min``: overrides of the config's photometry method and
        floor ("config" keeps the config's floor, None disables it).

        Returns a dict of host numpy arrays with the schema of the JAX
        package's ``experiment_step_sharded``.
        """
        from .parallel.mesh import experiment_step
        from .utils.convert import step_kwargs

        stack = _normalize_stack(stack)
        if stack.ndim != 4 or stack.shape[0] == 0:
            raise ValueError("stack must be a non-empty [fields, cycles, "
                             f"H, W] array (got shape {tuple(stack.shape)})")
        kw = step_kwargs(self.config)
        if max_candidates is not None:
            kw["max_candidates"] = max_candidates
        if photometry_method is not None:
            kw["photometry_method"] = photometry_method
        if photometry_min != "config":
            kw["photometry_min"] = photometry_min
        if keys is not None:
            keys = tuple(keys)
        x = stack.to(self.device)
        with torch.no_grad():
            out = experiment_step(x, max_spots=max_spots, **kw)
        return {k: v.cpu().numpy() for k, v in out.items()
                if keys is None or k in keys}

