from .gaussian import gauss2d_ref, gauss2d_image, PSF_PARAM_NAMES
from .lm import fit_gaussians_batched, default_fit_bounds, default_fit_init

__all__ = [
    "gauss2d_ref", "gauss2d_image", "PSF_PARAM_NAMES",
    "fit_gaussians_batched", "default_fit_bounds", "default_fit_init",
]
