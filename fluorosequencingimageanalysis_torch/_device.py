"""Device selection and the float32 precision pins shared by the port.

The JAX reference computes its float32 matrix products and convolutions at
``lax.Precision.HIGHEST`` (ops/candidates.py:82 of the JAX package). On an
NVIDIA card PyTorch would run cuDNN convolutions in TF32 by default, which
keeps about three decimal digits; both TF32 switches are pinned off when the
port is imported.

``default_device`` is the device of the callers that take no ``device=``
argument, as the reference's classes and shims take none.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist, and a bare
    "cuda" names the current one (so it compares equal to the device of
    the tensors placed there)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_cuda() -> None:
    """Raise when this process cannot reach a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available to this process (torch "
            f"{torch.__version__}, built for CUDA {torch.version.cuda})")


_DEFAULT = None  # set by set_default_device; None: the environment decides


def default_device() -> str:
    """The device of the object layer (``Spot``, ``Image``, the experiment
    classes), the compat shims and the detection entry points called
    without ``device=``: the one ``set_default_device`` named, else the
    ``FSIA_TORCH_DEVICE`` environment variable, else "cuda". Read at each
    call, so a change takes effect at once."""
    if _DEFAULT is not None:
        return _DEFAULT
    return os.environ.get("FSIA_TORCH_DEVICE") or "cuda"


def set_default_device(device):
    """Make ``device`` the process-wide default and return it as a
    torch.device (None: back to the environment's, returns None). A CUDA
    device must exist: without a card "cuda" raises here and the default
    stays as it was; nothing falls back to the CPU."""
    global _DEFAULT
    if device is None:
        _DEFAULT = None
        return None
    dev = resolve_device(device)
    _DEFAULT = str(device)
    return dev
