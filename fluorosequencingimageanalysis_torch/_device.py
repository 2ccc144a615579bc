"""Device selection and the float32 precision pins shared by the port.

The JAX reference computes its float32 matrix products and convolutions at
``lax.Precision.HIGHEST`` (ops/candidates.py:82 of the JAX package). On an
NVIDIA card PyTorch would run cuDNN convolutions in TF32 by default, which
keeps about three decimal digits; both TF32 switches are pinned off when the
port is imported.
"""

from __future__ import annotations

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
