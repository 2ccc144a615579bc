"""Device selection, the sharding rule and the float32 precision pins
shared by the port.

The JAX reference computes its float32 matrix products and convolutions at
``lax.Precision.HIGHEST`` (ops/candidates.py:82 of the JAX package). On an
NVIDIA card PyTorch would run cuDNN convolutions in TF32 by default, which
keeps about three decimal digits; both TF32 switches are pinned off when the
port is imported.

``default_device`` is the device of the callers that take no ``device=``
argument, as the reference's classes and shims take none.
``NATIVE_STACK_DTYPES`` are the image dtypes that go to the device as
they are.

The sharding rule. ``Mesh`` and ``make_mesh`` are the counterparts of the
JAX package's (parallel/mesh.py there): torch devices in a (data, model)
grid. The ops that shard (``stack_background``, ``lc_track``,
``stepfit_batched``, ``score_traces``, ``gmm_fit_batched``) and the
``Pipeline`` methods take a device, a list of devices or a ``Mesh`` as
``device=``; ``data_devices`` names the devices of its data axis and
``shares`` cuts rows (frames, tracks, traces, models) into contiguous,
in-order shares, one per data device. The JAX package pads its rows to a
multiple of the axis for its compiled shapes; torch splits unevenly, so
nothing is padded here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Dtypes the step takes as they are: float32, and raw camera integers,
# which upload as-is (half the bytes of float32 for uint16) and are cast
# on the device. Anything else is cast to float32 on the host.
NATIVE_STACK_DTYPES = ("float32", "uint8", "uint16", "int16", "int32")


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


class Mesh:
    """Torch devices in a (data, model) grid: ``devices`` is a numpy
    object array of ``torch.device`` of shape (data, model),
    ``axis_names == ("data", "model")`` and ``shape`` maps each axis name
    to its size, as a ``jax.sharding.Mesh`` does."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh needs a non-empty (data, model) grid "
                             "of devices")
        self.devices = devices

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size


def make_mesh(n_devices=None, data_axis=None, model_axis=None,
              devices=None):
    """A ('data', 'model') mesh over ``devices`` (default: every visible
    CUDA device; raises without one), the first ``n_devices`` of them.

    By default all devices go to 'data' (the fields axis); pass explicit
    axis sizes for other splits. A device may appear more than once
    (two shards on one card)."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"n_devices={n_devices} exceeds the "
                         f"{len(devices)} devices given")
    devices = devices[:n_devices]
    if data_axis is None and model_axis is None:
        data_axis, model_axis = n_devices, 1
    elif data_axis is None:
        data_axis = n_devices // model_axis
    elif model_axis is None:
        model_axis = n_devices // data_axis
    if data_axis * model_axis != n_devices:
        raise ValueError("data_axis * model_axis must equal n_devices")
    grid = np.empty((data_axis, model_axis), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // model_axis, i % model_axis] = dev
    return Mesh(grid)


def is_device_list(device):
    """Whether ``device`` names a data axis to shard over (a list or tuple
    of devices, or a ``Mesh``) rather than one device."""
    return isinstance(device, (list, tuple, Mesh))


def data_devices(device):
    """The devices of the data axis, as a list of torch.device: a
    ``Mesh``'s ``devices[:, 0]`` (the JAX package shards these ops over
    ``mesh.axis_names[0]``; a model axis is not used by them), each entry
    of a list or tuple, or the one device named. A CUDA device the process
    cannot reach raises (``resolve_device``)."""
    if isinstance(device, Mesh):
        return list(device.devices[:, 0])
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    return [resolve_device(device)]


def shares(n, device):
    """``n`` rows cut into contiguous, in-order spans, one per data device
    of ``device`` (see ``data_devices``), the first ``n % len(devices)``
    one row longer: a list of (lo, hi, torch.device) that holds only the
    non-empty spans, or one empty span on the first device when ``n`` is
    0."""
    devs = data_devices(device)
    base, extra = divmod(n, len(devs))
    spans, lo = [], 0
    for i, d in enumerate(devs):
        hi = lo + base + (i < extra)
        if hi > lo:
            spans.append((lo, hi, d))
        lo = hi
    return spans or [(0, 0, devs[0])]
