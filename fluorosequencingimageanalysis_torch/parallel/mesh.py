"""The experiment step over a [fields, cycles, H, W] stack, on one device
or sharded over several.

Counterpart of fluorosequencingimageanalysis_tpu/parallel/mesh.py:
``make_mesh``, ``shard_fields`` and ``experiment_step_sharded``, with
``experiment_step`` as the one-device step they share. The JAX package
partitions one jitted program over a (data, model) device mesh; here a
``Mesh`` is torch devices in a (data, model) grid, and
``experiment_step_sharded`` runs ``experiment_step`` on each data shard's
fields on that shard's devices, its detection split over the shard's
model devices where the images divide. Fields are independent and the
step has no collective, so the only data motion is each shard's upload
and the gather of its results onto the mesh's first device.

The shards' steps are enqueued one after the other on the calling
thread (a step reads nothing back: the non-max suppression runs its whole
fixpoint on the card, ``ops/consolidate.py``); every shard's results stay
on its device until all have run. Nothing here is timed on more than one card.

``data_devices`` and ``shares`` are what the other sharded ops share
(``stack_background``, ``lc_track``, ``stepfit_batched``,
``score_traces`` and ``gmm_fit_batched``): their ``device=`` takes a
device, a list of devices or a ``Mesh``, and they cut their rows (frames,
tracks, traces, models) into contiguous, in-order shares, one per device
of the data axis. The JAX package pads its rows to
a multiple of the axis for its compiled shapes; torch splits unevenly, so
nothing is padded here.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import require_cuda, resolve_device
from ..models.detect import SpotFindResult, detect_and_fit_batch
from ..ops import photometry as phot_ops
from ..ops.candidates import topk_lowest_index
from ..ops.registration import phase_correlate_stack
from ..utils import profiling
from ..utils.rounding import py2_round_device_i32

PHOTOMETRY_METHODS = ("mexican_hat", "simple", "maximum", "gaussian_volume",
                      "sigmas")


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


def shard_fields(stack, mesh):
    """A [fields, ...] array or tensor split on 'data': one tensor of
    F / data fields per data shard, on that shard's first device. F must
    divide by the data axis (``api.Pipeline`` pads for its callers)."""
    if not isinstance(stack, torch.Tensor):
        stack = torch.from_numpy(np.ascontiguousarray(stack))
    n_data = mesh.shape["data"]
    F = stack.shape[0]
    if F % n_data:
        raise ValueError(f"{F} fields do not split into {n_data} data "
                         "shards; pad the fields axis to a multiple of the "
                         "data axis")
    share = F // n_data
    return [stack[i * share:(i + 1) * share].to(mesh.devices[i, 0])
            for i in range(n_data)]


def experiment_step_sharded(stack, mesh, **step_kwargs):
    """``experiment_step`` over a [F, C, H, W] stack sharded on ``mesh``:
    each data shard's fields on that shard's devices, detection split
    over its model devices where its F*C images divide by the model axis
    (like the JAX step's joint image sharding); otherwise on the shard's
    first device. Returns ``experiment_step``'s dict with the fields axis
    whole and in order, on the mesh's first device. F must divide by the
    data axis."""
    shards = shard_fields(stack, mesh)
    n_model = mesh.shape["model"]
    outs = []
    for i, x in enumerate(shards):
        detect_devices = list(mesh.devices[i]) if n_model > 1 else None
        with torch.no_grad():
            outs.append(experiment_step(x, detect_devices=detect_devices,
                                        **step_kwargs))
    first = mesh.devices[0, 0]
    return {k: torch.cat([o[k].to(first) for o in outs])
            for k in outs[0]}


def experiment_step(stack, median_filter_size=5, c_std=2.0,
                    r_2_threshold=0.7, consolidation_radius=4.0,
                    max_candidates=256, max_spots=None, num_iters=30,
                    theta_starts=1, correlation_matrix=None,
                    upsample_factor=20,
                    photometry_method="mexican_hat", photometry_radius=9,
                    photometry_brim=6, photometry_min=None,
                    detect_devices=None):
    """One full experiment step over a [F, C, H, W] tensor on its device.

    Stages: registration of consecutive cycles per field; detection +
    batched LM fit of every (field, cycle) image (on the unregistered
    images, like the JAX step); compaction of the kept fits into a
    [max_spots] bucket by R^2; photometry at the rounded kept centers.
    Integer stacks are cast to float32 on the device. correlation_matrix:
    the 5x5 detection template (None = DEFAULT_CORRELATION_MATRIX).
    detect_devices: devices that split the F*C images' detection between
    them, in order, when there are more than one and the count divides;
    the results return to the stack's device.

    Traced spans (``utils.profiling.span``): ``api/step/registration``,
    the detection's (``detect_and_fit_batch``) and
    ``api/step/photometry`` (the compaction and the photometry).

    Returns a dict of tensors on the stack's device; see
    ``experiment_step_sharded`` in the JAX package for each key's meaning:
    offsets_h/w [F, C]; params [F, C, K, 7]; keep, center_h/w [F, C, K];
    cand_count [F, C]; spot_h/w, spot_cand_idx, spot_valid, spot_rh/rw
    (int16), spot_state (int8), spot_cand_c, photometry,
    photometry_interior [F, C, S]; spot_count, spot_overflow [F, C].
    """
    F, C, H, W = stack.shape
    if stack.dtype != torch.float32:
        stack = stack.to(torch.float32)
    if photometry_method not in PHOTOMETRY_METHODS:
        raise ValueError("unknown photometry_method: " +
                         repr(photometry_method))
    if max_spots is None:
        max_spots = min(max_candidates, 512)
    elif max_spots > max_candidates:
        raise ValueError(
            f"max_spots={max_spots} exceeds max_candidates="
            f"{max_candidates}: the spot bucket compacts the candidate "
            "bucket, so it can never hold more entries")

    # 1. Registration of consecutive cycles, per field.
    with profiling.span("api/step/registration", device=stack.device):
        off_h, off_w, _, _ = phase_correlate_stack(stack, upsample_factor)

    # 2. Detection + fit over all (field, cycle) images at once.
    imgs = stack.reshape(F * C, H, W)
    detect_kw = dict(median_filter_size=median_filter_size,
                     correlation_matrix=correlation_matrix, c_std=c_std,
                     r_2_threshold=r_2_threshold,
                     consolidation_radius=consolidation_radius,
                     max_candidates=max_candidates, num_iters=num_iters,
                     theta_starts=theta_starts)
    n_split = len(detect_devices) if detect_devices is not None else 1
    if n_split > 1 and (F * C) % n_split == 0:
        per = F * C // n_split
        parts = [detect_and_fit_batch(imgs[j * per:(j + 1) * per].to(d),
                                      **detect_kw)
                 for j, d in enumerate(detect_devices)]
        res = SpotFindResult(*(torch.cat([getattr(p, f).to(stack.device)
                                          for p in parts])
                               for f in SpotFindResult._fields))
    else:
        res = detect_and_fit_batch(imgs, **detect_kw)
    K = max_candidates

    with profiling.span("api/step/photometry", device=stack.device):
        # 3. Compact the kept fits into a [max_spots] bucket by R^2 (NaN R^2
        # fits are kept by the gate and rank below every finite one; ties and
        # empty slots in ascending candidate index, like lax.top_k).
        keep_flat = res.keep.reshape(F * C, K)
        spot_count = keep_flat.sum(dim=-1, dtype=torch.int32)
        r2_rank = torch.where(torch.isnan(res.r2), -torch.inf, res.r2)
        score = torch.where(keep_flat, torch.clamp_min(r2_rank, -1e30),
                            -torch.inf)
        top_score, top_idx = topk_lowest_index(score, max_spots)
        spot_valid = top_score > -torch.inf
        sh = torch.gather(res.center_h, 1, top_idx)
        sw = torch.gather(res.center_w, 1, top_idx)

        # Py2-rounded int16 centers and the tri-state validity with the
        # Spot.__init__ box quirk (5x5 box on the rounded center, or the
        # reference's fallback that admits an out-of-box spot unless h_0 is
        # outside and w_0 inside, on the float centers).
        rh_i = py2_round_device_i32(sh)
        rw_i = py2_round_device_i32(sw)
        r_box = 2
        ok_plain = ((rh_i >= r_box) & (rh_i + r_box < H) &
                    (rw_i >= r_box) & (rw_i + r_box < W))
        in_h = (sh >= r_box) & (sh < H - r_box)
        in_w = (sw >= r_box) & (sw < W - r_box)
        quirk_keep = ok_plain | ~(~in_h & in_w)
        # 3 = wild: a kept fit whose center is non-finite or outside int16.
        wild = (~(torch.isfinite(sh) & torch.isfinite(sw)) |
                (torch.abs(rh_i) > 0x7FFF) | (torch.abs(rw_i) > 0x7FFF))
        rh_i = torch.where(wild, 0, rh_i)
        rw_i = torch.where(wild, 0, rw_i)
        spot_state = (spot_valid.to(torch.int8) *
                      (1 + quirk_keep.to(torch.int8)))
        spot_state = torch.where(
            wild & spot_valid,
            torch.tensor(3, dtype=torch.int8, device=stack.device),
            spot_state)
        cand_dtype = torch.int16 if max_candidates <= 0x7FFF else torch.int32

        # 4. Photometry at the kept spots.
        if photometry_method in ("gaussian_volume", "sigmas"):
            pk = torch.gather(res.params, 1,
                              top_idx[..., None].expand(-1, -1, 7))
            # The reference's left-to-right product order.
            if photometry_method == "gaussian_volume":
                phot = 1e6 * pk[..., 1] * pk[..., 4] * pk[..., 5]
            else:
                phot = 1e6 * pk[..., 4] * pk[..., 5]
            phot_interior = torch.ones_like(spot_valid)
        else:
            r = {"mexican_hat": photometry_radius, "simple": 2,
                 "maximum": 5}[photometry_method]
            # Static shapes force the clip: a spot within r of the border is
            # measured at a shifted window, flagged by photometry_interior.
            rch = torch.clamp(rh_i, r, H - r - 1)
            rcw = torch.clamp(rw_i, r, W - r - 1)
            phot_interior = (rch == rh_i) & (rcw == rw_i)
            if photometry_method == "mexican_hat":
                phot = phot_ops.mexican_hat_batch(imgs, rch, rcw,
                                                  brim_size=photometry_brim,
                                                  radius=photometry_radius)
            elif photometry_method == "simple":
                phot = phot_ops.simple_batch(imgs, rch, rcw, radius=2)
            else:
                phot = phot_ops.maximum_batch(imgs, rch, rcw, radius=5)
        if photometry_min is not None:
            # max(photometry_min, rp) of the reference: a NaN floors too.
            phot = torch.where(phot > photometry_min, phot,
                               torch.full_like(phot, photometry_min))
        # Empty slots zeroed by a select (NaN * 0 would stay NaN).
        phot = torch.where(spot_valid, phot, torch.zeros_like(phot))

    def fc(x):
        return x.reshape(F, C, *x.shape[1:])

    return {
        "offsets_h": off_h, "offsets_w": off_w,
        "params": fc(res.params), "keep": fc(res.keep),
        "center_h": fc(res.center_h), "center_w": fc(res.center_w),
        "cand_count": fc(res.cand_count),
        "spot_h": fc(sh), "spot_w": fc(sw),
        "spot_cand_idx": fc(top_idx.to(torch.int32)),
        "spot_valid": fc(spot_valid),
        "spot_rh": fc(rh_i.to(torch.int16)),
        "spot_rw": fc(rw_i.to(torch.int16)),
        "spot_state": fc(spot_state),
        "spot_cand_c": fc(top_idx.to(cand_dtype)),
        "spot_count": fc(spot_count),
        "spot_overflow": fc(spot_count > max_spots),
        "photometry": fc(phot),
        "photometry_interior": fc(phot_interior),
    }
