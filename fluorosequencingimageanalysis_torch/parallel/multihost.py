"""One experiment across processes, on ``torch.distributed``.

Counterpart of fluorosequencingimageanalysis_tpu/parallel/multihost.py.
Every process runs this same program on the fields (or the share of a
movie's spots) it holds, on its own devices, and the processes exchange
only host results: per-field row payloads, gathered step outputs, tracked
positions and step fits, all in process order. Fields, spots and frames
are independent, so no collective runs inside a step.

Usage, identical in every process::

    from fluorosequencingimageanalysis_torch.parallel import multihost

    multihost.initialize("localhost:29500", num_processes=2, process_id=r)
    local_fields = load_my_shard()          # [F_local, C, H, W]
    res = multihost.run_experiment(local_fields, csv_path="t.csv")
    # every process writes the same CSV, byte for byte the one a single
    # process's Pipeline.run_experiment writes for all the fields

The collectives carry pickled host objects (``all_gather_object``), so the
backend is gloo unless the caller names another: on the CPU, and on a
card too. Two processes may share one card. In the JAX package a global
mesh spans every process's devices; here a process drives only its own,
so ``global_mesh`` is this process's (data, model) mesh and the global
data axis is ``process_count()`` times its data axis.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import make_mesh
from .mesh import experiment_step_sharded, shard_fields

_INITIALIZED = False
_LOCAL_DEVICES = None  # from initialize(local_device_ids=...)


def _dist():
    import torch.distributed as dist
    return dist


def _live():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None, backend="gloo"):
    """Join this process to a ``torch.distributed`` group (idempotent).

    Explicitly: ``coordinator_address`` ("host:port" of process 0),
    ``num_processes`` and ``process_id``, all three; an incomplete
    specification raises ValueError rather than run every process on its
    own. With no argument, a group described by the environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them)
    is joined, and with none there this is a no-op: one process.
    ``local_device_ids``: the CUDA devices this process drives (default:
    every visible one). A no-op when a group already exists."""
    global _INITIALIZED, _LOCAL_DEVICES
    if _INITIALIZED:
        return
    if _live():
        _INITIALIZED = True
        return
    spec = (coordinator_address, num_processes, process_id)
    if any(a is None for a in spec) and (
            any(a is not None for a in spec) or local_device_ids is not None):
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id together (got coordinator_address="
            f"{coordinator_address!r}, num_processes={num_processes!r}, "
            f"process_id={process_id!r}, local_device_ids="
            f"{local_device_ids!r})")
    if local_device_ids is not None:
        _LOCAL_DEVICES = [torch.device("cuda", int(i))
                          for i in local_device_ids]
    dist = _dist()
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id))
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                       "WORLD_SIZE", "RANK")):
        dist.init_process_group(backend, init_method="env://")
    _INITIALIZED = True


def process_count():
    """Processes in the group (1 without one)."""
    return _dist().get_world_size() if _live() else 1


def process_index():
    """This process's rank (0 without a group)."""
    return _dist().get_rank() if _live() else 0


def global_mesh(data_axis=None, model_axis=None, devices=None):
    """This process's ('data', 'model') mesh: ``devices``, else the
    ``local_device_ids`` given to ``initialize``, else every visible CUDA
    device (``make_mesh``'s default). The global data axis is
    ``process_count()`` of these in process order."""
    if devices is None and _LOCAL_DEVICES is not None:
        devices = _LOCAL_DEVICES
    return make_mesh(data_axis=data_axis, model_axis=model_axis,
                     devices=devices)


def shard_fields_from_local(local_stack, mesh):
    """This process's part of the global [F_global, ...] stack: its own
    [F_local, ...] fields split over its mesh's data shards (nothing moves
    between processes)."""
    return shard_fields(local_stack, mesh)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _allgather_pickled(obj):
    """One Python object per process, gathered: the per-process list in
    process order."""
    nproc = process_count()
    if nproc == 1:
        return [obj]
    out = [None] * nproc
    _dist().all_gather_object(out, obj)
    return out


def allgather(tree):
    """Every process's part of a dict, list or tuple of arrays (or one
    array), as host numpy arrays concatenated along the first axis in
    process order (0-d parts stacked)."""
    def join(parts):
        parts = [np.asarray(p) for p in parts]
        if parts[0].ndim == 0:
            return np.stack(parts)
        return np.concatenate(parts)

    if isinstance(tree, dict):
        parts = _allgather_pickled({k: _host(v) for k, v in tree.items()})
        return {k: join([p[k] for p in parts]) for k in tree}
    if isinstance(tree, (list, tuple)):
        parts = _allgather_pickled([_host(v) for v in tree])
        return type(tree)(join([p[i] for p in parts])
                          for i in range(len(tree)))
    return join(_allgather_pickled(_host(tree)))


def run_experiment_step(local_fields, mesh=None, gather=True, keys=None,
                        **step_kwargs):
    """The experiment step over every process's fields.

    ``local_fields``: this process's [F_local, C, H, W] stack (raw camera
    dtypes are cast on the device), the same F_local in every process.
    Each process zero-pads its block to a multiple of its mesh's data axis
    and runs ``experiment_step_sharded`` on its own devices (``mesh``:
    default ``global_mesh()``); ``step_kwargs`` go to the step. With
    ``gather`` (default) the outputs (only ``keys``, when given) return
    to every process as numpy arrays over all processes' fields, in
    process order, padding removed; without, this process's dict of
    tensors, padding included."""
    if not isinstance(local_fields, torch.Tensor):
        local_fields = torch.from_numpy(np.ascontiguousarray(local_fields))
    if mesh is None:
        mesh = global_mesh()
    f_local = local_fields.shape[0]
    if process_count() > 1:
        counts = _allgather_pickled(f_local)
        if any(c != f_local for c in counts):
            raise ValueError(
                "run_experiment_step needs the same F_local in every "
                f"process; got per-process field counts {counts}")
    pad = (-f_local) % mesh.shape["data"]
    if pad:
        local_fields = torch.cat([local_fields, torch.zeros(
            (pad,) + tuple(local_fields.shape[1:]),
            dtype=local_fields.dtype)])
    out = experiment_step_sharded(local_fields, mesh, **step_kwargs)
    if keys is not None:
        out = {k: out[k] for k in keys}
    if not gather:
        return out
    return allgather({k: v[:f_local] for k, v in out.items()})


def run_experiment(local_stacks, csv_path=None, config=None, mesh=None,
                   max_candidates=None, max_spots=None, candidate_radius=2,
                   channel="ch1"):
    """The whole experiment across processes (basic_experiment_script's
    configuration: interpolation on; no mdma, averages or invalid traces).

    ``local_stacks``: this process's [F_local, C, H, W] fields, one array
    (channel ``channel``) or a dict {channel: array}, as for
    ``Pipeline.run_experiment``, the same F_local in every channel. Each
    process runs ``Pipeline(config, device=mesh).run_experiment`` on its
    own fields and devices; the rows are gathered, their fields offset by
    the field counts of the processes before, so every process holds all
    rows in channel order, then global field order, and with ``csv_path``
    writes the same track-photometries CSV, byte for byte the one a single
    process's ``Pipeline.run_experiment`` writes for the concatenated
    fields.

    Returns {rows, category_counts, filtered_category_counts, csv_path}.
    """
    from ..api import Pipeline
    from ..pipeline.fast_experiment import (
        filter_monotone_categories, write_track_rows_csv)

    if not isinstance(local_stacks, dict):
        local_stacks = {channel: local_stacks}
    field_counts = {s.shape[0] for s in local_stacks.values()}
    if len(field_counts) != 1:
        raise ValueError("every channel must have the same local field "
                         f"count (got {sorted(field_counts)})")
    if mesh is None:
        mesh = global_mesh()
    local = Pipeline(config=config, device=mesh).run_experiment(
        local_stacks, max_candidates=max_candidates, max_spots=max_spots,
        candidate_radius=candidate_radius)
    payloads = _allgather_pickled((field_counts.pop(), local["rows"]))
    offsets = np.cumsum([0] + [n for n, _ in payloads]).tolist()
    # Channel order, then process (= global field) order: the order of
    # Pipeline.run_experiment over the concatenated fields.
    rows = [(ch, lo + f, h0, w0, cat, ph) for c in local_stacks
            for lo, (_, part) in zip(offsets, payloads)
            for (ch, f, h0, w0, cat, ph) in part if ch == c]
    category_counts = {ch: {f: {} for f in range(offsets[-1])}
                       for ch in local_stacks}
    for (ch, f, h0, w0, cat, ph) in rows:
        counts = category_counts[ch][f]
        counts[cat] = counts.get(cat, 0) + 1
    filtered = filter_monotone_categories(category_counts)
    if csv_path is not None:
        write_track_rows_csv(rows, next(iter(local_stacks.values())).shape[1],
                             csv_path)
    return {"rows": rows, "category_counts": category_counts,
            "filtered_category_counts": filtered, "csv_path": csv_path}


def lc_track(movie, h0, w0, search_radius=3, s_n_cutoff=3.0, mesh=None):
    """Luminosity-centroid tracking with the spot axis split over every
    process's mesh data devices (``pipeline/fast_timetrace.lc_track``'s
    contract).

    Every process passes the same [T, H, W] movie and the same spots; each
    tracks its contiguous share (padded with in-bounds dummy spots to a
    whole number a device) and the tracked [T, N] positions are gathered to
    every process, equal to one process's ``lc_track`` of all of them."""
    from ..api import _normalize_stack
    from ..pipeline import fast_timetrace as ftt

    if mesh is None:
        mesh = global_mesh()
    devs = list(mesh.devices[:, 0])
    nproc, pidx = process_count(), process_index()
    t0h, t0w, r0h, r0w = ftt._initial_centers(h0, w0)
    N = len(t0h)
    n_shard = nproc * len(devs)
    pad = (-N) % n_shard
    fill = np.full(pad, search_radius + 2, np.int32)
    padded = [np.concatenate([a, fill]) for a in (t0h, t0w, r0h, r0w)]
    share = (N + pad) // n_shard
    movie = _normalize_stack(movie)
    parts = []
    for d, dev in enumerate(devs):
        lo = (pidx * len(devs) + d) * share
        states = [torch.from_numpy(a[lo:lo + share]).to(dev) for a in padded]
        with torch.no_grad():
            rec = ftt._lc_track_scan(movie.to(dev), *states,
                                     search_radius=search_radius,
                                     s_n_cutoff=float(s_n_cutoff))
        parts.append([_host(x) for x in rec])
    local = tuple(np.concatenate([p[i] for p in parts], axis=1)
                  for i in range(3))
    gathered = _allgather_pickled(local)
    rec_h, rec_w, present = (np.concatenate([g[i] for g in gathered], axis=1)
                             for i in range(3))
    rec_h = np.concatenate([padded[0][None], rec_h])[:, :N]
    rec_w = np.concatenate([padded[1][None], rec_w])[:, :N]
    present = np.concatenate([np.ones((1, N + pad), bool), present])[:, :N]
    return rec_h, rec_w, present


def run_timetrace(movie, csv_path=None, config=None, mesh=None,
                  search_radius=3, s_n_cutoff=3.0, max_candidates=None,
                  photometry_min="config", mirror_start=None,
                  chung_kennedy=None, p_threshold=None,
                  include_step_fits=True, include_intermediates=True):
    """The movie workflow (basic_timetrace_script) across processes.

    Every process passes the same [T, H, W] movie. Frame 0 is detected in
    each process and process 0's spots are used by all; the spots are
    tracked across every process's devices (``lc_track``); each process
    measures and step-fits its contiguous share of the traces; the shares
    are gathered, so every process assembles all traces in spot order and
    with ``csv_path`` writes the same CSV, byte for byte the one a single
    process's ``Pipeline.run_timetrace`` writes.

    Returns ``Pipeline.run_timetrace``'s dict (traces, photometries,
    step_fits, step_fit_intermediates, trace_count, csv_path).
    """
    from ..api import Pipeline, _normalize_stack
    from ..models.detect import find_peptide_centers
    from ..ops.background import widen
    from ..ops.stepfit_batch import stepfit_batched
    from ..pipeline.experiment import TimetraceExperiment
    from ..pipeline.fast_timetrace import timetrace_photometries
    from ..pipeline.traces import PhotometryTrace, PlateauTrace

    if mesh is None:
        mesh = global_mesh()
    pipe = Pipeline(config=config, device=mesh.devices[0, 0])
    det = pipe.config.detect
    phot = pipe.config.photometry
    sf = pipe.config.stepfit
    mirror_start = (sf.mirror_start if mirror_start is None
                    else mirror_start)
    chung_kennedy = (sf.chung_kennedy if chung_kennedy is None
                     else chung_kennedy)
    p_threshold = sf.p_threshold if p_threshold is None else p_threshold
    if isinstance(photometry_min, str):  # the "config" sentinel
        photometry_min = phot.photometry_min

    movie = _normalize_stack(movie)
    if movie.ndim != 3:
        raise ValueError("movie must be [frames, H, W]")
    T = movie.shape[0]
    with torch.no_grad():
        movie_dev = widen(movie.to(pipe.device))
    h0_l, w0_l, fits_l, _count = find_peptide_centers(
        movie_dev[0],
        median_filter_size=det.median_filter_size, c_std=det.c_std,
        r_2_threshold=det.r_2_threshold,
        consolidation_radius=det.consolidation_radius,
        max_candidates=(max_candidates if max_candidates is not None
                        else det.single_field_cap),
        num_iters=det.num_iters, device=None)
    h0, w0, fits = _allgather_pickled((h0_l, w0_l, fits_l))[0]
    N = len(h0)
    if N == 0:
        if csv_path is not None:
            TimetraceExperiment(
                frames=[None] * T, spot_traces=[], step_fits={},
                step_fit_intermediates={}
            ).save_experiment_as_csv(
                csv_path, include_step_fits=include_step_fits,
                include_intermediates=None, photometry_method=phot.method)
        return {"traces": {"h": [], "w": [], "present": None,
                           "rec_h": None, "rec_w": None},
                "photometries": np.zeros((0, T)),
                "step_fits": {}, "step_fit_intermediates": {},
                "trace_count": 0, "csv_path": csv_path}

    rec_h, rec_w, present = lc_track(movie, h0, w0,
                                     search_radius=search_radius,
                                     s_n_cutoff=s_n_cutoff, mesh=mesh)
    nproc, pidx = process_count(), process_index()
    share = -(-N // nproc)
    lo, hi = min(N, pidx * share), min(N, (pidx + 1) * share)
    phot_local = timetrace_photometries(
        movie_dev, rec_h[:, lo:hi], rec_w[:, lo:hi], present[:, lo:hi],
        phot.method, initial_fits=[fits[i] for i in range(lo, hi)],
        photometry_radius=phot.radius, photometry_brim=phot.brim_size,
        photometry_min=photometry_min,
        aperture_radius=phot.aperture_radius, box_size=phot.box_size,
        filter_size=phot.filter_size)
    results_local = (stepfit_batched(phot_local, mirror_start=mirror_start,
                                     chung_kennedy=chung_kennedy,
                                     p_threshold=p_threshold,
                                     window_radius=sf.window_radius,
                                     device=pipe.device)
                     if hi > lo else [])
    parts = _allgather_pickled((phot_local, results_local))
    photometries = np.concatenate([p[0] for p in parts], axis=0)
    results = [r for p in parts for r in p[1]]

    step_fits = {}
    intermediates = {}
    spot_traces = []
    for (hh, ww), (phots, ck, plateaus, t_filtered) in zip(zip(h0, w0),
                                                          results):
        hw = (hh, ww)
        if hw in step_fits:
            raise Exception("Two tracks have initial Spots with "
                            "identical (h, w).")
        step_fits[hw] = PlateauTrace(t_filtered, hh, ww)
        intermediates[hw] = {
            "photometries": PhotometryTrace(phots, hh, ww),
            "ck_filtered_photometries": PhotometryTrace(ck, hh, ww),
            "plateaus": PlateauTrace(plateaus, hh, ww),
            "t_filtered_plateaus": PlateauTrace(t_filtered, hh, ww),
        }
        spot_traces.append(PhotometryTrace(phots, hh, ww))
    if csv_path is not None:
        TimetraceExperiment(
            frames=[None] * T, spot_traces=spot_traces, step_fits=step_fits,
            step_fit_intermediates=intermediates
        ).save_experiment_as_csv(
            csv_path, include_step_fits=include_step_fits,
            include_intermediates=include_intermediates,
            photometry_method=phot.method)
    return {"traces": {"h": h0, "w": w0, "present": present,
                       "rec_h": rec_h, "rec_w": rec_w},
            "photometries": photometries, "step_fits": step_fits,
            "step_fit_intermediates": intermediates,
            "trace_count": len(spot_traces), "csv_path": csv_path}


def stack_background(local_frames, box_size=10, filter_size=10,
                     clip_sigma=3.0, clip_maxiters=10, mesh=None):
    """SExtractor background maps of every process's frames: each process
    splits its [T_local, H, W] frames over its mesh's data devices (the
    last frame repeated to a whole number a device), and the maps of all
    processes return to every process as one numpy array in process
    order, padding removed (``ops/background.stack_background``'s values,
    frame by frame)."""
    from ..ops.background import stack_background as background

    if not isinstance(local_frames, torch.Tensor):
        local_frames = torch.from_numpy(np.ascontiguousarray(local_frames))
    if mesh is None:
        mesh = global_mesh()
    devs = list(mesh.devices[:, 0])
    f_local = local_frames.shape[0]
    pad = (-f_local) % len(devs)
    if pad:
        local_frames = torch.cat([local_frames, local_frames[-1:].expand(
            pad, *local_frames.shape[1:])])
    share = local_frames.shape[0] // len(devs)
    maps = []
    for d, dev in enumerate(devs):
        with torch.no_grad():
            maps.append(_host(background(
                local_frames[d * share:(d + 1) * share].to(dev),
                box_size=box_size, filter_size=filter_size,
                clip_sigma=clip_sigma, clip_maxiters=clip_maxiters)))
    return allgather(np.concatenate(maps)[:f_local])
