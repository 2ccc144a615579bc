"""The port's front door: ``Pipeline(device=...)``.

Counterpart of fluorosequencingimageanalysis_tpu/api.py ``Pipeline``'s
``run_stack``, ``run_zstack``, ``run_experiment``, ``run_timetrace``,
``run_timetraces``, ``run_files``, ``stepfit``, ``chi_squared_stepfit``,
``fluor_counts``, ``fluor_counts_calibrated``, ``per_cycle_gmm`` and
``simulate_signals``, with its content-hash artifact store
(utils/checkpoint.py). ``Pipeline(device=[...])`` (a device list, or a
``_device.Mesh``) runs every method the JAX Pipeline runs on its mesh
data-parallel over the data devices, as the JAX Pipeline does:
``run_stack`` and ``run_experiment`` (fields, padded to the data axis),
``run_zstack`` (frames), ``run_timetrace`` and ``run_timetraces``
(tracks, then traces), ``stepfit``, ``fluor_counts`` and
``fluor_counts_calibrated`` (traces) and ``per_cycle_gmm`` (models).
``simulate_signals`` and ``chi_squared_stepfit`` are host work whatever
the device.

    from fluorosequencingimageanalysis_torch.api import Pipeline
    out = Pipeline(device="cuda").run_stack(stack)       # [F, C, H, W]
    fits = Pipeline(device="cuda").run_zstack(frames)    # [T, H, W]
    res = Pipeline(device="cuda").run_experiment(stack, csv_path="t.csv")
    res = Pipeline(device="cuda").run_experiment_files(
        tif_paths, csv_path="t.csv")     # directory = cycle, file = field
    tt = Pipeline(device="cuda").run_timetrace(movie, csv_path="tt.csv")
    steps = Pipeline(device="cuda").stepfit(photometries)    # (N, T)
    signals, total, none_count, fit_info = Pipeline(
        device="cuda").fluor_counts("t.csv", beta=30000.0, beta_sigma=0.2)
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import logging
import warnings

import numpy as np
import torch

from ._device import (NATIVE_STACK_DTYPES, Mesh, data_devices, make_mesh,
                      resolve_device)
from ._transfer import Uploader, count_fetched, fetch, wait
from .config import PipelineConfig
from .utils import profiling

# Fields per group of run_experiment's grouped step. A group's upload runs
# beside the previous group's step and its host tracking beside the next
# group's step; 8 fields of 8 cycles of 512x512 is 32 MB of uint16 frames
# and 64 images per step.
GROUP_FIELDS = 8

# Frames per upload group of run_zstack: a group's upload runs beside the
# previous group's background + detect + fit. 8 frames of 512x512 uint16
# are 4 MB and one launch of the NMS kernel (ops/consolidate.py).
GROUP_FRAMES = 8

# The step outputs run_experiment fetches: the compact spot bucket (int16
# rounded centers, int8 tri-state, candidate order), its photometry, the
# offsets and the overflow flags. The [F, C, K] fit arrays stay on the
# device.
EXPERIMENT_KEYS = ("offsets_h", "offsets_w", "spot_rh", "spot_rw",
                   "spot_state", "spot_cand_c", "spot_overflow",
                   "cand_count", "photometry")

logger = logging.getLogger(__name__)


def _traced(method):
    """A Pipeline method that runs with the process's tracing switch on
    (``utils.profiling.tracing``) where the Pipeline has ``profile``."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with profiling.tracing(self.profile):
            return method(self, *args, **kwargs)
    return call


def _count_detected(cand_count, bucket):
    """Count the images of a fetched ``cand_count`` and their candidates
    (capped at ``bucket``, None for no cap) in ``detect/images`` and
    ``detect/candidates``."""
    cand_count = np.asarray(cand_count)
    if bucket is not None:
        cand_count = np.minimum(cand_count, bucket)
    profiling.bump("detect/images", int(cand_count.size))
    profiling.bump("detect/candidates", int(cand_count.sum()))


def _normalize_stack(stack):
    """Host-side dtype normalisation; tensors pass through untouched."""
    if isinstance(stack, torch.Tensor):
        return stack
    stack = np.asarray(stack)
    if stack.dtype.name not in NATIVE_STACK_DTYPES:
        stack = stack.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(stack))


class Pipeline:
    """Config-driven detection, z-stack, experiment, movie and step-fit
    paths on one device or sharded over several, optionally cached in an
    artifact store."""

    def __init__(self, config: PipelineConfig | None = None,
                 device="cuda", store=None, profile: bool = False):
        """
        Arguments:
            config: PipelineConfig (defaults mirror the reference's); the
                JAX package's PipelineConfig works too.
            device: where the step runs ("cuda", "cuda:1", "cpu", ...). A
                CUDA device must exist; CPU runs the kernels' plain twins.
                A list of devices, or a ``_device.Mesh``, shards
                every method the JAX Pipeline runs on its mesh over the
                data devices (see the module docstring); the first is
                ``self.device``, where the work that is not sharded runs
                (the detection of a movie's first frame, its photometry).
            store: utils.checkpoint.ArtifactStore for run caching, or None.
            profile: trace each call: the process's tracing switch is
                on while it runs (``utils.profiling.tracing``), so its
                ``api/*`` stages and the spans below them record host and
                device time into ``utils.profiling``'s registry and show
                in a ``torch.profiler`` timeline.
        """
        self.config = config if config is not None else PipelineConfig()
        self.mesh = None
        if isinstance(device, Mesh):
            self.mesh = device
        elif isinstance(device, (list, tuple)):
            self.mesh = make_mesh(devices=device)
        self.device = (self.mesh.devices[0, 0] if self.mesh is not None
                       else resolve_device(device))
        # What the sharded ops take as ``device=``: the mesh, else the one
        # device.
        self._ops_device = self.mesh if self.mesh is not None else self.device
        self.store = store
        self.profile = profile

    def _step(self, stack, **kw):
        """``experiment_step`` on ``self.device``, or sharded over
        ``self.mesh`` with the fields axis padded to a multiple of its
        data axis by repeating the last field (the padding is dropped)."""
        from .parallel.mesh import experiment_step, experiment_step_sharded

        if self.mesh is None:
            return experiment_step(stack, **kw)
        F = stack.shape[0]
        pad = (-F) % self.mesh.shape["data"]
        if pad:
            stack = torch.cat([stack, stack[-1:].expand(
                pad, *stack.shape[1:])])
        out = experiment_step_sharded(stack, self.mesh, **kw)
        return {k: v[:F] for k, v in out.items()}

    def _stage(self, name):
        if self.profile:
            return profiling.span(name)
        return contextlib.nullcontext()

    def _step_kwargs(self, max_candidates=None, photometry_method=None,
                     photometry_min="config"):
        from .utils.convert import step_kwargs

        kw = step_kwargs(self.config)
        if max_candidates is not None:
            kw["max_candidates"] = max_candidates
        if photometry_method is not None:
            kw["photometry_method"] = photometry_method
        if photometry_min != "config":
            kw["photometry_min"] = photometry_min
        return kw

    def _device_phot_method(self):
        """The photometry method of the device bucket on the grouped
        path: sextractor measures on the host on background-subtracted
        images, so the bucket carries the sigmas fit product instead of
        making the step raise."""
        m = self.config.photometry.method
        return "sigmas" if m == "sextractor" else m

    def _run_stack_key(self, stack, stack_key, mc, max_spots, keys,
                       device_method, photometry_min="config"):
        """The store key run_stack and _stack_step_groups share, as (key,
        stack_key). The device bucket's method is part of the key: the
        two paths share entries, and a direct sextractor call (which
        raises) must never hit the sigmas entry the grouped path writes."""
        from .utils.checkpoint import content_key
        if stack_key is None:
            stack_key = content_key(stack.cpu().numpy())
        return content_key("run_stack", stack_key, self.config.asdict(),
                           mc, max_spots,
                           sorted(keys) if keys is not None else None,
                           device_method, photometry_min), stack_key

    @_traced
    def run_stack(self, stack, max_candidates=None, max_spots=None,
                  keys=None, stack_key=None, photometry_method=None,
                  photometry_min="config"):
        """Align + detect + fit + photometry over a [F, C, H, W] stack.

        ``stack``: numpy array or tensor; integer camera dtypes upload
        as-is and are cast to float32 on the device. ``keys``: optional
        names of the outputs to return. ``stack_key``: optional
        precomputed content hash of the stack (utils.checkpoint.
        content_key of the host array) for the store. ``photometry_method`` /
        ``photometry_min``: overrides of the config's photometry method and
        floor ("config" keeps the config's floor, None disables it).

        Returns a dict of host numpy arrays with the schema of the JAX
        package's ``experiment_step_sharded``, from the artifact store
        (keyed by stack content + config) when one is set and holds it.
        """
        stack = _normalize_stack(stack)
        if stack.ndim != 4 or stack.shape[0] == 0:
            raise ValueError("stack must be a non-empty [fields, cycles, "
                             f"H, W] array (got shape {tuple(stack.shape)})")
        kw = self._step_kwargs(max_candidates, photometry_method,
                               photometry_min)
        if keys is not None:
            keys = tuple(keys)

        def compute():
            with self._stage("api/run_stack"):
                x = Uploader(stack, [(0, stack.shape[0], self.device)]).take(0)
                with torch.no_grad():
                    out = self._step(x, max_spots=max_spots, **kw)
                names = [k for k in out if keys is None or k in keys]
                return dict(zip(names, wait(fetch([out[k] for k in names]))))

        if self.store is not None:
            key, _ = self._run_stack_key(
                stack, stack_key, kw["max_candidates"], max_spots, keys,
                kw["photometry_method"], kw["photometry_min"])
            return self.store.get_or_compute(key, compute,
                                             meta={"stage": "run_stack"})
        return compute()

    def _stack_step_groups(self, stack, keys, max_candidates=None,
                           max_spots=None, stack_key=None,
                           dispatch="eager"):
        """Generator form of run_stack over groups of ``GROUP_FIELDS``
        fields, with unfloored photometry (the experiment rows are never
        floored, like the reference's track-photometries CSV).

        On a CUDA device the host stack is copied once into pinned memory
        and each group uploads from it on a side copy stream, behind an
        event that the group's step waits on. ``dispatch="eager"`` enqueues
        every group's upload up front; ``"window"`` keeps at most two
        groups' uploads ahead of the step, so that only those groups are
        resident (for callers short of device memory). Each group's step
        runs in field order; only the named ``keys`` are copied back, into
        pinned host memory without waiting. A stack already on the device
        is sliced, not copied.

        Yields ``(out_group, device_group, lo)`` in field order:
        out_group holds host numpy arrays of the keys for fields
        ``lo:lo + len``; device_group is the group's [g, C, H, W] tensor
        on the device, in the stack's dtype, for the hole gathers. Group
        k is yielded once group k+1's step has been enqueued. With an
        artifact store the concatenated outputs are cached under
        run_stack's key; a hit yields one ``(full_out, None, 0)``.
        """
        if dispatch not in ("eager", "window"):
            raise ValueError(f"dispatch must be 'eager' or 'window' (got "
                             f"{dispatch!r})")
        g = GROUP_FIELDS
        if self.mesh is not None:  # whole data shards a group
            n_data = self.mesh.shape["data"]
            g = max(g, n_data)
            g += (-g) % n_data
        kw = self._step_kwargs(max_candidates, self._device_phot_method(),
                               photometry_min=None)
        keys = tuple(keys)
        dev = self.device
        F = stack.shape[0]
        lows = list(range(0, F, g))
        key = None
        if self.store is not None:
            key, _ = self._run_stack_key(
                stack, stack_key, kw["max_candidates"], max_spots, keys,
                kw["photometry_method"], None)
            if self.store.exists(key):
                yield self.store.load(key), None, 0
                return
        with self._stage("api/run_stack"):
            uploader = Uploader(stack, [(lo, lo + g, dev) for lo in lows])

        def step(i):
            grp = uploader.take(i)
            with torch.no_grad():
                out = self._step(grp, max_spots=max_spots, **kw)
            profiling.bump("ledger/step_dispatches")
            return fetch([out[k] for k in keys]), grp, lows[i]

        def resolve(item):
            pending, grp, lo = item
            with profiling.span("api/fetch_wait"):
                arrays = wait(pending)
            count_fetched(arrays)
            return dict(zip(keys, arrays)), grp, lo

        n_ahead = 2 if dispatch == "window" else len(lows)
        with self._stage("api/run_stack"):
            for i in range(min(n_ahead, len(lows))):
                uploader.upload(i)
        parts = [] if key is not None else None
        pending = None
        for i in range(len(lows) + 1):
            with self._stage("api/run_stack"):
                current = step(i) if i < len(lows) else None
                if i + n_ahead < len(lows):
                    uploader.upload(i + n_ahead)
                ready = resolve(pending) if pending is not None else None
            if ready is not None:
                if parts is not None:
                    parts.append(ready[0])
                yield ready
            pending = current
        if key is not None:
            self.store.save(key, {k: np.concatenate([p[k] for p in parts])
                                  for k in keys},
                            meta={"stage": "run_stack"})

    @_traced
    def run_zstack(self, stack, box_size=10, filter_size=10,
                   max_candidates=None, return_background=False,
                   psfs=False, stack_key=None, lean=False,
                   max_spots=None):
        """Background estimation + batched PSF fits over a z/time stack
        (one field observed over a z or time axis).

        Per-frame SExtractor mesh backgrounds (ops.background) are
        estimated and subtracted on the device, then every frame's spots
        are detected and PSF-fitted (models.detect.detect_and_fit_batch).
        Frames go up in groups of ``GROUP_FRAMES`` from pinned memory on a
        side stream, so that a group's upload runs beside the previous
        group's work, and each group's results copy back without waiting;
        nothing passes through the host between the raw frames and the
        fitted buckets. A stack already on the device runs as one group.
        On a device list or a ``Mesh`` with more than one data device the
        groups of ``GROUP_FRAMES`` frames (a stack already on the device
        too) are dealt to the data devices in turn, each uploaded to its
        device on that device's side stream; every group runs the
        background, detection, fit and fetch of a one-device group on its
        own frames, so the result is the one-device result for frames from
        the host, and the results join in frame order.

        ``stack``: [T, H, W] numpy array or tensor in any camera dtype
        (integer frames upload raw and are cast on the device).

        ``max_candidates``: None = config.detect's bucket (a warning on
        overflow); an integer sets the bucket; the string "exhaustive"
        fits every above-threshold candidate of every frame through the
        chunked path (models.detect.detect_and_fit_exhaustive), one
        group at a time, while the next group's upload and background are
        already enqueued.

        ``lean``: keep-first compacted fetch (integer bucket only). Every
        candidate is still detected and fitted, but only ``max_spots``
        slots per frame (default 2048) come back, kept fits first
        (models.detect.pack_spot_buckets). Returned arrays are then
        [T, max_spots] spot-major, with an extra ``spot_count`` [T] (exact
        keep totals; a value above max_spots means kept fits were cut,
        and a warning fires).

        Returns a dict of host numpy arrays, the SpotFindResult schema
        batched over frames: cand_h/cand_w [T, K] int32, params [T, K, 7],
        center_h/center_w/rmse/r2/s_n [T, K], keep/cand_valid [T, K] bool,
        cand_count [T] int32; plus "background" [T, H, W] float32 with
        ``return_background`` and "psfs" (per-frame reference-contract
        psfs dicts built on the host from the background-subtracted
        frames) with ``psfs``. The artifact store caches the array outputs
        only (``psfs=True`` always computes).
        """
        from .models.detect import (SpotFindResult, detect_and_fit_batch,
                                    detect_and_fit_exhaustive,
                                    pack_spot_buckets, psfs_dicts_from_batch,
                                    unpack_spot_buckets,
                                    warn_candidate_overflow)
        from .ops.background import stack_background, widen

        # A tensor the caller placed on the device runs whole; host frames
        # (arrays, and tensors elsewhere) go up in groups.
        resident = (isinstance(stack, torch.Tensor) and
                    stack.device == self.device)
        stack = _normalize_stack(stack)
        if stack.ndim != 3 or stack.shape[0] == 0:
            raise ValueError("stack must be a non-empty [frames, H, W] "
                             f"array (got shape {tuple(stack.shape)})")
        det = self.config.detect
        if psfs and det.consolidation_radius < 2:
            # Before any device work: the psfs-dict build has
            # find_peptides_batch's key-uniqueness precondition.
            raise ValueError("consolidation_radius must be at least 2")
        exhaustive = max_candidates == "exhaustive"
        mc = (det.max_candidates if (max_candidates is None or exhaustive)
              else max_candidates)
        if lean and (exhaustive or psfs):
            # The lean pack compacts a fixed bucket; the exhaustive path
            # has its own chunked fetch, and the psfs build needs the full
            # per-candidate schema.
            raise ValueError("lean=True requires an integer "
                             "max_candidates bucket and psfs=False")
        n_spots_bucket = int(max_spots) if max_spots is not None else 2048
        key = None
        if self.store is not None and not psfs:
            from .utils.checkpoint import content_key
            if stack_key is None:
                stack_key = content_key(stack.cpu().numpy())
            key = content_key("run_zstack", stack_key, self.config.asdict(),
                              box_size, filter_size,
                              "exhaustive" if exhaustive else mc,
                              return_background,
                              *((("lean", n_spots_bucket),) if lean
                                else ()))
            if self.store.exists(key):
                return self.store.load(key)
        T = stack.shape[0]
        devs = data_devices(self._ops_device)
        g = T if resident and len(devs) == 1 else GROUP_FRAMES
        # The groups (lo, hi, device) in frame order, dealt to the data
        # devices in turn; a round holds one group a device.
        pieces = [(lo, min(lo + g, T), devs[i % len(devs)])
                  for i, lo in enumerate(range(0, T, g))]
        rounds = [range(i, min(i + len(devs), len(pieces)))
                  for i in range(0, len(pieces), len(devs))]
        detect_kw = dict(
            median_filter_size=det.median_filter_size, c_std=float(det.c_std),
            r_2_threshold=float(det.r_2_threshold),
            consolidation_radius=float(det.consolidation_radius),
            num_iters=det.num_iters, theta_starts=det.theta_starts)
        coord_dt = (torch.int16 if max(stack.shape[1:]) <= 32767
                    else torch.int32)

        def collect(item):
            names, pending = item
            with profiling.span("api/fetch_wait"):
                arrays = wait(pending)
            count_fetched(arrays)
            return dict(zip(names, arrays))

        def dispatch_piece(i):
            """Piece i's background and subtraction, then (unless
            exhaustive) detect + fit on its device; starts the copies of
            its outputs to the host. Returns ((names, pending fetch),
            subtracted frames or None)."""
            grp = uploader.take(i)
            profiling.bump("ledger/step_dispatches")
            with torch.no_grad():
                with profiling.span("api/zstack/background",
                                    device=grp.device):
                    background = stack_background(
                        grp, box_size=box_size, filter_size=filter_size)
                    subtracted = widen(grp) - background
                extra = {}
                if return_background:
                    extra["background"] = background
                if psfs:
                    extra["subtracted"] = subtracted
                if exhaustive:
                    return (list(extra),
                            fetch(list(extra.values()))), subtracted
                res = detect_and_fit_batch(subtracted, max_candidates=mc,
                                           **detect_kw)
                if lean:
                    outs = dict(zip(
                        ("_lean_f32", "_lean_ints", "_lean_flags",
                         "_lean_spot_count", "_lean_cand_count"),
                        pack_spot_buckets(res, n_spots_bucket,
                                          coord_dtype=coord_dt)))
                else:
                    outs = dict(res._asdict())
                outs.update(extra)
            return (list(outs), fetch(list(outs.values()))), None

        with self._stage("api/run_zstack"):
            uploader = Uploader(stack, pieces, from_host=not resident)
            if exhaustive:
                # One-ahead window: round k+1's uploads and backgrounds are
                # enqueued before the chunked path (which waits for the
                # candidate counts) runs on round k, so about two rounds
                # of frames are resident, not the whole subtracted stack.
                for i in rounds[0]:
                    uploader.upload(i)
                cur = [dispatch_piece(i) for i in rounds[0]]
                parts = []
                for ri in range(len(rounds)):
                    items = cur
                    if ri + 1 < len(rounds):
                        for i in rounds[ri + 1]:
                            uploader.upload(i)
                        cur = [dispatch_piece(i) for i in rounds[ri + 1]]
                    for item, sub in items:
                        res = detect_and_fit_exhaustive(sub, **detect_kw)
                        parts.append((res, collect(item)))
                # Per-group candidate widths differ (K = chunks * chunk):
                # pad to the widest; pad entries are invalid and unkept,
                # like the chunked loop's own padding.
                k_max = max(r.cand_h.shape[1] for r, _ in parts)

                def pad_k(a, fill):
                    pad = k_max - a.shape[1]
                    if pad == 0:
                        return a
                    width = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
                    return np.pad(a, width, constant_values=fill)

                fills = {"cand_h": 2, "cand_w": 2, "keep": False,
                         "cand_valid": False}
                out = {}
                for name in SpotFindResult._fields:
                    if name == "cand_count":
                        out[name] = np.concatenate(
                            [r.cand_count for r, _ in parts])
                        continue
                    out[name] = np.concatenate(
                        [pad_k(getattr(r, name), fills.get(name, 0))
                         for r, _ in parts])
                for name in parts[0][1]:
                    out[name] = np.concatenate(
                        [extra[name] for _, extra in parts])
            else:
                for i in range(len(pieces)):
                    uploader.upload(i)
                pending = [dispatch_piece(i)[0] for i in range(len(pieces))]
                fetched = [collect(item) for item in pending]
                out = {k: np.concatenate([f[k] for f in fetched])
                       for k in fetched[0]}
                if lean:
                    packed = [out.pop(k) for k in (
                        "_lean_f32", "_lean_ints", "_lean_flags",
                        "_lean_spot_count", "_lean_cand_count")]
                    out = dict(unpack_spot_buckets(*packed), **out)
        _count_detected(out["cand_count"], None if exhaustive else mc)
        if not exhaustive:
            warn_candidate_overflow(out["cand_count"], mc, "run_zstack")
            if lean and (out["spot_count"] > n_spots_bucket).any():
                worst = int(out["spot_count"].max())
                warnings.warn(
                    f"run_zstack(lean=True): {worst} kept fits exceed "
                    f"max_spots={n_spots_bucket}; kept fits beyond the "
                    "first max_spots (in candidate order, not by quality) "
                    "were dropped from the fetch. Re-run with a larger "
                    "max_spots (or lean=False) for full coverage.",
                    stacklevel=2)
        if psfs:
            sub = out.pop("subtracted")
            out["psfs"] = psfs_dicts_from_batch(
                sub, out["keep"], out["params"], out["center_h"],
                out["center_w"], out["rmse"], out["r2"], out["s_n"],
                out["cand_h"], out["cand_w"], det.consolidation_radius)
        if key is not None:
            self.store.save(key, out, meta={"stage": "run_zstack"})
        return out

    @_traced
    def run_experiment(self, stacks, csv_path=None, max_candidates=None,
                       max_spots=None, candidate_radius=2,
                       category_csv_path=None, category_csv_filtered=True,
                       category_csv_collate_fields=False, mdma=False,
                       adjustment_function=None, save_averages=False,
                       keep_invalid=False, remainder_threshold=None,
                       remainder_channels=None, dispatch="eager"):
        """The full experiment, one call: align + detect/fit + track +
        interpolate + categorise + track-photometries CSV.

        The surface of the JAX package's ``Pipeline.run_experiment`` (see
        its docstring for every argument's reference semantics), without
        the detect step cached in the artifact store when one is set;
        ``config.photometry.method`` may be mexican_hat, simple, maximum,
        gaussian_volume, sigmas or sextractor (measured on the host on
        background-subtracted frames, with the config's aperture_radius,
        box_size and filter_size; the device bucket then carries sigmas).

        Arguments:
            stacks: a [F, C, H, W] array (channel 'ch1') or a dict
                {channel: [F, C, H, W] array}; numpy or tensor, integer
                camera dtypes stay integer up to the device.
            csv_path: write the CHANNEL,FIELD,H,W,CATEGORY,FRAME i... CSV.
            category_csv_path: write the Pattern[,Field],Channel,Count CSV
                (filtered to one-drop monotone patterns when
                ``category_csv_filtered``; per field when
                ``category_csv_collate_fields``).
            mdma: apply the multiplicative-delta-median adjustments, per
                field from its all-frames-ON traces: I * (1 - Af).
            adjustment_function: fn(photometry=, frame=, adjustments=)
                applied to every row value in place of the built-in mdma.
            save_averages: one AVERAGE_INTENSITY column, the mean over the
                detected frames only (no hole gathers).
            keep_invalid: every trace emits a row; out-of-box holes are
                None ('0' in the CSV), clipped edge windows are measured on
                the host with the reference's clipped-slice semantics.
            remainder_threshold, remainder_channels: QC-mask fields whose
                remainder count falls below the threshold in any of the
                channels; their rows are dropped.
            dispatch: "eager" (every group's upload enqueued up front) or
                "window" (two groups ahead); the rows are the same.

        Fields run in groups of ``GROUP_FIELDS``. The step runs on the
        calling thread, group after group; the host
        half of each group (spot lists, linking, fill-in, row assembly and
        the enqueueing of its hole gathers) runs on one worker thread, so
        that group k is tracked while group k+1's step runs. Rows are
        assembled in group order, the order a serial run gives. With
        ``profile``, host-clock stages: "api/run_stack" (the calling
        thread's step loop: uploads, steps, fetches),
        "api/run_experiment/track+photometry" (the worker's host half, per
        group), "api/run_experiment/groups" (the span of both, so the
        overlap is run_stack + track+photometry - groups),
        "api/run_experiment/track_wait" (the calling thread's wait on the
        worker after the last step), then
        "api/run_experiment/hole_flush", "api/run_experiment/rows" (row
        post-processing and categories) and "api/run_experiment/csv".
        Inside track+photometry: "api/track/spot_lists" a group and
        ``run_experiment_stack``'s spans and counters (its docstring).
        And the counter "experiment/csv_rows_native", the track-CSV rows the
        native writer wrote (``fast_experiment.write_track_fields_csv``
        where the rows are still ``_rows_by_field``'s, else
        ``write_track_rows_csv``).

        Returns a dict: rows [(channel, field, h, w, category,
        photometries)], category_counts and filtered_category_counts
        ({channel: {field: {category: count}}}), offsets ({channel:
        (off_h [F, C], off_w [F, C])}), summary ({channel: {spot_count,
        trace_count, singleton_count}}), remainder_counts, mdma_adjustments
        (or None), invalid_fields_mask (or None), csv_path and
        category_csv_path.
        """
        from .pipeline.experiment import write_category_counts_csv
        from .pipeline.fast_experiment import (
            _spot_lists, check_photometry_method, filter_monotone_categories,
            flush_hole_queue, run_experiment_stack, write_track_fields_csv,
            write_track_rows_csv)

        phot = self.config.photometry
        check_photometry_method(phot.method)
        if not isinstance(stacks, dict):
            stacks = {"ch1": stacks}
        stacks = {ch: _normalize_stack(s) for ch, s in stacks.items()}
        for ch, s in stacks.items():
            if s.ndim != 4 or s.shape[0] == 0:
                raise ValueError(
                    f"channel {ch!r}: stack must be a non-empty "
                    f"[fields, cycles, H, W] array (got shape "
                    f"{tuple(s.shape)})")
        cycle_counts = {s.shape[1] for s in stacks.values()}
        if len(cycle_counts) != 1:
            raise ValueError("every channel must have the same cycle "
                             f"count (got {sorted(cycle_counts)})")
        n_cycles = cycle_counts.pop()
        if remainder_threshold is not None:
            field_counts = {s.shape[0] for s in stacks.values()}
            if len(field_counts) != 1:
                raise ValueError(
                    "remainder_threshold needs one field count across "
                    f"channels (got {sorted(field_counts)})")
        mc_eff = (max_candidates if max_candidates is not None
                  else self.config.detect.max_candidates)
        rows = []
        # (channel, field, FieldArrays) behind the rows while every field's
        # rows are still those _rows_by_field made; the track CSV is then
        # written from them, with no pass over the rows.
        csv_fields = []
        category_counts = {}
        offsets_out = {}
        summary = {}
        remainder_counts = {}
        mdma_adjustments = {}
        # sextractor measures on the host: it is handed the host stack
        # and the device photometry bucket is not fetched.
        host_phot = phot.method == "sextractor"
        keys = tuple(k for k in EXPERIMENT_KEYS
                     if not (host_phot and k == "photometry"))
        for channel, stack in stacks.items():
            F, C = stack.shape[:2]
            stack_key = None
            if self.store is not None:
                from .utils.checkpoint import content_key
                stack_key = content_key(stack.cpu().numpy())
            # Hole gathers are enqueued per group and resolved once after
            # the last group; save_averages never reads hole values and
            # sextractor measures every position on the host.
            hole_queue = None if (save_averages or host_phot) else []

            def track(out_grp, dev_grp, lo, stack=stack, C=C,
                      hole_queue=hole_queue):
                field_arrays = []
                with self._stage("api/run_experiment/track+photometry"):
                    Fg = out_grp["offsets_h"].shape[0]
                    with profiling.span("api/track/spot_lists"):
                        rhs, rws, values = _spot_lists(out_grp, Fg, C)
                    if host_phot:
                        measured = stack[lo:lo + Fg]
                    elif dev_grp is None:   # served from the store
                        measured = stack[lo:lo + Fg].to(self.device)
                    else:
                        measured = dev_grp
                    per_field = run_experiment_stack(
                        measured, out_grp["offsets_h"], out_grp["offsets_w"],
                        (rhs, rws), values, photometry_method=phot.method,
                        photometry_radius=phot.radius,
                        photometry_brim=phot.brim_size,
                        candidate_radius=candidate_radius,
                        aperture_radius=phot.aperture_radius,
                        box_size=phot.box_size,
                        filter_size=phot.filter_size,
                        hole_queue=hole_queue,
                        skip_hole_gathers=save_averages,
                        keep_invalid=keep_invalid,
                        host_images=(stack[lo:lo + Fg]
                                     if keep_invalid and not host_phot
                                     else None),
                        field_arrays=field_arrays)
                n_spots = sum(len(rh) for per_c in rhs for rh in per_c)
                if len(field_arrays) != len(per_field):   # no trace at all
                    field_arrays = None
                return per_field, out_grp, n_spots, field_arrays

            with self._stage("api/run_experiment/groups"), \
                    concurrent.futures.ThreadPoolExecutor(1) as pool:
                futures = [pool.submit(track, *item) for item in
                           self._stack_step_groups(
                               stack, keys, max_candidates=max_candidates,
                               max_spots=max_spots, stack_key=stack_key,
                               dispatch=dispatch)]
                with profiling.span("api/run_experiment/track_wait"):
                    parts = [f.result() for f in futures]
            per_field = [r for p, _, _, _ in parts for r in p]
            made = list(per_field)   # the row lists _rows_by_field made
            outs = [o for _, o, _, _ in parts]
            spot_count = sum(n for _, _, n, _ in parts)
            n_over = sum(int(o["spot_overflow"].sum()) for o in outs)
            n_cand_over = sum(int((o["cand_count"] > mc_eff).sum())
                              for o in outs)
            for o in outs:
                _count_detected(o["cand_count"], mc_eff)
            if n_over:
                logger.warning(
                    "run_experiment: %d (field, cycle) images overflowed "
                    "the max_spots bucket; their lowest-R^2 spots were "
                    "dropped; raise max_spots for complete tracking",
                    n_over)
            if n_cand_over:
                logger.warning(
                    "run_experiment: %d (field, cycle) images found more "
                    "than max_candidates=%d peaks; the weakest-"
                    "correlation candidates were dropped; raise "
                    "max_candidates for exhaustive coverage", n_cand_over,
                    mc_eff)
            offsets_out[channel] = (
                np.concatenate([o["offsets_h"] for o in outs]),
                np.concatenate([o["offsets_w"] for o in outs]))
            # Every (channel, field) entry exists, so zero-trace fields
            # still emit count-0 rows in the collated category CSV.
            for f in range(F):
                category_counts.setdefault(channel, {}).setdefault(f, {})
            if hole_queue:
                with self._stage("api/run_experiment/hole_flush"):
                    flush_hole_queue(hole_queue)
            with self._stage("api/run_experiment/rows"):
                if keep_invalid:
                    # NaN markers are the reference's None Spots; H/W go
                    # None when frame 0 is such a Spot (photometry[0][:2]).
                    for f, field_rows in enumerate(per_field):
                        new_rows = []
                        for (cat, h0, w0, ph) in field_rows:
                            vals = tuple(None if np.isnan(v) else float(v)
                                         for v in ph)
                            if vals[0] is None and not cat[0]:
                                h0 = w0 = None
                            new_rows.append((cat, h0, w0, vals))
                        per_field[f] = new_rows
                remainder_counts[channel] = [
                    sum(1 for (cat, _, _, _) in field_rows if all(cat))
                    for field_rows in per_field]
                if mdma or adjustment_function is not None:
                    adjs = {}
                    for f, field_rows in enumerate(per_field):
                        adjustments = None
                        if mdma:
                            rem = [ph for (cat, _, _, ph) in field_rows
                                   if all(cat)]
                            if rem:
                                # Per remainder (I_f - median(I)) / median,
                                # then the per-frame median of those.
                                rr = np.stack([(np.asarray(ph, np.float64)
                                                - np.median(ph))
                                               / np.median(ph)
                                               for ph in rem])
                                af = np.median(rr, axis=0)
                            else:
                                af = np.zeros(n_cycles)
                            adjs[f] = tuple(float(a) for a in af)
                            adjustments = {"mdma": adjs[f]}
                        if adjustment_function is not None:
                            # The hook is the only application; on the
                            # save_averages surface absent frames feed
                            # photometry=None.
                            per_field[f] = [
                                (cat, h0, w0,
                                 tuple(adjustment_function(
                                     photometry=(ph_i if (not save_averages
                                                          or cat[i])
                                                 else None), frame=i,
                                     adjustments=adjustments)
                                     for i, ph_i in enumerate(ph)))
                                for (cat, h0, w0, ph) in field_rows]
                        elif save_averages:
                            per_field[f] = [
                                (cat, h0, w0,
                                 tuple(float(ph[i]) * (1.0 - af[i])
                                       if cat[i] else None
                                       for i in range(n_cycles)))
                                for (cat, h0, w0, ph) in field_rows]
                        elif keep_invalid:
                            per_field[f] = [
                                (cat, h0, w0,
                                 tuple(v * (1.0 - af[i]) if v is not None
                                       else None
                                       for i, v in enumerate(ph)))
                                for (cat, h0, w0, ph) in field_rows]
                        else:
                            per_field[f] = [
                                (cat, h0, w0, np.asarray(ph, np.float64)
                                 * (1.0 - af))
                                for (cat, h0, w0, ph) in field_rows]
                    if mdma:
                        mdma_adjustments[channel] = adjs
                elif save_averages:
                    # Absent frames become None so the mean skips them.
                    for f, field_rows in enumerate(per_field):
                        per_field[f] = [
                            (cat, h0, w0,
                             tuple(float(ph[i]) if cat[i] else None
                                   for i in range(n_cycles)))
                            for (cat, h0, w0, ph) in field_rows]
                n_traces = n_singletons = 0
                for f, field_rows in enumerate(per_field):
                    for (cat, h0, w0, ph) in field_rows:
                        if save_averages:
                            vals = [v for v in ph if v is not None]
                            mean = (float(np.mean(vals)) if vals
                                    else float("nan"))
                            # H/W from frame 0 whether or not the trace is
                            # detected there (the reference's quirk).
                            if not cat[0]:
                                h0 = w0 = None
                            ph = mean
                        rows.append((channel, f, h0, w0, cat, ph))
                        counts = category_counts[channel][f]
                        counts[cat] = counts.get(cat, 0) + 1
                        n_traces += 1
                        n_singletons += sum(cat) == 1
                summary[channel] = {
                    "spot_count": int(spot_count),
                    "trace_count": n_traces,
                    "singleton_count": n_singletons,
                }
                # Every surface that changes rows replaces a field's list
                # (save_averages changes them in the loop above as well).
                groups = [g for _, _, _, g in parts]
                if csv_fields is not None and not save_averages and \
                        None not in groups and \
                        all(a is b for a, b in zip(per_field, made)):
                    csv_fields += [(channel, f, a) for f, a in enumerate(
                        a for g in groups for a in g)]
                else:
                    csv_fields = None
        invalid_fields_mask = None
        if remainder_threshold is not None:
            n_fields = len(next(iter(remainder_counts.values())))
            if remainder_channels is None:
                chans = list(remainder_counts)
            else:
                missing = [c for c in remainder_channels
                           if c not in remainder_counts]
                if missing:
                    raise ValueError(
                        "remainder_channels %r not in experiment channels %r"
                        % (missing, sorted(remainder_counts)))
                chans = [c for c in remainder_counts
                         if c in remainder_channels]
            invalid_fields_mask = [
                not any(remainder_counts[c][f] < remainder_threshold
                        for c in chans)
                for f in range(n_fields)]
            rows = [r for r in rows if invalid_fields_mask[r[1]]]
            if csv_fields is not None:
                csv_fields = [c for c in csv_fields
                              if invalid_fields_mask[c[1]]]
        filtered = filter_monotone_categories(category_counts)
        with self._stage("api/run_experiment/csv"):
            if csv_path is not None and csv_fields is not None:
                write_track_fields_csv(csv_fields, n_cycles, csv_path)
            elif csv_path is not None:
                write_track_rows_csv(rows, n_cycles, csv_path,
                                     save_averages=save_averages)
            if category_csv_path is not None:
                write_category_counts_csv(
                    filtered if category_csv_filtered else category_counts,
                    category_csv_path,
                    collate_fields=category_csv_collate_fields)
        return {"rows": rows, "category_counts": category_counts,
                "filtered_category_counts": filtered,
                "offsets": offsets_out, "summary": summary,
                "remainder_counts": remainder_counts,
                "mdma_adjustments": mdma_adjustments if mdma else None,
                "invalid_fields_mask": invalid_fields_mask,
                "csv_path": csv_path,
                "category_csv_path": category_csv_path}

    @_traced
    def run_experiment_files(self, peptide_files, second_channel_files=None,
                             **kw):
        """``run_experiment`` from image files, as the ``run-experiment``
        subcommand runs it: each channel's files sorted by directory =
        cycle, file name = field and read into its [F, C, H, W] stack
        (``pipeline/files.py::load_stack``, with its spans and counters),
        channel 'ch1' from ``peptide_files`` and 'ch2' from
        ``second_channel_files`` when given. Raises
        ``pipeline.files.FileLayoutError`` for uneven cycle directories
        or channels of different cycle counts. ``kw`` goes to
        ``run_experiment``, whose dict is returned unchanged. On a CUDA
        device each stack is read into pinned host memory, which the
        upload reads as it is."""
        from .pipeline.files import FileLayoutError, load_stack

        # The stacks are held until run_experiment returns, so that no
        # later load reuses a pinned block while an upload still reads it.
        stack, n_cycles = load_stack(peptide_files, self.device)
        stacks = {"ch1": stack}
        if second_channel_files:
            stack2, n_cycles2 = load_stack(second_channel_files,
                                           self.device)
            if n_cycles2 != n_cycles:
                raise FileLayoutError(
                    "second channel must have the same cycle count")
            stacks["ch2"] = stack2
        return self.run_experiment(stacks, **kw)

    @_traced
    def run_timetrace(self, movie, csv_path=None, search_radius=3,
                      s_n_cutoff=3.0, max_candidates=None,
                      photometry_min="config", mirror_start=None,
                      chung_kennedy=None, p_threshold=None,
                      include_step_fits=True, include_intermediates=True):
        """The movie workflow, one call: first-frame detect -> batched
        luminosity-centroid tracking (the whole movie enqueued on the
        device without a host read) -> per-trace photometry -> batched step
        fitting -> the timetrace CSV.

        Semantics are basic_timetrace_script's (initial spots from the
        device detector's psfs with their centers; LC tracking per
        flexlibrary.py:1172-1317; Trace.photometries zeros for None
        frames; the mirror -> Chung-Kennedy -> sliding-t -> refit ->
        t-merge chain per flexlibrary.py:3642-3713); the CSV is the
        classes' TimetraceExperiment.save_experiment_as_csv byte for byte,
        written from the step fitter's arrays by the native writer
        (native/timetrace_csv.py).

        Arguments:
            movie: [T, H, W] array or tensor, one continuously-filmed
                field. Raw camera dtypes upload as they are (from pinned
                memory on a CUDA device) and are cast to float32 there; a
                tensor already on the device is used where it lies.
            max_candidates: None (default) defers to
                config.detect.single_field_cap, itself None by default,
                meaning exhaustive detection: the chunked path fits
                every above-threshold candidate (the reference's uncapped
                semantics). An integer (per call or in the config) caps a
                single bucket with a truncation warning on overflow.
            csv_path: if given, write the Trace#/Hcoord/Wcoord/Frame#/
                Photometry [...] CSV there (include_step_fits and
                include_intermediates add the reference's step-fit and
                intermediate columns).
            search_radius, s_n_cutoff: LC tracking parameters
                (flexlibrary lc_create_traces defaults).
            mirror_start, chung_kennedy, p_threshold: step-fit chain
                parameters; None means config.stepfit's values.
            photometry_min: floor applied to the per-frame photometries
                before step fitting (flexlibrary stepfit_tracks'
                photometry_min); defaults to
                config.photometry.photometry_min, pass None to disable
                flooring regardless of config.

        On a device list or a ``Mesh`` of more than one data device, the
        first frame's detection stays on ``self.device``; the tracks are
        split over the data devices (``lc_track``), their photometry runs
        on ``self.device`` (the two-step path, as in the JAX Pipeline) and
        the step fits split their traces over the data devices.

        With ``profile``, host-clock stages: "api/run_timetrace/upload",
        ".../detect", ".../track+photometry" (window metrics; ".../track"
        and ".../photometry" for the others), ".../stepfit",
        ".../assemble" (the result objects) and ".../csv"; the spans
        "api/timetrace/track", "api/stepfit/ck_masks" (device time on a
        CUDA device) and "api/stepfit/postpass"; and, once a call, the
        counters "timetrace/frames" and "timetrace/traces" (the frames and
        the tracks started on frame 0) and, with ``csv_path``,
        "timetrace/csv_rows" (the rows the native writer wrote), bumped
        while tracing is on only.

        Returns a dict: traces {h, w, present, rec_h, rec_w},
        photometries (N, T), step_fits, step_fit_intermediates,
        trace_count, csv_path.
        """
        from .models.detect import find_peptide_centers
        from .ops.background import widen
        from .ops.stepfit_batch import stepfit_arrays, stepfit_lists
        from .pipeline.fast_timetrace import (lc_track,
                                              lc_track_and_photometry,
                                              timetrace_photometries)
        from .pipeline.traces import PhotometryTrace, PlateauTrace

        sf = self.config.stepfit
        phot = self.config.photometry
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
        with self._stage("api/run_timetrace/upload"), torch.no_grad():
            # One upload of the raw frames (half the bytes of float32 for
            # uint16), widened on the device.
            movie_dev = widen(Uploader(movie, [(0, T, self.device)]).take(0))
        with self._stage("api/run_timetrace/detect"):
            det = self.config.detect
            # The arrays path: the psfs-dict key semantics without the
            # sub- and fit-image materialisation.
            h0, w0, fits, _count = find_peptide_centers(
                movie_dev[0],
                median_filter_size=det.median_filter_size, c_std=det.c_std,
                r_2_threshold=det.r_2_threshold,
                consolidation_radius=det.consolidation_radius,
                max_candidates=(max_candidates if max_candidates is not None
                                else det.single_field_cap),
                num_iters=det.num_iters, device=None)
        if profiling.enabled():
            profiling.bump("timetrace/frames", T)
            profiling.bump("timetrace/traces", len(h0))
        if len(h0) == 0:
            if csv_path is not None:
                # The class path still writes a header-only CSV for an
                # empty experiment; a promised file must exist. The
                # intermediate columns are keyed off the first trace's
                # dict (flexlibrary.py:3544): with no trace there are none.
                with self._stage("api/run_timetrace/csv"):
                    self._timetrace_csv(
                        csv_path, h0, w0, stepfit_arrays(np.zeros((0, T))),
                        include_step_fits, None)
            return {"traces": {"h": [], "w": [], "present": None,
                               "rec_h": None, "rec_w": None},
                    "photometries": np.zeros((0, T)),
                    "step_fits": {}, "step_fit_intermediates": {},
                    "trace_count": 0, "csv_path": csv_path}
        n_track_shards = (self.mesh.shape["data"] if self.mesh is not None
                          else 1)
        if phot.method in ("mexican_hat", "simple", "maximum") and \
                n_track_shards == 1:
            # Fused: the tracked positions stay on the device and feed the
            # window gathers (values equal the two-step path's). Tracks
            # sharded over several devices take the two-step path, as in
            # the JAX Pipeline.
            with self._stage("api/run_timetrace/track+photometry"):
                rec_h, rec_w, present, photometries = \
                    lc_track_and_photometry(
                        movie_dev, h0, w0, phot.method,
                        search_radius=search_radius,
                        s_n_cutoff=s_n_cutoff,
                        photometry_radius=phot.radius,
                        photometry_brim=phot.brim_size,
                        photometry_min=photometry_min)
        else:
            with self._stage("api/run_timetrace/track"):
                rec_h, rec_w, present = lc_track(
                    movie_dev, h0, w0, search_radius=search_radius,
                    s_n_cutoff=s_n_cutoff,
                    device=self.mesh if n_track_shards > 1 else None)
            with self._stage("api/run_timetrace/photometry"):
                photometries = timetrace_photometries(
                    movie_dev, rec_h, rec_w, present, phot.method,
                    initial_fits=fits, photometry_radius=phot.radius,
                    photometry_brim=phot.brim_size,
                    photometry_min=photometry_min,
                    aperture_radius=phot.aperture_radius,
                    box_size=phot.box_size, filter_size=phot.filter_size)
        with self._stage("api/run_timetrace/stepfit"):
            fit_arrays = stepfit_arrays(photometries,
                                        mirror_start=mirror_start,
                                        chung_kennedy=chung_kennedy,
                                        p_threshold=p_threshold,
                                        window_radius=sf.window_radius,
                                        device=self._ops_device)
            results = stepfit_lists(fit_arrays)
        with self._stage("api/run_timetrace/assemble"):
            step_fits = {}
            intermediates = {}
            for (hh, ww), (phots, ck, plateaus, t_filtered) in zip(
                    zip(h0, w0), results):
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
        if csv_path is not None:
            with self._stage("api/run_timetrace/csv"):
                self._timetrace_csv(csv_path, h0, w0, fit_arrays,
                                    include_step_fits, include_intermediates)
        return {"traces": {"h": h0, "w": w0, "present": present,
                           "rec_h": rec_h, "rec_w": rec_w},
                "photometries": photometries, "step_fits": step_fits,
                "step_fit_intermediates": intermediates,
                "trace_count": len(results), "csv_path": csv_path}

    @staticmethod
    def _timetrace_csv(csv_path, h0, w0, fit_arrays, include_step_fits,
                       include_intermediates):
        """run_timetrace's CSV by the native writer: the rows
        TimetraceExperiment.save_experiment_as_csv writes for the same
        fits (native/timetrace_csv.py). While tracing is on, the counter
        "timetrace/csv_rows" counts the rows it wrote."""
        from .native import timetrace_csv
        rows = timetrace_csv.write(
            csv_path, h0, w0, fit_arrays,
            include_step_fits=include_step_fits,
            include_intermediates=include_intermediates)
        if profiling.enabled():
            profiling.bump("timetrace/csv_rows", rows - 1)

    @_traced
    def run_timetraces(self, movies, csv_paths=None, prefetch=None,
                       **kwargs):
        """Batch movie front door: run_timetrace over a sequence of movies
        (one TIRF run films many fields).

        ``prefetch``: upload movie k+1 (raw camera dtype, from pinned
        memory on a side stream) while movie k computes. None (default)
        means one movie ahead on a CUDA device and no prefetch on the CPU.
        The movies go to ``self.device``; on a device list each runs
        through ``run_timetrace`` over the list.

        Arguments:
            movies: iterable of [T, H, W] arrays (dtypes may differ).
            csv_paths: optional list, one output CSV path per movie.
            kwargs: forwarded to run_timetrace.

        Returns a list of run_timetrace result dicts, in order.
        """
        if "csv_path" in kwargs:
            raise TypeError(
                "run_timetraces takes csv_paths (one per movie), "
                "not csv_path")
        movies = [_normalize_stack(m) for m in movies]
        if csv_paths is not None and len(csv_paths) != len(movies):
            raise ValueError("csv_paths must have one entry per movie")
        if prefetch is None:
            prefetch = self.device.type == "cuda"

        def start_upload(m):
            if m.ndim != 3:
                raise ValueError("movie must be [frames, H, W]")
            up = Uploader(m, [(0, m.shape[0], self.device)])
            up.upload(0)
            return up

        outs = []
        ahead = start_upload(movies[0]) if prefetch and movies else None
        for i, movie in enumerate(movies):
            cur = ahead.take(0) if ahead is not None else movie
            if prefetch:
                ahead = (start_upload(movies[i + 1])
                         if i + 1 < len(movies) else None)
            outs.append(self.run_timetrace(
                cur, csv_path=None if csv_paths is None else csv_paths[i],
                **kwargs))
        return outs

    @_traced
    def run_files(self, paths_by_cycle, **kwargs):
        """Like run_stack, from image files: paths_by_cycle is a list (per
        cycle) of lists (per field) of image paths."""
        from .utils.imageio import read_image_array
        cycles = [[read_image_array(p) for p in cycle]
                  for cycle in paths_by_cycle]
        n_fields = {len(c) for c in cycles}
        if len(n_fields) != 1:
            raise ValueError("every cycle must have the same field count")
        stack = np.stack([np.stack(c) for c in cycles], axis=1)
        return self.run_stack(stack, **kwargs)

    # -- traces --------------------------------------------------------------

    @_traced
    def stepfit(self, photometries):
        """Batched step fitting over an (N, T) photometry array with
        config.stepfit's parameters.

        Returns a list of N (photometries, ck_filtered, plateaus,
        t_filtered_plateaus) tuples (ops.stepfit_batch.stepfit_batched).
        """
        from .ops.stepfit_batch import stepfit_batched
        sf = self.config.stepfit
        with self._stage("api/stepfit"):
            return stepfit_batched(np.asarray(photometries, np.float64),
                                   mirror_start=sf.mirror_start,
                                   chung_kennedy=sf.chung_kennedy,
                                   p_threshold=sf.p_threshold,
                                   window_radius=sf.window_radius,
                                   device=self._ops_device)

    @_traced
    def chi_squared_stepfit(self, photometries, num_steps_multiplier=1,
                            num_steps=None, min_step_length=2,
                            min_step_magnitude=0.0,
                            ignore_counterfits=False):
        """Batched Kerssemakers chi-squared step fitting over an (N, T)
        photometry array (the reference's alternative step-fit method,
        stepfitting_library.py:342-505). Returns a list of N step fits
        (plateau-triple lists), bit-equal per trace to
        stepfitting.chi_squared_step_fitter. Host work, whatever the
        Pipeline's device: the native core threads the batch
        (stepfitting.chi_squared_fit_batch)."""
        from .stepfitting import chi_squared_fit_batch

        with self._stage("api/chi_squared_stepfit"):
            return chi_squared_fit_batch(
                np.asarray(photometries, np.float64),
                num_steps_multiplier=num_steps_multiplier,
                num_steps=num_steps, min_step_length=min_step_length,
                min_step_magnitude=min_step_magnitude,
                ignore_counterfits=ignore_counterfits)

    # -- inference -----------------------------------------------------------

    @_traced
    def fluor_counts(self, tracks, beta, beta_sigma, quench_factors=None,
                     alpha_adjust=0.0, **kwargs):
        """v8 lognormal fluor counting.

        ``tracks`` is a track-CSV path (dict-free native ingestion) or a
        photometries dict. Returns (signals, total, none_count, fit_info).
        The scoring runs on the pipeline's device, or its traces are split
        over the pipeline's data devices (a ``device=`` keyword names
        another device or device list): the hand-written kernel on a CUDA
        device.
        """
        ln = self.config.lognormal
        if quench_factors is None:
            # config.lognormal.quench_factors when set, else no quenching
            # (the reference's quench_factor=0 default).
            quench_factors = (tuple(ln.quench_factors) or
                              (0.0,) * (ln.max_possible + 2))
        # device= in kwargs scores elsewhere than the pipeline's device.
        device = kwargs.pop("device", self._ops_device)
        with self._stage("api/fluor_counts"):
            if isinstance(tracks, str):
                from .inference.lognormal import lognormal_fit_v8_from_csv
                return lognormal_fit_v8_from_csv(
                    tracks, beta, beta_sigma,
                    max_possible=ln.max_possible,
                    allow_upsteps=ln.allow_upsteps,
                    allow_multidrop=ln.allow_multidrop,
                    max_deviation=(ln.max_deviation
                                   if ln.max_deviation is not None else 3),
                    quench_factors=quench_factors,
                    alpha_adjust=alpha_adjust, device=device, **kwargs)
            from .inference.lognormal import photometries_lognormal_fit_v8
            if kwargs:
                # The remaining kwargs are CSV-reader options
                # (downstep_filtered, head/tail_truncate); silently
                # dropping them against a dict would fit different data
                # than the caller asked for.
                raise TypeError(
                    "fluor_counts with a photometries dict accepts no "
                    "CSV-reader options: " + ", ".join(sorted(kwargs)))
            if alpha_adjust:
                from .inference.photometries import (
                    alpha_adjust_photometries)
                tracks = alpha_adjust_photometries(tracks, alpha_adjust)
            return photometries_lognormal_fit_v8(
                tracks, beta, beta_sigma, max_possible=ln.max_possible,
                allow_upsteps=ln.allow_upsteps,
                allow_multidrop=ln.allow_multidrop,
                max_deviation=(ln.max_deviation
                               if ln.max_deviation is not None else 3),
                quench_factors=quench_factors, device=device)

    @_traced
    def fluor_counts_calibrated(self, tracks, channel="ch1", beta=None,
                                beta_sigma=0.2, truncate=0, ddif=0.0,
                                max_possible=5, allow_multidrop=True,
                                adjustment=True):
        """Auto-calibrated v8 fluor counting: the lognormal_fitter_v2
        flow (lognormal_fitter_v2.py:119-212 in the reference) on the
        batched scorer, on the pipeline's device (or its traces split over
        the pipeline's data devices).

        alpha comes from the first-two-mode histogram separation
        (_get_m0Dm1[7]); beta from the last-drop method v2 on the
        truncated alpha-adjusted photometries; an optional ON/OFF
        re-adjustment pass (grab_ON_OFFS -> ON_OFF_adjust_photometries)
        recalibrates before the final fit. Passing ``beta`` pins it (the
        reference's --beta override). Like the reference, BOTH fits use
        the caller's ``beta_sigma`` (default 0.2) — the last-drop sigma
        estimates are derived but never fed into the fit
        (lognormal_fitter_v2.py:199-212); they are reported in the
        calibration dict as beta_sigma_estimate / original_beta_sigma.

        Returns (signals, total_count, none_count, all_fit_info,
        calibration) where calibration = {alpha, beta, beta_sigma (the
        value the fits used), beta_sigma_estimate, original_beta,
        original_beta_sigma}.
        """
        from collections import defaultdict

        from .inference.calibration import _get_m0Dm1, last_drop_method_v2
        from .inference.lognormal import photometries_lognormal_fit_v8
        from .inference.photometries import (read_track_photometries_csv,
                                             unwind_photometries)
        from . import notebook as jd

        with self._stage("api/fluor_counts_calibrated"):
            if isinstance(tracks, str):
                photometries, _ = read_track_photometries_csv(
                    tracks, head_truncate=0, tail_truncate=0,
                    downstep_filtered=True, channels=[channel])
            else:
                photometries = tracks
            raw = tuple(i for (_, _, _, _, _, ints, _)
                        in unwind_photometries(photometries)
                        for i in ints)
            alpha = _get_m0Dm1(raw_photometries=raw,
                               optimal_bin_number=None)[7]
            alpha_adjusted = defaultdict(dict)
            truncated = defaultdict(dict)
            for (ch, field, h, w, category, ints,
                 row) in unwind_photometries(photometries):
                adj = tuple(i - alpha for i in ints)
                (alpha_adjusted[ch].setdefault(field, {})
                 .setdefault((h, w), (category, adj, row)))
                (truncated[ch].setdefault(field, {})
                 .setdefault((h, w), (category[truncate:], ints[truncate:],
                                      row)))
            original_beta, original_bs = last_drop_method_v2(
                photometries=dict(truncated))
            if beta is not None:
                original_beta = beta
            quench = tuple([0.0] + [ddif] * (max_possible + 1))
            first = photometries_lognormal_fit_v8(
                dict(alpha_adjusted), original_beta, beta_sigma,
                max_possible=max_possible, allow_upsteps=False,
                allow_multidrop=allow_multidrop, max_deviation=3,
                quench_factors=quench, device=self._ops_device)
            on_offs = jd.grab_ON_OFFS(first[3], alpha_adjust=0)
            if adjustment:
                # Unconditional like the reference
                # (lognormal_fitter_v2.py:186-191): with empty ON_OFFS
                # the adjuster's per-cycle dict never matches, so the
                # RAW intensities feed the final beta estimate + fit.
                adj_photometries = jd.ON_OFF_adjust_photometries(
                    photometries=photometries, ON_OFFS=on_offs, alpha=alpha)
            else:
                adj_photometries = dict(alpha_adjusted)
            adj_beta, adj_bs = last_drop_method_v2(
                photometries=adj_photometries)
            if beta is not None:
                adj_beta = beta
            signals, total, none_count, fit_info = \
                photometries_lognormal_fit_v8(
                    adj_photometries, adj_beta, beta_sigma,
                    max_possible=max_possible, allow_upsteps=False,
                    allow_multidrop=allow_multidrop, max_deviation=3,
                    quench_factors=quench, device=self._ops_device)
        # Faithful to lognormal_fitter_v2.py:199-212: BOTH fits use the
        # caller's beta_sigma; last_drop_method_v2's sigma estimates are
        # derived but never fed back. Report the estimate separately so
        # the record is honest about which value the fit actually used.
        calibration = {"alpha": float(alpha), "beta": float(adj_beta),
                       "beta_sigma": float(beta_sigma),
                       "beta_sigma_estimate": float(adj_bs),
                       "original_beta": float(original_beta),
                       "original_beta_sigma": float(original_bs)}
        return signals, total, none_count, fit_info, calibration

    @_traced
    def per_cycle_gmm(self, photometries, min_fluors=1, max_fluors=5,
                      n_init=10, n_iter=100, cycles=None, lower_bound=None,
                      seed=0):
        """BIC-selected per-cycle intensity GMMs, every (cycle,
        component-count, restart) model fitted in ONE launch of kernel E
        (ops/gmm_batch.py) on this Pipeline's device: the reference's
        nested Pool fan-out (_per_cycle_gmm_MP, MCsimlib.py:3307-3375) in
        one dispatch (on a device list, one a data device over its share
        of the models). Returns (all_fit_scores, all_fits,
        raw_photometries) in the reference's structure, with BatchedGMM1D
        fits (means_/covars_/weights_/bic)."""
        from .inference.gmm import per_cycle_gmm_batched
        with self._stage("api/per_cycle_gmm"):
            return per_cycle_gmm_batched(
                photometries, min_fluors=min_fluors, max_fluors=max_fluors,
                n_init=n_init, n_iter=n_iter, cycles=cycles,
                lower_bound=lower_bound, seed=seed,
                device=self._ops_device)

    # -- simulation ----------------------------------------------------------

    @_traced
    def simulate_signals(self, peptides, p, b, u, windows, sample_size=100,
                         random_seed=None):
        """Monte-Carlo signal trie (MCsimlib.py:1787-1849) from the native
        C++ sampler (csrc/randsiggen.cpp, built with g++ at first use). A
        failed build raises: the JAX package's quiet rerun on the Python
        sampler would draw from another stream. Host work, whatever the
        Pipeline's device or devices."""
        from .native.randsiggen import monte_carlo_trie_native

        with self._stage("api/simulate_signals"):
            return monte_carlo_trie_native(
                peptides, p, b, u, windows, sample_size=sample_size,
                random_seed=random_seed)
