"""The port's front door: ``Pipeline(device=...)``.

Counterpart of fluorosequencingimageanalysis_tpu/api.py ``Pipeline``'s
``run_stack`` and ``run_experiment``, on one device. The JAX Pipeline's
artifact store and mesh padding are not ported.

    from fluorosequencingimageanalysis_torch.api import Pipeline
    out = Pipeline(device="cuda").run_stack(stack)       # [F, C, H, W]
    res = Pipeline(device="cuda").run_experiment(stack, csv_path="t.csv")
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging

import numpy as np
import torch

from ._device import resolve_device
from .config import PipelineConfig
from .utils import profiling

# Dtypes the step takes as they are: float32, and raw camera integers,
# which upload as-is (half the bytes of float32 for uint16) and are cast
# on the device. Anything else is cast to float32 on the host.
_NATIVE_STACK_DTYPES = ("float32", "uint8", "uint16", "int16", "int32")

# Fields per group of run_experiment's grouped step. A group's upload runs
# beside the previous group's step and its host tracking beside the next
# group's step; 8 fields of 8 cycles of 512x512 is 32 MB of uint16 frames
# and 64 images per step.
GROUP_FIELDS = 8

# The step outputs run_experiment fetches: the compact spot bucket (int16
# rounded centers, int8 tri-state, candidate order), its photometry, the
# offsets and the overflow flags. The [F, C, K] fit arrays stay on the
# device.
EXPERIMENT_KEYS = ("offsets_h", "offsets_w", "spot_rh", "spot_rw",
                   "spot_state", "spot_cand_c", "spot_overflow",
                   "cand_count", "photometry")

logger = logging.getLogger(__name__)


def _normalize_stack(stack):
    """Host-side dtype normalisation; tensors pass through untouched."""
    if isinstance(stack, torch.Tensor):
        return stack
    stack = np.asarray(stack)
    if stack.dtype.name not in _NATIVE_STACK_DTYPES:
        stack = stack.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(stack))


class Pipeline:
    """Config-driven experiment step and experiment on one device."""

    def __init__(self, config: PipelineConfig | None = None,
                 device="cuda", profile: bool = False):
        """
        Arguments:
            config: PipelineConfig (defaults mirror the reference's); the
                JAX package's PipelineConfig works too.
            device: where the step runs ("cuda", "cuda:1", "cpu", ...). A
                CUDA device must exist; CPU runs the kernels' plain twins.
            profile: record host-clock stage timings into
                ``utils.profiling``'s registry.
        """
        self.config = config if config is not None else PipelineConfig()
        self.device = resolve_device(device)
        self.profile = profile

    def _stage(self, name):
        if self.profile:
            return profiling.stage(name)
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

        stack = _normalize_stack(stack)
        if stack.ndim != 4 or stack.shape[0] == 0:
            raise ValueError("stack must be a non-empty [fields, cycles, "
                             f"H, W] array (got shape {tuple(stack.shape)})")
        kw = self._step_kwargs(max_candidates, photometry_method,
                               photometry_min)
        if keys is not None:
            keys = tuple(keys)
        with self._stage("api/run_stack"):
            x = stack.to(self.device)
            with torch.no_grad():
                out = experiment_step(x, max_spots=max_spots, **kw)
            return {k: v.cpu().numpy() for k, v in out.items()
                    if keys is None or k in keys}

    def _stack_step_groups(self, stack, keys, max_candidates=None,
                           max_spots=None, dispatch="eager"):
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
        k is yielded once group k+1's step has been enqueued.
        """
        from .parallel.mesh import experiment_step

        if dispatch not in ("eager", "window"):
            raise ValueError(f"dispatch must be 'eager' or 'window' (got "
                             f"{dispatch!r})")
        g = GROUP_FIELDS
        kw = self._step_kwargs(max_candidates, photometry_min=None)
        keys = tuple(keys)
        dev = self.device
        on_card = dev.type == "cuda"
        F = stack.shape[0]
        lows = list(range(0, F, g))
        groups = [None] * len(lows)
        uploaded = [None] * len(lows)   # upload events (card only)
        if stack.device == dev:
            groups = [stack[lo:lo + g] for lo in lows]
        elif on_card:
            with self._stage("api/run_stack"):
                host = stack if stack.is_pinned() else stack.pin_memory()
            copy_stream = torch.cuda.Stream(dev)

        def upload(i):
            if groups[i] is not None:
                return
            part = (host if on_card else stack)[lows[i]:lows[i] + g]
            if on_card:
                buf = torch.empty(part.shape, dtype=part.dtype, device=dev)
                # The buffer may reuse memory the main stream still reads.
                copy_stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(copy_stream):
                    buf.copy_(part, non_blocking=True)
                    uploaded[i] = torch.cuda.Event()
                    uploaded[i].record(copy_stream)
                buf.record_stream(copy_stream)
                groups[i] = buf
            else:
                groups[i] = part.to(dev)
            profiling.bump("ledger/uploads")
            profiling.bump("ledger/upload_bytes",
                           part.numel() * part.element_size())

        def step(i):
            if uploaded[i] is not None:
                torch.cuda.current_stream(dev).wait_event(uploaded[i])
            with torch.no_grad():
                out = experiment_step(groups[i], max_spots=max_spots, **kw)
            profiling.bump("ledger/step_dispatches")
            event = None
            if on_card:
                fetched = {}
                for k in keys:
                    fetched[k] = torch.empty(out[k].shape, dtype=out[k].dtype,
                                             pin_memory=True)
                    fetched[k].copy_(out[k], non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                fetched = {k: out[k].cpu() for k in keys}
            item = (fetched, event, groups[i], lows[i])
            groups[i] = None
            return item

        def resolve(item):
            fetched, event, grp, lo = item
            if event is not None:
                event.synchronize()
            out = {k: v.numpy() for k, v in fetched.items()}
            profiling.bump("ledger/result_fetches", len(out))
            profiling.bump("ledger/fetch_bytes",
                           sum(int(v.nbytes) for v in out.values()))
            return out, grp, lo

        n_ahead = 2 if dispatch == "window" else len(lows)
        with self._stage("api/run_stack"):
            for i in range(min(n_ahead, len(lows))):
                upload(i)
        pending = None
        for i in range(len(lows)):
            with self._stage("api/run_stack"):
                current = step(i)
                if i + n_ahead < len(lows):
                    upload(i + n_ahead)
                ready = resolve(pending) if pending is not None else None
            if ready is not None:
                yield ready
            pending = current
        with self._stage("api/run_stack"):
            ready = resolve(pending)
        yield ready

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
        the artifact store; ``config.photometry.method`` may be
        mexican_hat, simple, maximum, gaussian_volume or sigmas (sextractor
        is not ported yet and raises ValueError).

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
        overlap is run_stack + track+photometry - groups), then
        "api/run_experiment/hole_flush", "api/run_experiment/rows" (row
        post-processing and categories) and "api/run_experiment/csv".

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
            flush_hole_queue, run_experiment_stack, write_track_rows_csv)

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
        category_counts = {}
        offsets_out = {}
        summary = {}
        remainder_counts = {}
        mdma_adjustments = {}
        for channel, stack in stacks.items():
            F, C = stack.shape[:2]
            # Hole gathers are enqueued per group and resolved once after
            # the last group; save_averages never reads hole values.
            hole_queue = None if save_averages else []

            def track(out_grp, dev_grp, lo, stack=stack, C=C,
                      hole_queue=hole_queue):
                with self._stage("api/run_experiment/track+photometry"):
                    Fg = out_grp["offsets_h"].shape[0]
                    rhs, rws, values = _spot_lists(out_grp, Fg, C)
                    per_field = run_experiment_stack(
                        dev_grp, out_grp["offsets_h"], out_grp["offsets_w"],
                        (rhs, rws), values, photometry_method=phot.method,
                        photometry_radius=phot.radius,
                        photometry_brim=phot.brim_size,
                        candidate_radius=candidate_radius,
                        hole_queue=hole_queue,
                        skip_hole_gathers=save_averages,
                        keep_invalid=keep_invalid,
                        host_images=(stack[lo:lo + Fg] if keep_invalid
                                     else None))
                n_spots = sum(len(rh) for per_c in rhs for rh in per_c)
                return per_field, out_grp, n_spots

            with self._stage("api/run_experiment/groups"), \
                    concurrent.futures.ThreadPoolExecutor(1) as pool:
                futures = [pool.submit(track, *item) for item in
                           self._stack_step_groups(
                               stack, EXPERIMENT_KEYS,
                               max_candidates=max_candidates,
                               max_spots=max_spots, dispatch=dispatch)]
                parts = [f.result() for f in futures]
            per_field = [r for p, _, _ in parts for r in p]
            outs = [o for _, o, _ in parts]
            spot_count = sum(n for _, _, n in parts)
            n_over = sum(int(o["spot_overflow"].sum()) for o in outs)
            n_cand_over = sum(int((o["cand_count"] > mc_eff).sum())
                              for o in outs)
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
        filtered = filter_monotone_categories(category_counts)
        with self._stage("api/run_experiment/csv"):
            if csv_path is not None:
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
