"""The timetrace CSV as text, in plain Python.

A frozen copy of what the port's ``pipeline/experiment.py::
TimetraceExperiment.save_experiment_as_csv`` writes for ``run_timetrace``
with ``include_step_fits`` and ``include_intermediates``
(flexlibrary.py:3550-3709), over the trace classes' lookups
(``pipeline/traces.py``: ``PhotometryTrace``, ``PlateauTrace``; and
``stepfitting.py``'s ``plateau_value``, ``last_step_info``,
``frame_plateau``): one row per trace and frame with the trace's start
key, the frame's photometry, the step-fit columns (step number, plateau
height, step size, plateau length, the fit's R^2 against the photometry)
and, in sorted order of their names, the intermediates' values (CK
trace, photometries, refit plateaus, t-filtered plateaus), each held from
the last start of a plateau.

Departure: the rows are written to a string, not to a file, with the
``excel`` dialect the port's file uses.
"""

from __future__ import annotations

import csv
import io

import numpy as np

INTERMEDIATES = ("ck_filtered_photometries", "photometries", "plateaus",
                 "t_filtered_plateaus")


def _plateau_value(plateaus, frame):
    for start, stop, height in plateaus:
        if start <= frame <= stop:
            return height
    raise ValueError("frame " + str(frame) + " is outside of plateaus")


def _last_step_info(steps, frame):
    """stepfitting.last_step_info, given a plateau list as the trace class
    gives it (a plateau read as (pre, post, magnitude))."""
    for s in range(len(steps) - 1):
        pre_a, post_a, mag_a = steps[s]
        pre_b = steps[s + 1][0]
        if post_a <= frame <= pre_b:
            return (s, pre_a, mag_a)
    if len(steps) == 0:
        return None, None, None
    last_pre, _, last_mag = steps[-1]
    if frame >= last_pre:
        return (len(steps) - 1, last_pre, last_mag)
    return None, None, None


def _frame_plateau(plateaus, frame):
    for start, stop, height in plateaus:
        if start <= frame <= stop:
            return start, stop, height
    return None, None, None


def _r_squared(phots, plateaus):
    """Trace.coefficient_of_determination(photometries, step fit)."""
    rss = float(sum((phots[f] - _plateau_value(plateaus, f)) ** 2
                    for f in range(len(phots))))
    m = float(np.mean(phots))
    tss = float(sum((p - m) ** 2 for p in phots))
    return 1.0 - rss / tss


def csv_text(h0, w0, fits, n_frames):
    """The CSV of traces starting at (h0[i], w0[i]) with step-chain
    results ``fits[i]`` = (photometries, CK trace, plateaus, t-filtered
    plateaus)."""
    buf = io.StringIO(newline="")
    writer = csv.writer(buf, dialect="excel")
    writer.writerow(["Trace #", "Hcoord", "Wcoord", "Frame #", "Photometry",
                     "Step #", "Plateau Height", "Step Size",
                     "Plateau Length", "Overall Fit R^2"] +
                    list(INTERMEDIATES))
    for t, (h, w, (phots, ck, plateaus, t_filtered)) in enumerate(
            zip(h0, w0, fits)):
        base = [str(t), str(int(h)), str(int(w))]
        starts = {p[0] for p in t_filtered}
        ls_num, _, ls_mag = _last_step_info(t_filtered, 0)
        pa, po, ph = _frame_plateau(t_filtered, 0)
        length = po - pa + 1
        r_2 = _r_squared(phots, t_filtered)
        # Every frame starts a value of the two photometry intermediates;
        # the plateau intermediates hold from each plateau's start.
        inter = {"ck_filtered_photometries": (None, lambda f: ck[f]),
                 "photometries": (None, lambda f: phots[f]),
                 "plateaus": ({p[0] for p in plateaus},
                              lambda f: _plateau_value(plateaus, f)),
                 "t_filtered_plateaus": (starts, lambda f: _plateau_value(
                     t_filtered, f))}
        held = dict.fromkeys(INTERMEDIATES)
        for f in range(n_frames):
            row = base + [str(f), phots[f]]
            if f in starts:
                ls_num, _, ls_mag = _last_step_info(t_filtered, f)
                pa, po, ph = _frame_plateau(t_filtered, f)
                length = po - pa + 1
            row += [str(ls_num), str(ph), str(ls_mag), str(length), str(r_2)]
            for name in INTERMEDIATES:
                at, value = inter[name]
                if at is None or f in at:
                    held[name] = value(f)
                row.append(str(held[name]))
            writer.writerow(row)
    return buf.getvalue()
