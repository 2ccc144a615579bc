"""The reference's class path over an experiment stack, timed by stage.

Drives the object layer as basic_experiment_script does once its psfs
exist: per field, detection of every cycle in one call
(``find_peptides_batch``: kernels A and B on the card), ``Image`` and
``Spot`` objects of the detections under easy_load_processed_image's rules,
a ``SequenceExperiment`` registered on its own frames (its constructor
registers, then ``offsets_from_frames`` again, as the script calls it), one
``MultichannelSequenceExperiment`` a field; then the
``MultifieldMultichannelSequenceExperiment``'s tracking, its discard of
invalid traces and its track-photometries CSV. It runs on the process
default device (``_device.default_device()``).

``chip_smoke.py``'s ``objects`` group and the card test of the class path
use it; tests/test_torch_objects.py holds it against the JAX package's
class path on the CPU.
"""

from __future__ import annotations

import csv
import time

from ..config import DetectConfig
from ..models.detect import find_peptides_batch
from ..pipeline import tracking
from ..pipeline.experiment import (MultichannelSequenceExperiment,
                                   MultifieldMultichannelSequenceExperiment,
                                   SequenceExperiment)
from ..pipeline.spots import Image, Spot
from ..utils import profiling

STAGES = ("detection", "registration", "tracking", "discard", "csv")


def class_path(stack, csv_path, max_candidates=4096, sync=None):
    """Run the class path on an [F, C, H, W] stack and write its track
    CSV (every frame's mexican-hat photometry) to ``csv_path``, with the
    detection settings of ``DetectConfig()`` as ``run_experiment``'s.

    Returns ``(mfmc, seconds)``: the experiment object and the host
    seconds of each stage of ``STAGES``, plus ``photometry``, the part of
    ``discard`` and ``csv`` spent in the batched device photometry.
    ``sync``: called at each stage's end (a device synchronise, so a
    stage's time holds its own device work).
    """
    seconds = dict.fromkeys(STAGES, 0.0)
    sync = sync or (lambda: None)

    def lap(name, t0):
        sync()
        seconds[name] += time.perf_counter() - t0
        return time.perf_counter()

    def photometry_seconds():
        return profiling.timings().get("objects/photometry",
                                       {"total": 0.0})["total"]

    phot0 = photometry_seconds()
    fields = []
    for f in range(stack.shape[0]):
        t0 = time.perf_counter()
        psfs_list = find_peptides_batch(
            stack[f], max_candidates=max_candidates,
            num_iters=DetectConfig().num_iters)
        images = []
        for c, psfs in enumerate(psfs_list):
            img = Image(image=stack[f, c],
                        metadata={"filepath": f"mem://{f}/{c}"},
                        spots=None)
            spots = []
            for (h, w), fit in psfs.items():
                try:
                    spots.append(Spot(img, int(tracking._py2_round(h)),
                                      int(tracking._py2_round(w)), 5,
                                      gaussian_fit=fit))
                except AttributeError:  # the window leaves the image
                    pass
            img.spots = spots
            images.append(img)
        t0 = lap("detection", t0)
        ex = SequenceExperiment(images, alignment_frames=images)
        ex.offsets_from_frames()
        fields.append(MultichannelSequenceExperiment({"ch1": ex}))
        lap("registration", t0)
    t0 = time.perf_counter()
    mfmc = MultifieldMultichannelSequenceExperiment(fields)
    mfmc.trace_existing_spots()
    t0 = lap("tracking", t0)
    mfmc.discard_invalid_traces()
    t0 = lap("discard", t0)
    mfmc.track_photometries_as_csv(str(csv_path), save_averages=False)
    lap("csv", t0)
    seconds["photometry"] = photometry_seconds() - phot0
    return mfmc, seconds


def read_rows(csv_path):
    """(header, rows) of a track-photometries CSV."""
    with open(csv_path) as fh:
        reader = csv.reader(fh)
        return next(reader), list(reader)
