"""Track-photometry ingestion.

Counterpart of ``read_track_photometries_csv`` in
fluorosequencingimageanalysis_tpu/inference/photometries.py (the reference's
CSV round trip, MCsimlib.py:2534-2575): its pure-Python reader. The native
tokenizer and the rest of that module (adjustments, remainders) are not
ported yet (ROADMAP.md Queue 1 item 14).

The photometries dict convention (the compatibility surface):
    {channel: {field: {(h, w): (category, intensities, row)}}}
"""

from __future__ import annotations

import csv

from ..utils.rounding import py2_round as _py2_round


def read_track_photometries_csv(path, downstep_filtered=False, head_truncate=0,
                                tail_truncate=0, omit_header=True,
                                channels=None):
    """Parse a track_photometries CSV (MCsimlib.py:2534-2575).

    Returns (d, d2): d is the photometries dict; d2 maps CSV row index to
    the parsed row tuple.
    """
    with open(path) as f:
        reader = csv.reader(f)
        d = {}
        d2 = {}
        for r, row in enumerate(reader):
            if r == 0 and omit_header:
                continue
            head, frames = row[:5], row[5:]
            channel, field, h, w, category = head
            if channels is not None and channel not in channels:
                continue
            if h == "None" or w == "None":
                continue
            # Py2 int(round(x)) rounds half away from zero; Python 3's
            # banker's rounding would disagree on *.5 values
            # (MCsimlib.py:2550-2552).
            field, h, w = (_py2_round(float(field)), _py2_round(float(h)),
                           _py2_round(float(w)))
            category = category[1:-1]
            category = category.split(" ")
            parsed_cat = tuple(c in ("True,", "True") for c in category)
            if tail_truncate > 0:
                parsed_cat = parsed_cat[head_truncate:-tail_truncate]
            else:
                parsed_cat = parsed_cat[head_truncate:]
            parsed_cat = tuple(parsed_cat)
            if downstep_filtered:
                if not (tuple(sorted(parsed_cat, reverse=True)) == parsed_cat
                        and parsed_cat[0]):
                    continue
            parsed_frames = [_py2_round(float(x)) for x in frames]
            if tail_truncate > 0:
                parsed_frames = parsed_frames[head_truncate:-tail_truncate]
            else:
                parsed_frames = parsed_frames[head_truncate:]
            parsed_frames = tuple(parsed_frames)
            d.setdefault(channel, {}).setdefault(field, {}).setdefault(
                (h, w), (parsed_cat, parsed_frames, r))
            d2.setdefault(r, (channel, field, h, w, parsed_cat, parsed_frames))
    return d, d2
