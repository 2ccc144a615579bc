"""Offset algebra of the greedy tracker.

Counterpart of ``accumulate_offsets`` in
fluorosequencingimageanalysis_tpu/pipeline/tracking.py (the reference's
Experiment.accumulate_offsets). The linking itself is the native core,
native/tracklink.py.
"""

from __future__ import annotations


def accumulate_offsets(offsets):
    """Cumulative offsets with respect to frame 0: a list of (h, w)
    running sums, added in frame order (the float order is the reference's).
    """
    if tuple(offsets[0]) != (0, 0):
        raise ValueError("The first image's offset must be (0, 0) by "
                         "definition.")
    out = []
    ch = cw = 0.0
    for dh, dw in offsets:
        ch += dh
        cw += dw
        out.append((ch, cw))
    return out
