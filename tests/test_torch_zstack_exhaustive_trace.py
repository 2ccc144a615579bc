"""The uncapped detection's tracing: the spans ``api/detect/exhaustive``
and ``api/detect/host_nms`` and the counters ``detect/exhaustive_chunks``
and ``detect/host_nms_fits`` that ``models/detect.py::
detect_and_fit_exhaustive`` records under tracing (``Pipeline(profile=
True)``, ``profiling.tracing()``), and nothing of them without.

On the CPU the spans hold host time only; the test marked ``cuda`` reads
the device time of ``api/detect/exhaustive`` on the card:

    python -m pytest --noconftest tests/test_torch_zstack_exhaustive_trace.py -q
"""

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch import api
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.models import detect
from fluorosequencingimageanalysis_torch.utils import profiling
from fluorosequencingimageanalysis_torch.utils.synth import make_zstack

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

SPANS = ("api/detect/exhaustive", "api/detect/host_nms")
COUNTERS = ("detect/exhaustive_chunks", "detect/host_nms_fits")
BOX = dict(box_size=16, filter_size=3)


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset_timings()
    profiling.reset_counters()
    yield
    profiling.reset_timings()
    profiling.reset_counters()
    assert not profiling.enabled()


@pytest.fixture(scope="module")
def frames():
    """Nine frames: one group of ``api.GROUP_FRAMES`` (8) and one of 1."""
    return make_zstack(T=9, H=64, W=64, n_spots=25, seed=12)


@pytest.fixture(scope="module")
def images(frames):
    """Three background-free frames as float32 (B, H, W), dense enough for
    several chunks of 64 candidates."""
    return torch.from_numpy(frames[:3].astype(np.float32) - 600.0)


def test_run_zstack_records_both_spans_once_a_group(frames):
    assert api.GROUP_FRAMES == 8
    out = Pipeline(device="cpu", profile=True).run_zstack(
        frames, max_candidates="exhaustive", **BOX)
    t = profiling.timings()
    for name in SPANS:
        assert t[name]["count"] == 2, name      # groups of 8 and 1 frames
        assert t[name]["total"] > 0
        assert "device_total" not in t[name]    # the CPU has no device time
    c = profiling.counters()
    K = out["keep"].shape[1]
    assert c["detect/exhaustive_chunks"] == 2   # one chunk a group here
    assert K == detect.EXHAUSTIVE_CHUNK
    assert 0 < c["detect/host_nms_fits"] <= int(out["cand_count"].sum())


def _gate_passes(res, r_2_threshold=0.7):
    return int((res.cand_valid & ~(res.r2 < r_2_threshold)).sum())


def test_chunks_and_fits_counted(images):
    with profiling.tracing():
        res = detect.detect_and_fit_exhaustive(images, chunk=64,
                                               device="cpu")
    n_chunks = res.cand_h.shape[1] // 64
    assert n_chunks == -(-int(res.cand_count.max()) // 64) >= 3
    c = profiling.counters()
    assert c["detect/exhaustive_chunks"] == n_chunks
    assert c["detect/host_nms_fits"] == _gate_passes(res)
    assert _gate_passes(res) > int(res.keep.sum()) > 0
    t = profiling.timings()
    assert all(t[name]["count"] == 1 for name in SPANS)


def test_tracing_changes_no_result_and_counts_nothing_when_off(images):
    off = detect.detect_and_fit_exhaustive(images, chunk=64, device="cpu")
    assert not set(COUNTERS) & set(profiling.counters())
    assert not set(SPANS) & set(profiling.timings())
    with profiling.tracing():
        on = detect.detect_and_fit_exhaustive(images, chunk=64,
                                              device="cpu")
    for name, a, b in zip(off._fields, off, on):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.cuda
def test_exhaustive_span_has_device_time_on_the_card(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this process sees none")
    out = Pipeline(device="cuda", profile=True).run_zstack(
        frames, max_candidates="exhaustive", **BOX)
    t = profiling.timings()
    assert t["api/detect/exhaustive"]["count"] == 2
    assert t["api/detect/exhaustive"]["device_total"] > 0
    assert "device_total" not in t["api/detect/host_nms"]
    c = profiling.counters()
    assert c["detect/exhaustive_chunks"] == 2
    assert c["detect/host_nms_fits"] >= int(out["keep"].sum()) > 0
