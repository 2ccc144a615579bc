"""The uncapped detection's NMS (``models/detect.py::
detect_and_fit_exhaustive``): kernel F (``ops/consolidate.py::
consolidate``) over each image's whole chunked candidate set where the
images are on the card, ``consolidate_host`` where they are on the CPU,
one keep mask either way.

The CPU test holds the routing: CPU images run ``consolidate_host`` and
load no kernel. The tests marked ``cuda`` hold the card's mask to
``consolidate_host`` over the same fetched centers, R^2 and gate:

    python -m pytest --noconftest tests/test_torch_exhaustive_nms.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import nms_cases
from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.models import detect
from fluorosequencingimageanalysis_torch.ops import consolidate as cons
from fluorosequencingimageanalysis_torch.utils import profiling
from fluorosequencingimageanalysis_torch.utils.synth import make_zstack

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset_timings()
    profiling.reset_counters()
    yield
    profiling.reset_timings()
    profiling.reset_counters()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _spy_host_nms(monkeypatch):
    """Count the calls of ``consolidate_host`` the detection makes."""
    calls = []
    real = detect.consolidate_host

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(detect, "consolidate_host", spy)
    return calls


def _host_keep(res, r_2_threshold=0.7, radius=4.0):
    """``consolidate_host`` over a result's fetched centers and R^2, gated
    as the detection gates them (a NaN R^2 passes)."""
    passed = res.cand_valid & ~(res.r2 < r_2_threshold)
    keep = np.stack([cons.consolidate_host(res.center_h[b], res.center_w[b],
                                           res.r2[b], passed[b], radius)
                     for b in range(passed.shape[0])])
    return keep, passed


def test_cpu_images_take_consolidate_host_and_load_no_kernel(monkeypatch):
    """Three dense 64x64 frames in chunks of 64: one ``consolidate_host``
    an image, no kernel loaded or launched, no launch counted."""
    frames = make_zstack(T=3, H=64, W=64, n_spots=25, seed=12)
    images = torch.from_numpy(frames.astype(np.float32) - 600.0)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"a CPU call loaded {name}"))
    calls = _spy_host_nms(monkeypatch)
    before = cons.consolidate.launches
    with profiling.tracing():
        res = detect.detect_and_fit_exhaustive(images, chunk=64,
                                               device="cpu")
    c = profiling.counters()
    assert len(calls) == 3
    assert cons.consolidate.launches == before
    assert "detect/consolidate_launches" not in c
    assert res.cand_h.shape[1] // 64 == c["detect/exhaustive_chunks"] >= 3
    keep, passed = _host_keep(res)
    np.testing.assert_array_equal(res.keep, keep)
    assert c["detect/host_nms_fits"] == int(passed.sum())
    assert int(passed.sum()) > int(res.keep.sum()) > 0


@pytest.fixture
def dense_field(dev):
    """Three 512x512 frames of 2,000 spots each (~11,700 candidates a
    frame), background subtracted on the card."""
    from fluorosequencingimageanalysis_torch.ops.background import (
        subtract_background_stack)
    frames = make_zstack(T=3, n_spots=2000, seed=21)
    return subtract_background_stack(frames, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4096, 1000])
def test_card_keep_equals_consolidate_host(dense_field, chunk, monkeypatch):
    """On the card: ``consolidate_host`` is not called; the keep mask
    equals ``consolidate_host``'s over the fetched centers, R^2 and gate,
    bit for bit; kernel F launches once a call; the chunk and fit counters
    read what the host NMS counted (the chunks the counts need, the fits
    past the gate)."""
    images = dense_field
    calls = _spy_host_nms(monkeypatch)
    before = cons.consolidate.launches
    with profiling.tracing():
        res = detect.detect_and_fit_exhaustive(images, chunk=chunk)
    c = profiling.counters()
    assert calls == []
    assert cons.consolidate.launches == before + 1
    assert c["detect/consolidate_launches"] == 1
    keep, passed = _host_keep(res)
    np.testing.assert_array_equal(res.keep, keep)
    n_chunks = -(-int(res.cand_count.max()) // chunk)
    assert res.cand_h.shape == (3, n_chunks * chunk)
    assert c["detect/exhaustive_chunks"] == n_chunks
    assert c["detect/host_nms_fits"] == int(passed.sum())
    assert (res.cand_count > 10_000).all()
    assert (passed.sum(1) > 2 * res.keep.sum(1)).all()
    assert (res.keep.sum(1) > 1_000).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", nms_cases.HOST_NAMES)
def test_kernel_f_equals_consolidate_host_at_the_uncapped_density(dev,
                                                                  name):
    """Kernel F on the cases too large for the plain twin: the mask of
    ``consolidate_host``, bit for bit, in one launch."""
    ch, cw, r2, valid, radius, _ = nms_cases.case(name)
    want = np.stack([cons.consolidate_host(ch[b], cw[b], r2[b], valid[b],
                                           radius)
                     for b in range(ch.shape[0])])
    before = cons.consolidate.launches
    got = cons.consolidate(*[torch.from_numpy(a).to(dev)
                             for a in (ch, cw, r2, valid)], radius)
    assert cons.consolidate.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_run_zstack_launches_kernel_f_once_a_group(dev, monkeypatch):
    """``run_zstack(max_candidates="exhaustive")`` on the card: groups of
    8 and 1 frames, one launch of kernel F each, no host NMS."""
    frames = make_zstack(T=9, H=64, W=64, n_spots=25, seed=12)
    calls = _spy_host_nms(monkeypatch)
    before = cons.consolidate.launches
    out = Pipeline(device="cuda", profile=True).run_zstack(
        frames, max_candidates="exhaustive", box_size=16, filter_size=3)
    c = profiling.counters()
    assert calls == []
    assert cons.consolidate.launches == before + 2
    assert c["detect/consolidate_launches"] == 2
    assert c["detect/exhaustive_chunks"] == 2
    assert int(out["keep"].sum()) > 0
