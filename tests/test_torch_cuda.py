"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``; every test skips (inside a fixture, never at import) where
torch sees no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import nms_cases
from fluorosequencingimageanalysis_torch import api
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.ops.candidates import (
    DEFAULT_CORRELATION_MATRIX, find_candidates_batch)
from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
    candidate_map_fused, candidate_map_plain)
from fluorosequencingimageanalysis_torch.ops.fused_fit import (
    fit_quality, fit_quality_plain)
from fluorosequencingimageanalysis_torch.ops.gaussian import gauss2d_image
from fluorosequencingimageanalysis_torch.ops.candidates import gather_patches
from fluorosequencingimageanalysis_torch.pipeline.fast_experiment import (
    gather_windows)
from fluorosequencingimageanalysis_torch.utils.synth import (
    make_experiment_stack, make_stack)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _planted(b, h, w, seed):
    if min(h, w) < 20:  # too small for planted spots: noise only
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.normal(400, 8, (b, h, w))
                                .astype(np.float32))
    stack, _ = make_stack(1, b, h, w, spots_per_field=max(4, h * w // 1500),
                          seed=seed)
    return torch.from_numpy(stack[0])


@pytest.mark.parametrize("b,h,w", [(1, 48, 100), (1, 33, 257), (2, 70, 130),
                                   (3, 96, 384), (2, 5, 7)])
def test_kernel_a_matches_twin(dev, b, h, w):
    # The median is exact and the taps keep the twin's FMA order, so the
    # kernel equals the twin run on the same card: max abs err 0.
    x = _planted(b, h, w, seed=h).to(dev)
    before = candidate_map_fused.launches
    got = candidate_map_fused(x, DEFAULT_CORRELATION_MATRIX)
    torch.cuda.synchronize()
    assert candidate_map_fused.launches == before + 1
    ref = candidate_map_plain(x, DEFAULT_CORRELATION_MATRIX)
    assert float((got - ref).abs().max()) == 0.0
    # An arbitrary 5x5 template is a kernel argument, not compiled in.
    tmpl = np.random.default_rng(0).normal(0, 1000, (5, 5))
    got = candidate_map_fused(x, tmpl)
    assert float((got - candidate_map_plain(x, tmpl)).abs().max()) == 0.0


def test_kernel_a_rejects_what_it_does_not_take(dev):
    x = torch.zeros((2, 32, 32), device=dev)
    with pytest.raises(TypeError, match="float32"):
        candidate_map_fused(x.double(), DEFAULT_CORRELATION_MATRIX)
    with pytest.raises(ValueError, match="contiguous"):
        candidate_map_fused(x.transpose(1, 2), DEFAULT_CORRELATION_MATRIX)
    with pytest.raises(ValueError, match="images required"):
        candidate_map_fused(x[None], DEFAULT_CORRELATION_MATRIX)


@pytest.mark.parametrize("theta_starts", [1, 2])
def test_kernel_b_matches_twin(dev, theta_starts):
    """The twin runs on the same card, so both sides do the same float32
    arithmetic. Where valid and R^2 >= 0.7: centers within 1e-3 px, R^2
    within 1e-4, RMSE within 1e-4 relative, the model image within 1e-3 x
    the patch max (float32 LM; the accept/reject test flips on ulp-level
    differences near convergence)."""
    x = _planted(3, 128, 128, seed=7)
    hs, ws, valid, _ = find_candidates_batch(x, max_candidates=256)
    args = (x.to(dev), hs.to(dev), ws.to(dev), 20, theta_starts)
    before = fit_quality.launches
    got = [a.cpu() for a in fit_quality(*args)]
    torch.cuda.synchronize()
    assert fit_quality.launches == before + 1
    ref = [a.cpu() for a in fit_quality_plain(*args)]
    assert [g.shape for g in got] == [r.shape for r in ref]
    # The kernel does the twin's float32 arithmetic in the twin's order.
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    m = (valid & (ref[4] >= 0.7)).numpy()
    assert m.sum() > 50
    for i, tol in ((1, 1e-3), (2, 1e-3), (4, 1e-4)):
        np.testing.assert_allclose(got[i].numpy()[m], ref[i].numpy()[m],
                                   atol=tol)
    np.testing.assert_allclose(got[3].numpy()[m], ref[3].numpy()[m],
                               rtol=1e-4)
    np.testing.assert_allclose(got[5].numpy()[valid.numpy()],
                               ref[5].numpy()[valid.numpy()], rtol=1e-4)
    mg = gauss2d_image(got[0][m].double(), dtype=torch.float64)
    mr = gauss2d_image(ref[0][m].double(), dtype=torch.float64)
    pmax = gather_patches(x, hs, ws).abs().amax(dim=(-2, -1))[m]
    assert bool(((mg - mr).abs().amax(dim=(-2, -1)) <= 1e-3 * pmax).all())


@pytest.mark.parametrize("b,k", [(3, 1000), (2, 34_000)])
def test_kernel_b_ragged_batch_and_second_wave(dev, b, k):
    """B*K not a multiple of the 128-thread block (a ragged last block),
    and 68,000 fits, more than the 528 x 128 = 67,584 one wave holds on an
    H100, so some blocks run in a second wave. Candidates at seeded
    positions 2 px inside the image: parameters bitwise equal to the twin
    on the same card, S/N (no fit involved) to float32 rounding."""
    x = _planted(b, 96, 128, seed=k).to(dev)
    rng = np.random.default_rng(k)
    hs = torch.from_numpy(rng.integers(2, 94, (b, k)).astype(np.int32))
    ws = torch.from_numpy(rng.integers(2, 126, (b, k)).astype(np.int32))
    args = (x, hs.to(dev), ws.to(dev), 10, 1)
    got = [a.cpu() for a in fit_quality(*args)]
    ref = [a.cpu() for a in fit_quality_plain(*args)]
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_allclose(got[5].numpy(), ref[5].numpy(), rtol=1e-4)


def test_kernel_b_rejects_what_it_does_not_take(dev):
    x = torch.zeros((2, 32, 32), device=dev)
    hs = torch.full((2, 4), 5, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        fit_quality(x.double(), hs, hs, 5)
    with pytest.raises(TypeError, match="int32"):
        fit_quality(x, hs.long(), hs, 5)
    with pytest.raises(ValueError, match="contiguous"):
        fit_quality(x.transpose(1, 2), hs, hs, 5)
    with pytest.raises(ValueError, match="share a device"):
        fit_quality(x, hs.cpu(), hs.cpu(), 5)
    with pytest.raises(ValueError, match=r"\(B, K\)"):
        fit_quality(x, hs[:1], hs[:1], 5)


def test_pipeline_on_the_card_runs_both_kernels_and_agrees_with_cpu(dev):
    stack, _ = make_stack(2, 2, 128, 128, spots_per_field=20, seed=11)
    cfg = PipelineConfig(detect=DetectConfig(max_candidates=128,
                                             num_iters=20))
    a0, b0 = candidate_map_fused.launches, fit_quality.launches
    gpu = Pipeline(cfg, device=dev).run_stack(stack.astype(np.uint16))
    assert candidate_map_fused.launches > a0 and fit_quality.launches > b0
    cpu = Pipeline(cfg, device="cpu").run_stack(stack.astype(np.uint16))
    for k in cpu:
        assert gpu[k].shape == cpu[k].shape and gpu[k].dtype == cpu[k].dtype
    np.testing.assert_array_equal(gpu["offsets_h"], cpu["offsets_h"])
    np.testing.assert_array_equal(gpu["cand_count"], cpu["cand_count"])


def _same_rows(a, b, exact):
    assert len(a["rows"]) == len(b["rows"]) > 0
    for ra, rb in zip(a["rows"], b["rows"]):
        assert ra[:5] == rb[:5]
        va = np.asarray(ra[5], np.float64)
        vb = np.asarray(rb[5], np.float64)
        if exact:
            np.testing.assert_array_equal(va, vb)
        else:  # float32 sums of ~2e4 in another order: a few ulp apart
            np.testing.assert_allclose(va, vb, rtol=1e-4, atol=5e-2)


def test_run_experiment_on_the_card_matches_cpu(dev, tmp_path, monkeypatch):
    stack = np.clip(make_experiment_stack(2, 4, 128, 128, spots_per_field=40,
                                          seed=2), 0, 65535).astype(np.uint16)
    a0, b0 = candidate_map_fused.launches, fit_quality.launches
    gpu = Pipeline(device=dev).run_experiment(
        stack, max_candidates=256, csv_path=str(tmp_path / "g.csv"))
    assert candidate_map_fused.launches == a0 + 1  # one group, one step
    assert fit_quality.launches == b0 + 1
    cpu = Pipeline(device="cpu").run_experiment(
        stack, max_candidates=256, csv_path=str(tmp_path / "c.csv"))
    _same_rows(gpu, cpu, exact=False)
    assert gpu["category_counts"] == cpu["category_counts"]
    assert gpu["summary"] == cpu["summary"]
    for a, b in zip(gpu["offsets"]["ch1"], cpu["offsets"]["ch1"]):
        np.testing.assert_array_equal(a, b)
    # A stack already on the card, then groups of one field in the
    # windowed schedule: the same rows.
    pipe = Pipeline(device=dev)
    _same_rows(pipe.run_experiment(torch.from_numpy(stack).to(dev),
                                   max_candidates=256), gpu, exact=True)
    monkeypatch.setattr(api, "GROUP_FIELDS", 1)
    _same_rows(pipe.run_experiment(stack, max_candidates=256,
                                   dispatch="window"), gpu, exact=True)
    keep = dict(max_candidates=256, keep_invalid=True, mdma=True)
    kg = pipe.run_experiment(stack, **keep)
    kc = Pipeline(device="cpu").run_experiment(stack, **keep)
    assert [r[:5] for r in kg["rows"]] == [r[:5] for r in kc["rows"]]


def test_hole_gathers_on_the_card_equal_the_cpu(dev):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 65536, (6, 40, 50))
                         .astype(np.uint16))
    idx = [torch.from_numpy(rng.integers(lo, hi, 500)) for lo, hi in
           ((0, 6), (9, 31), (9, 41))]
    got = gather_windows(x.to(dev), *(i.to(dev) for i in idx), 9)
    ref = gather_windows(x, *idx, 9)
    assert torch.equal(got.cpu(), ref)


def test_kernels_match_twins_at_the_zstack_shapes(dev):
    """One upload group of config 2: 8 background-subtracted frames of
    512x512, an 8192-candidate bucket, 60 iterations; and the exhaustive
    path's 4096-candidate chunk."""
    from fluorosequencingimageanalysis_torch.ops.background import (
        subtract_background_stack)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        _threshold_and_extract_batch)
    from fluorosequencingimageanalysis_torch.utils.synth import make_zstack
    sub = subtract_background_stack(make_zstack(8), device=dev)
    cm = candidate_map_fused(sub, DEFAULT_CORRELATION_MATRIX)
    assert float((cm - candidate_map_plain(
        sub, DEFAULT_CORRELATION_MATRIX)).abs().max()) == 0.0
    hs, ws, valid, count = _threshold_and_extract_batch(cm, 8192, 2.0)
    assert int(count.min()) > 4096
    for k in (8192, 4096):
        h, w = hs[:, :k].contiguous(), ws[:, :k].contiguous()
        got = fit_quality(sub, h, w, 60, 1)
        ref = fit_quality_plain(sub, h, w, 60, 1)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0])          # parameters, bit for bit
        m = valid[:, :k] & (ref[4] >= 0.7)
        assert int(m.sum()) > 8 * 500
        assert float((got[1] - ref[1]).abs()[m].max()) <= 1e-3
        assert float((got[4] - ref[4]).abs()[m].max()) <= 1e-4


def test_run_zstack_and_find_peptides_card_vs_cpu(dev):
    from fluorosequencingimageanalysis_torch.models.detect import (
        find_peptides)
    from fluorosequencingimageanalysis_torch.utils.synth import make_zstack
    stack = make_zstack(5, 128, 128, n_spots=40)
    a0, b0 = candidate_map_fused.launches, fit_quality.launches
    outs = {}
    for kw in (dict(max_candidates=1024),
               dict(max_candidates=1024, lean=True, max_spots=128),
               dict(max_candidates="exhaustive", return_background=True)):
        card = Pipeline(device=dev).run_zstack(stack, **kw)
        cpu = Pipeline(device="cpu").run_zstack(stack, **kw)
        assert list(card) == list(cpu)
        for k in ("cand_h", "cand_w", "keep", "cand_valid", "cand_count"):
            np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
        kept = cpu["keep"]
        assert kept.sum() >= 5 * 30
        for k in ("center_h", "center_w"):
            np.testing.assert_allclose(card[k][kept], cpu[k][kept],
                                       atol=1e-3)
        np.testing.assert_allclose(card["r2"][kept], cpu["r2"][kept],
                                   atol=1e-4)
        outs[str(kw["max_candidates"]) + str(kw.get("lean"))] = card
    assert candidate_map_fused.launches >= a0 + 3
    assert fit_quality.launches >= b0 + 3
    bg = outs["exhaustiveNone"]["background"]
    assert bg.dtype == np.float32 and bg.shape == stack.shape
    img = stack[0].astype(np.float32)
    card, cpu = find_peptides(img), find_peptides(img, device="cpu")
    assert list(card) == list(cpu) and len(cpu) >= 30
    for key in cpu:
        np.testing.assert_allclose(card[key][:2], cpu[key][:2], atol=1e-3)
        np.testing.assert_array_equal(card[key][7], cpu[key][7])


def test_betainc_and_the_step_detector_on_the_card(dev):
    import scipy.special

    from fluorosequencingimageanalysis_torch.ops.special import betainc
    from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
        _ck_and_masks)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_step_traces)
    a, x = np.meshgrid(np.arange(1, 61) / 2.0, np.linspace(0, 1, 41),
                       indexing="ij")
    got = betainc(torch.from_numpy(a).to(dev), 0.5,
                  torch.from_numpy(x).to(dev))
    np.testing.assert_allclose(got.cpu().numpy(),
                               scipy.special.betainc(a, 0.5, x), rtol=0,
                               atol=1e-12)
    traces = torch.from_numpy(make_step_traces(256, 110, seed=1))
    ck, masks = _ck_and_masks(traces.to(dev), p_threshold=0.01)
    ck_c, masks_c = _ck_and_masks(traces, p_threshold=0.01)
    assert ck.dtype == torch.float64 and masks.dtype == torch.bool
    np.testing.assert_allclose(ck.cpu().numpy(), ck_c.numpy(), rtol=1e-12,
                               atol=1e-9)
    # A mask bit may differ only where p is at the threshold to rounding.
    assert int((masks.cpu() != masks_c).sum()) <= 1 and masks_c.any()


def _same_plateaus(a, b):
    assert [p[:2] for p in a] == [p[:2] for p in b]
    np.testing.assert_allclose([p[2] for p in a], [p[2] for p in b],
                               rtol=1e-9)


def test_stepfit_on_the_card_matches_cpu(dev):
    from fluorosequencingimageanalysis_torch.config import StepfitConfig
    from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
        stepfit_batched)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_step_traces)
    traces = make_step_traces(600, 100, seed=2)
    cfg = PipelineConfig(stepfit=StepfitConfig(
        mirror_start=10, chung_kennedy=1, p_threshold=0.01))
    card = Pipeline(cfg, device=dev).stepfit(traces)
    cpu = Pipeline(cfg, device="cpu").stepfit(traces)
    assert len(card) == len(cpu) == 600
    for g, c in zip(card, cpu):
        assert g[0] == c[0]
        np.testing.assert_allclose(g[1], c[1], rtol=1e-12, atol=1e-9)
        _same_plateaus(g[2], c[2])
        _same_plateaus(g[3], c[3])
    chunked = stepfit_batched(traces, mirror_start=10, chung_kennedy=1,
                              p_threshold=0.01, chunk=256, device=dev)
    assert [r[3] for r in chunked] == [r[3] for r in card]
    plain = stepfit_batched(traces[:64], p_threshold=0.01, device=dev)
    for g, c in zip(plain, stepfit_batched(traces[:64], p_threshold=0.01,
                                           device="cpu")):
        _same_plateaus(g[3], c[3])


@pytest.mark.parametrize("method", ["mexican_hat", "simple", "sextractor"])
def test_run_timetrace_on_the_card_matches_cpu(dev, method, tmp_path):
    from fluorosequencingimageanalysis_torch.config import PhotometryConfig
    from fluorosequencingimageanalysis_torch.utils.synth import make_movie
    movie = make_movie(T=12, H=128, W=128, n_spots=30, seed=3)
    cfg = PipelineConfig(photometry=PhotometryConfig(method=method))
    kw = dict(mirror_start=10, chung_kennedy=1, p_threshold=0.01)
    a0, b0 = candidate_map_fused.launches, fit_quality.launches
    card = Pipeline(cfg, device=dev).run_timetrace(
        movie, csv_path=str(tmp_path / "g.csv"), **kw)
    assert candidate_map_fused.launches == a0 + 1   # frame 0, exhaustive
    assert fit_quality.launches == b0 + 1           # one chunk
    cpu = Pipeline(cfg, device="cpu").run_timetrace(
        movie, csv_path=str(tmp_path / "c.csv"), **kw)
    assert card["trace_count"] == cpu["trace_count"] >= 20
    for k in ("h", "w", "rec_h", "rec_w", "present"):
        np.testing.assert_array_equal(card["traces"][k], cpu["traces"][k],
                                      err_msg=k)
    np.testing.assert_allclose(card["photometries"], cpu["photometries"],
                               rtol=1e-6, atol=5e-2)
    for key, fit in cpu["step_fits"].items():
        assert [p[:2] for p in card["step_fits"][key].trace] == \
            [p[:2] for p in fit.trace]
    with open(tmp_path / "g.csv") as a, open(tmp_path / "c.csv") as b:
        assert len(a.readlines()) == len(b.readlines()) == \
            1 + 12 * cpu["trace_count"]
    # A movie already on the card, and two movies with one uploaded ahead.
    pipe = Pipeline(cfg, device=dev)
    again = pipe.run_timetrace(torch.from_numpy(movie).to(dev), **kw)
    np.testing.assert_array_equal(again["photometries"],
                                  card["photometries"])
    two = pipe.run_timetraces([movie, movie[:8]], **kw)
    np.testing.assert_array_equal(two[0]["photometries"],
                                  card["photometries"])
    assert two[1]["photometries"].shape[1] == 8


def test_kernels_match_twins_at_the_timetrace_shapes(dev):
    """Frame 0 of the movie (1 x 512 x 512) and the exhaustive path's
    first chunk of its candidates, 60 iterations."""
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        extract_candidates_chunk)
    from fluorosequencingimageanalysis_torch.utils.synth import make_movie
    img = torch.from_numpy(make_movie(T=10)[:1].astype(np.float32)).to(dev)
    cm = candidate_map_fused(img, DEFAULT_CORRELATION_MATRIX)
    assert float((cm - candidate_map_plain(
        img, DEFAULT_CORRELATION_MATRIX)).abs().max()) == 0.0
    excluded = torch.zeros((1, 512 * 512), dtype=torch.bool, device=dev)
    hs, ws, valid, remaining, _ = extract_candidates_chunk(cm, excluded,
                                                           4096, 2.0)
    assert int(remaining[0]) > 1000 and bool(valid.any())
    got = fit_quality(img, hs, ws, 60, 1)
    ref = fit_quality_plain(img, hs, ws, 60, 1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])              # parameters, bit for bit
    m = valid & (ref[4] >= 0.7)
    assert int(m.sum()) > 500
    assert float((got[1] - ref[1]).abs()[m].max()) <= 1e-3
    assert float((got[4] - ref[4]).abs()[m].max()) <= 1e-4


def _v8_inputs(dev, T, F, K, allow_multidrop, allow_upsteps, seed):
    from fluorosequencingimageanalysis_torch.ops import lognormal as ln
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_v8_workload)
    ints, cats, lfm = make_v8_workload(T, F, K, seed=seed)
    cats[:40, 0] = False  # traces with no valid sequence
    cats[:40, -1] = True
    ints[40:80] = ints[40:80, :1]  # equal frames: exact ties
    ints[80:90, 0] = 0.0
    log_int = np.where(ints > 0, np.log(np.maximum(ints, 1e-300)),
                       -10000.0).astype(np.float32)
    contrib, invalid = ln._contrib_invalid(
        torch.from_numpy(log_int).to(dev), torch.from_numpy(cats).to(dev),
        torch.from_numpy(np.asarray(lfm[:K], np.float32)).to(dev), 0.2, 3.0)
    return contrib, invalid, ln.device_table(F, K, allow_upsteps,
                                             allow_multidrop, dev)


@pytest.mark.parametrize("T,F,K,allow_multidrop,allow_upsteps", [
    (20_001, 12, 5, True, False), (5_000, 6, 3, False, False),
    (3_000, 4, 3, True, True), (1_000, 1, 5, True, False)])
def test_kernel_c_matches_twin(dev, T, F, K, allow_multidrop, allow_upsteps):
    """Only float32 adds in frame order touch a score on both sides: the
    winner, the found flag and the raw score are equal bit for bit."""
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused, v8_score_plain)
    contrib, invalid, (tab_t, seq_ok) = _v8_inputs(
        dev, T, F, K, allow_multidrop, allow_upsteps, seed=F)
    before = v8_score_fused.launches
    got = v8_score_fused(contrib, invalid, tab_t, seq_ok)
    torch.cuda.synchronize()
    assert v8_score_fused.launches == before + 1
    assert 0 < float(got[1].float().mean()) < 1
    for lo in range(0, T, 4096):
        want = v8_score_plain(contrib[lo:lo + 4096], invalid[lo:lo + 4096],
                              tab_t, seq_ok)
        assert torch.equal(got[0][lo:lo + 4096], want[0])
        assert torch.equal(got[1][lo:lo + 4096], want[1])
        assert torch.equal(got[2][lo:lo + 4096].view(torch.int32),
                           want[2].view(torch.int32))
    empty = v8_score_fused(contrib[:0], invalid[:0], tab_t, seq_ok)
    assert [e.shape[0] for e in empty] == [0, 0, 0]


def test_kernel_c_rejects_what_it_does_not_take(dev):
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    contrib, invalid, (tab_t, seq_ok) = _v8_inputs(dev, 64, 4, 3, True,
                                                   False, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        v8_score_fused(contrib.transpose(0, 1).contiguous().transpose(0, 1),
                       invalid, tab_t, seq_ok)
    with pytest.raises(ValueError, match="share a device"):
        v8_score_fused(contrib, invalid, tab_t.cpu(), seq_ok)
    with pytest.raises(ValueError, match="shared memory"):
        v8_score_fused(contrib.new_zeros((2, 4, 400)),
                       invalid.new_zeros((2, 4, 400)), tab_t, seq_ok)


def test_fluor_counts_on_the_card_matches_cpu(dev, tmp_path):
    from fluorosequencingimageanalysis_torch.inference.photometries import (
        write_photometries_dict_to_csv)
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_v8_workload)
    ints, cats, _ = make_v8_workload(3000, F=8, K=3, seed=2)
    tracks = {"ch1": {0: {(i, i): (tuple(c), tuple(int(v) for v in x), i)
                          for i, (c, x) in enumerate(zip(cats.tolist(),
                                                         ints.tolist()))}}}
    path = str(tmp_path / "tracks.csv")
    write_photometries_dict_to_csv(tracks, path)
    card, cpu = Pipeline(device="cuda"), Pipeline(device="cpu")
    before = v8_score_fused.launches
    for source in (path, tracks):
        got = card.fluor_counts(source, 30000.0, 0.2)
        assert got == cpu.fluor_counts(source, 30000.0, 0.2)
        assert got[1] == 3000 and got[2] < 150
    assert v8_score_fused.launches == before + 2
    got = card.fluor_counts_calibrated(path, max_possible=3)
    assert got == cpu.fluor_counts_calibrated(path, max_possible=3)
    assert v8_score_fused.launches == before + 4


def _mc_inputs(dev, K, n_iter, seed):
    """Normalised patches of a planted field and sampled 6-vectors, with
    the edge cases of the g++ test: a constant patch, a NaN pixel, exact
    ties (samples that differ only in sigma_w) and sigma_h = 0."""
    from fluorosequencingimageanalysis_torch.ops import mc_fit
    rng = np.random.default_rng(seed)
    img = _planted(1, 256, 256, seed)[0]
    hs = torch.from_numpy(rng.integers(2, 254, K).astype(np.int32))
    ws = torch.from_numpy(rng.integers(2, 254, K).astype(np.int32))
    patches = mc_fit.normalise_patches(gather_patches(img, hs, ws))
    z = torch.from_numpy(rng.normal(size=(6, n_iter, K)).astype(np.float32))
    samples = mc_fit.sample_params(patches, z).contiguous()
    if K > 12 and n_iter > 3:
        patches[0] = 0.0
        patches[1, 2, 2] = float("nan")
        samples[:5, :, 5:9] = samples[:5, :1, 5:9]
        samples[4, 0, 9:11] = 0.0
    return patches.to(dev), samples.to(dev)


@pytest.mark.parametrize("K,n_iter", [(8192, 64), (4096, 200), (100, 37),
                                      (1, 5)])
def test_kernel_d_matches_twin(dev, K, n_iter):
    """-fmad=false, pixel-order sums, correctly rounded quotients and the
    card's expf on both sides: the best 6-vector and norm bit for bit."""
    from fluorosequencingimageanalysis_torch.ops.fused_mc_fit import mc_fit
    from fluorosequencingimageanalysis_torch.ops.mc_fit import mc_fit_plain
    patches, samples = _mc_inputs(dev, K, n_iter, seed=K)
    before = mc_fit.launches
    got = mc_fit(patches, samples)
    torch.cuda.synchronize()
    assert mc_fit.launches == before + 1
    want = mc_fit_plain(patches, samples)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    if K > 12:
        assert torch.isinf(got[1][1]) and torch.equal(got[0][5:9, 5],
                                                      samples[5, 0, 5:9])


def test_kernel_d_rejects_what_it_does_not_take(dev):
    from fluorosequencingimageanalysis_torch.ops.fused_mc_fit import mc_fit
    patches, samples = _mc_inputs(dev, 64, 8, seed=0)
    with pytest.raises(TypeError, match="float32"):
        mc_fit(patches.double(), samples.double())
    with pytest.raises(ValueError, match="share a device"):
        mc_fit(patches, samples.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mc_fit(patches, samples.transpose(1, 2).contiguous().transpose(1, 2))


def test_mc_detector_on_the_card_matches_cpu(dev):
    """find_peptides(fit_type="monte_carlo") on the card: kernels A and D
    run; on the same draws the card's candidates and keep mask equal the
    CPU's (exp of the card and the CPU can split near-tied samples: each
    different winner is a tie)."""
    from fluorosequencingimageanalysis_torch.models import detect
    from fluorosequencingimageanalysis_torch.ops.fused_mc_fit import mc_fit
    img = _planted(1, 256, 256, seed=7)[0]
    z = torch.randn((6, 300, 1024), generator=torch.Generator().manual_seed(
        0))
    kw = dict(max_candidates=1024, n_iter=300, normals=z)
    a0, d0 = candidate_map_fused.launches, mc_fit.launches
    card = detect._detect_and_fit_monte_carlo(img.to(dev), **kw)
    torch.cuda.synchronize()
    assert (candidate_map_fused.launches, mc_fit.launches) == (a0 + 1,
                                                               d0 + 1)
    cpu = detect._detect_and_fit_monte_carlo(img, **kw)
    for f in ("cand_h", "cand_w", "cand_valid", "cand_count"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    close = torch.isclose(card.params.cpu(), cpu.params, rtol=1e-5,
                          atol=1e-5).all(dim=1)
    assert close[cpu.cand_valid].float().mean() > 0.98
    assert (card.keep.cpu() == cpu.keep).float().mean() > 0.99
    psfs = detect.find_peptides(img.numpy(), fit_type="monte_carlo",
                                N_iter=100, max_candidates=512)
    assert len(psfs) > 10
    assert mc_fit.launches == d0 + 2


def test_simulation_on_the_card_matches_cpu(dev, monkeypatch):
    """On identical draws (made on the host) the card's counts, loss cycles
    and duds equal the CPU's; photometries agree to an ulp of the exponent;
    the chained fit runs kernel C and counts every molecule."""
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    from fluorosequencingimageanalysis_torch.sim import dye_sim
    seq, params = "ACKDYECAGKHSECAMKR", dict(p=0.9, b=0.105, u=0.5, s=0.3,
                                              sc=4, s2=0.1)
    N = 20_000
    kw = dict(num_mocks=3, num_edmans=8, num_simulations=N, beta=70000.0,
              beta_sigma=0.2, ddif=[0.0] + [0.3] * 6, **params)
    host_sim, host_normals = dye_sim.draw_simulation, dye_sim.draw_normals
    out = {}
    with monkeypatch.context() as m:
        m.setattr(dye_sim, "draw_simulation", lambda n, L, C, seed, device: (
            dye_sim.SimDraws(*(t.to(device) for t in host_sim(
                n, L, C, seed, "cpu")))))
        m.setattr(dye_sim, "draw_normals", lambda shape, seed, device: (
            host_normals(shape, seed, "cpu").to(device)))
        for where in ("cuda", "cpu"):
            out[where] = dye_sim.peptide_simulation_batched(
                seq, {"C", "K"}, device=where, **kw)
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g[:3] == w[:3]
        for label in w[3]:
            assert g[3][label][0] == w[3][label][0]
            np.testing.assert_allclose(g[3][label][1][0], w[3][label][1][0],
                                       rtol=2e-6)
    before = v8_score_fused.launches
    fit = dye_sim.simulate_and_fit_batched(seq, {"K"}, seed=1, **kw)
    torch.cuda.synchronize()
    assert v8_score_fused.launches == before + 1
    assert sum(fit["signals"].values()) + fit["none_count"] == N


def _em_inputs(dev, sizes, ks, n_init, seed):
    """Standardised, padded (G, N) mixtures of well-separated clusters (a
    group of each size in ``sizes``) and the JAX package's restart starts,
    on ``dev``."""
    from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
    rng = np.random.default_rng(seed)
    groups = []
    for n in sizes:
        centres = np.arange(4) * 10.0 + rng.normal(0, 1, 4)
        groups.append(rng.normal(centres[rng.integers(0, 4, n)],
                                 rng.uniform(0.5, 1.0)))
    N = -(-max(sizes) // 2048) * 2048
    z = np.zeros((len(sizes), N), np.float32)
    for g, x in enumerate(groups):
        if x.size:  # a group of one point standardises to 0
            z[g, :x.size] = (x - x.mean()) / max(x.std(), 1e-12)
    counts = np.array(sizes, np.int32)
    starts = gb._init_params([z[g] for g in range(len(sizes))], counts, ks,
                             n_init, max(ks), np.random.default_rng(seed))
    return [torch.from_numpy(a).to(dev) for a in (z, counts, *starts)]


@pytest.mark.parametrize("sizes,ks,n_init,permute", [
    ((1000, 777, 50), [1], 4, False),            # K = 1, ragged N
    ((5000, 3001), [2, 3, 4], 3, False),         # ragged, several ks
    ((20000,) * 12, [2, 3, 4, 5, 6], 10, False),  # the smoke's model count
    ((3000, 1, 2500), [2, 3, 8], 3, True),       # K = 8, a group of 1 point,
    # the models shuffled and each model's components too (masks that are
    # not prefixes)
    ((2000, 0, 1500), [2, 3], 2, False),         # a group of no point
    ((4000,) * 40, [2, 3, 4, 5, 6], 10, False)])  # 40 groups: more
# clusters than the card holds at once, blocks with room to spare
def test_kernel_e_matches_twin(dev, sizes, ks, n_init, permute):
    """Three EM rounds: per model the log-likelihood within 1e-5 relative,
    means and weights within 1e-3, variances within 1e-3 relative (or
    1e-5 of mu^2 + var); the sums run in another order than the twin's.
    A hundred rounds: the BIC-selected k of every group equal and each
    (group, k)'s best log-likelihood within 1e-3 relative; a restart may
    differ only where the twin's own likelihoods of the two tie within
    1e-3 (the float32 EM's restarts end that close after 100 unconverged
    rounds, in the JAX package as here). Two launches repeat bit for bit.
    Outputs come back in the order of the starts, however the kernel
    groups the models. A group of no point has no fit: the kernel leaves
    its log-likelihoods 0 and its weights 0/0 (NaN), and the twin's
    weights are NaN too.
    """
    from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import gmm_em
    z, counts, w0, mu0, var0, mask = _em_inputs(dev, sizes, ks, n_init,
                                                 seed=len(sizes))
    G, B, K = w0.shape
    back = None
    if permute:
        rng = np.random.default_rng(5)
        order = torch.from_numpy(rng.permutation(B)).to(dev)
        comp = torch.from_numpy(np.stack([rng.permutation(K)
                                          for _ in range(B)])).to(dev)
        idx = comp[order][None].expand(G, B, K)
        w0, mu0, var0, mask = (t[:, order].gather(2, idx).contiguous()
                               for t in (w0, mu0, var0, mask))
        assert not all(bool(m[:m.sum()].all()) for m in mask.reshape(-1, K))
        back = (torch.argsort(order), torch.argsort(comp, dim=1))

    def unpermute(out):
        """The outputs in the (group, k, restart) order of _em_inputs."""
        if back is None:
            return out
        inv_b, inv_k = back
        w, mu, var, ll = (t[:, inv_b] for t in out)
        idx = inv_k[None].expand(G, B, K)
        return (*(t.gather(2, idx) for t in (w, mu, var)), ll)

    valid = (torch.arange(z.shape[1], device=dev)[None, :]
             < counts[:, None].long()).float()
    live = np.array(sizes) > 0
    before = gmm_em.launches
    got = gmm_em(z, counts, w0, mu0, var0, mask, 3, 1e-6)
    torch.cuda.synchronize()
    assert gmm_em.launches == before + 1
    want = gb._em_plain(z, valid, w0, mu0, var0, mask, 3, 1e-6)
    g, w = ([t.double().cpu().numpy() for t in r] for r in (got, want))
    act = mask.cpu().numpy()
    if not live.all():
        empty = ~live
        assert (g[3][empty] == 0).all()
        assert np.isnan(g[0][empty][act[empty]]).all()
        assert np.isnan(w[0][empty][act[empty]]).all()
        g, w = ([a[live] for a in r] for r in (g, w))
        act = act[live]
    assert (np.abs(g[3] - w[3]) <= 1e-5 * np.abs(w[3])).all()
    assert (np.abs(g[1] - w[1])[act] <= 1e-3).all()
    assert (np.abs(g[0] - w[0]) <= 1e-3).all()
    assert (np.abs(g[2] - w[2])[act] <= np.maximum(
        1e-3 * w[2], 1e-5 * (w[1] ** 2 + w[2]))[act]).all()
    assert (g[0][~act] == 0).all() and (g[2][~act] == 1).all()

    got = gmm_em(z, counts, w0, mu0, var0, mask, 100, 1e-6)
    again = gmm_em(z, counts, w0, mu0, var0, mask, 100, 1e-6)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again))
    want = gb._em_plain(z, valid, w0, mu0, var0, mask, 100, 1e-6)
    got, want = unpermute(got), unpermute(want)
    J = len(ks)
    ll_g, ll_w = (r[3].double().cpu().numpy().reshape(G, J, n_init)[live]
                  for r in (got, want))
    best_g, best_w = ll_g.max(-1), ll_w.max(-1)
    assert (np.abs(best_g - best_w) <= 1e-3 * np.abs(best_w)).all()
    pen = (np.array([3 * k - 1 for k in ks]) *
           np.log(np.array(sizes)[live])[:, None])
    assert ((-2 * best_g + pen).argmin(1) ==
            (-2 * best_w + pen).argmin(1)).all()
    pick = ll_g.argmax(-1)
    twin_of_pick = np.take_along_axis(ll_w, pick[..., None], -1)[..., 0]
    assert (np.abs(twin_of_pick - best_w) <= 1e-3 * np.abs(best_w)).all()


def test_kernel_e_rejects_what_it_does_not_take(dev):
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import gmm_em
    z, counts, w0, mu0, var0, mask = _em_inputs(dev, (100, 90), [2, 3], 2,
                                                 seed=0)
    with pytest.raises(TypeError, match="float32"):
        gmm_em(z.double(), counts, w0, mu0, var0, mask, 1, 1e-6)
    with pytest.raises(TypeError, match="int32"):
        gmm_em(z, counts.long(), w0, mu0, var0, mask, 1, 1e-6)
    with pytest.raises(ValueError, match="one device"):
        gmm_em(z, counts.cpu(), w0, mu0, var0, mask, 1, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_em(z, counts, w0.transpose(0, 1).contiguous().transpose(0, 1),
               mu0, var0, mask, 1, 1e-6)
    big = [torch.cat([t] + [t[..., :1]] * 254, dim=2)  # K = 257
           for t in (w0, mu0, var0, mask)]
    with pytest.raises(ValueError, match="1 to 256"):
        gmm_em(z, counts, *big, 1, 1e-6)


@pytest.mark.parametrize("sizes,ks,n_init,permute", [
    ((3000, 2000, 777), [2, 9], 3, False),       # K = 9, the smallest
    ((2500, 1200), [5, 17], 2, True),            # K = 17, shuffled masks
    ((4096, 1), [3, 33], 2, False)])             # K = 33, a group of 1 point
def test_kernel_e_shared_memory_form_matches_twin(dev, sizes, ks, n_init,
                                                  permute):
    """K above the register form's 8: three EM rounds of the shared-memory
    form, held to the twin at test_kernel_e_matches_twin's tolerances."""
    from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import (
        KREG, gmm_em)
    z, counts, w0, mu0, var0, mask = _em_inputs(dev, sizes, ks, n_init,
                                                 seed=len(sizes) + 7)
    G, B, K = w0.shape
    assert K > KREG
    if permute:
        rng = np.random.default_rng(9)
        comp = torch.from_numpy(np.stack([rng.permutation(K)
                                          for _ in range(B)])).to(dev)
        idx = comp[None].expand(G, B, K)
        w0, mu0, var0, mask = (t.gather(2, idx).contiguous()
                               for t in (w0, mu0, var0, mask))
    valid = (torch.arange(z.shape[1], device=dev)[None, :]
             < counts[:, None].long()).float()
    before = gmm_em.launches
    got = gmm_em(z, counts, w0, mu0, var0, mask, 3, 1e-6)
    again = gmm_em(z, counts, w0, mu0, var0, mask, 3, 1e-6)
    torch.cuda.synchronize()
    assert gmm_em.launches == before + 2
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again))
    want = gb._em_plain(z, valid, w0, mu0, var0, mask, 3, 1e-6)
    g, w = ([t.double().cpu().numpy() for t in r] for r in (got, want))
    act = mask.cpu().numpy()
    assert (np.abs(g[3] - w[3]) <= 1e-5 * np.abs(w[3])).all()
    assert (np.abs(g[1] - w[1])[act] <= 1e-3).all()
    assert (np.abs(g[0] - w[0]) <= 1e-3).all()
    assert (np.abs(g[2] - w[2])[act] <= np.maximum(
        1e-3 * w[2], 1e-5 * (w[1] ** 2 + w[2]))[act]).all()
    assert (g[0][~act] == 0).all() and (g[2][~act] == 1).all()


def test_kernel_e_takes_every_k_and_b_without_the_twin(dev, monkeypatch):
    """Fault F1: per_cycle_gmm(max_fluors=8) (K = 9) and gmm_fit_batched
    over 4,200 models (> BMAX, two launches) run on the card with the twin
    patched to raise, and pick the CPU twin's k; 50 models in two slices
    equal one launch bit for bit."""
    from fluorosequencingimageanalysis_torch.ops import fused_gmm_em
    from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_gmm_photometries)
    twin = gb._em_plain

    def refuse(*a, **k):
        raise AssertionError("the twin ran for a card call")

    phot = make_gmm_photometries(3000, F=4, seed=3)
    rng = np.random.default_rng(4)
    group = [np.concatenate([rng.normal(0, 1, 2000),
                             rng.normal(8, 1, 1000)])]
    z, counts, w0, mu0, var0, mask = _em_inputs(dev, (3000,), [2, 3, 4],
                                                 17, seed=5)
    with monkeypatch.context() as m:
        m.setattr(fused_gmm_em, "_em_plain", refuse)
        m.setattr(gb, "_em_plain", refuse)
        before = fused_gmm_em.gmm_em.launches
        card = Pipeline(device="cuda").per_cycle_gmm(phot, max_fluors=8)
        assert fused_gmm_em.gmm_em.launches == before + 1
        big = gb.gmm_fit_batched(group, [2, 3], n_init=2100, n_iter=20,
                                 device="cuda")
        assert fused_gmm_em.gmm_em.launches == before + 3
        one = gb.em_in_slices(z, counts, w0, mu0, var0, mask, 20, 1e-6)
        m.setattr(fused_gmm_em, "BMAX", 26)
        two = gb.em_in_slices(z, counts, w0, mu0, var0, mask, 20, 1e-6)
        torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(one, two))
    assert gb._em_plain is twin
    cpu = Pipeline(device="cpu").per_cycle_gmm(phot, max_fluors=8)
    for cycle in range(4):
        assert card[0][cycle][1] == cpu[0][cycle][1]
    small = gb.gmm_fit_batched(group, [2, 3], n_init=2100, n_iter=20,
                               device="cpu")
    assert (big["bic"].argmin(1) == small["bic"].argmin(1)).all()
    np.testing.assert_allclose(big["loglik"], small["loglik"], rtol=1e-3)


def test_mixture_fitters_on_the_card_match_cpu(dev):
    """per_cycle_gmm through kernel E picks the CPU twin's k in every cycle;
    the float64 device scorer and the device chi-squared engine give the
    CPU's selections and plateaus."""
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import gmm_em
    from fluorosequencingimageanalysis_torch.ops.plateau_batch import (
        plateau_fit_batched)
    from fluorosequencingimageanalysis_torch.stepfitting import (
        chi_squared_fit_batch)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_chisq_traces, make_gmm_photometries)
    phot = make_gmm_photometries(2000, F=6, seed=1)
    before = gmm_em.launches
    card = Pipeline(device="cuda").per_cycle_gmm(phot, max_fluors=4)
    assert gmm_em.launches == before + 1
    cpu = Pipeline(device="cpu").per_cycle_gmm(phot, max_fluors=4)
    for cycle in range(6):
        assert card[0][cycle][1] == cpu[0][cycle][1]
        assert card[0][cycle][2] == pytest.approx(cpu[0][cycle][2],
                                                  rel=1e-3)
    x = np.array([v[1] for v in phot["ch1"][0].values()])[:500]
    on_card = plateau_fit_batched(x, 3, scores="device")
    on_cpu = plateau_fit_batched(x, 3, scores="device", device="cpu")
    assert [f for f, _ in on_card] == [f for f, _ in on_cpu]
    np.testing.assert_allclose([r for _, r in on_card],
                               [r for _, r in on_cpu], rtol=0, atol=1e-12)
    traces = make_chisq_traces(256, 60, seed=2)
    assert chi_squared_fit_batch(traces, num_steps=8, engine="device") == \
        chi_squared_fit_batch(traces, num_steps=8, engine="native")


@pytest.mark.parametrize("cov_type", ["full", "tied", "diag", "spherical"])
def test_mixture_estimators_on_the_card_match_cpu(dev, cov_type):
    """The port's KMeans (ops/kmeans.py) and GaussianMixture and
    BayesianGaussianMixture (ops/mixture.py) on the card against the CPU
    from the same random state: labels, n_iter and the state equal;
    parameters within rtol 1e-9 (components in mean order)."""
    from fluorosequencingimageanalysis_torch.ops.kmeans import (
        kmeans_batched)
    from fluorosequencingimageanalysis_torch.ops.mixture import (
        BayesianGaussianMixture, GaussianMixture)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_v8_workload)
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(m, 300, 700) for m in
                        (2000, 30000, 61000)]).reshape(-1, 1)
    traces = np.rint(make_v8_workload(400, seed=4)[0])
    out = {}
    for d in ("cuda", "cpu"):
        np.random.seed(5)
        g = GaussianMixture(4, covariance_type=cov_type, n_init=4,
                            device=d).fit(x)
        b = BayesianGaussianMixture(n_components=3,
                                    covariance_type=cov_type,
                                    device=d).fit(x)
        k = kmeans_batched(traces, 4, 10, device=d)
        s = np.random.get_state()
        out[d] = (g, b, k, s[1].copy(), s[2])
    (g1, b1, k1, s1, p1), (g2, b2, k2, s2, p2) = out["cuda"], out["cpu"]
    assert np.array_equal(s1, s2) and p1 == p2
    for name in ("labels", "n_iter", "n_distinct"):
        assert np.array_equal(k1[name], k2[name]), name
    np.testing.assert_allclose(k1["centers"], k2["centers"], rtol=1e-9)
    np.testing.assert_allclose(k1["inertia"], k2["inertia"], rtol=1e-9)
    for a, c in ((g1, g2), (b1, b2)):
        assert a.n_iter_ == c.n_iter_ and a.converged_ == c.converged_
        oa, oc = np.argsort(a.means_[:, 0]), np.argsort(c.means_[:, 0])
        np.testing.assert_allclose(a.means_[oa], c.means_[oc], rtol=1e-9)
        np.testing.assert_allclose(a.weights_[oa], c.weights_[oc],
                                   rtol=1e-9)
        np.testing.assert_allclose(a.lower_bound_, c.lower_bound_,
                                   rtol=1e-9)
    np.testing.assert_allclose(g1.bic(x), g2.bic(x), rtol=1e-9)


def test_class_path_on_the_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The object layer's class path (detection through kernels A and B,
    registration, tracking, the batched photometry, the track CSV) with
    the card as the default device against the same path with the CPU's,
    on 2 fields x 4 cycles of 128^2: equal keys, categories and order,
    photometry within the card-vs-CPU bound of chip_smoke.py, and each
    field's detection launched A and B once."""
    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch.tools.class_path import (
        class_path, read_rows)
    monkeypatch.setattr(_device, "_DEFAULT", None)
    stack = np.clip(make_experiment_stack(2, 4, 128, 128,
                                          spots_per_field=30, seed=0),
                    0, 65535).astype(np.uint16)
    _device.set_default_device("cuda")
    a0, b0 = candidate_map_fused.launches, fit_quality.launches
    class_path(stack, tmp_path / "card.csv", max_candidates=512,
               sync=torch.cuda.synchronize)
    assert candidate_map_fused.launches - a0 == 2
    assert fit_quality.launches - b0 == 2
    _device.set_default_device("cpu")
    class_path(stack, tmp_path / "cpu.csv", max_candidates=512)
    assert candidate_map_fused.launches - a0 == 2  # the CPU takes twins
    header, card = read_rows(tmp_path / "card.csv")
    assert read_rows(tmp_path / "cpu.csv")[0] == header
    cpu = read_rows(tmp_path / "cpu.csv")[1]
    assert len(card) == len(cpu) > 20
    for i, (g, c) in enumerate(zip(card, cpu)):
        assert g[:5] == c[:5], (i, g[:5], c[:5])
        np.testing.assert_allclose([float(x) for x in g[5:]],
                                   [float(x) for x in c[5:]],
                                   rtol=1e-4, atol=5e-2, err_msg=f"row {i}")


def test_span_device_time_lies_within_the_host_window(dev):
    """Traced spans on the card: each device span of a z-stack call and of
    an experiment call reads a positive ``device_total`` (CUDA events,
    resolved when ``timings()`` is read), and each call's device spans
    together take no longer than the call's host wall; the host-clock
    spans (the fetch waits, the pinned copy) read no device time."""
    import time

    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import make_zstack

    pipe = Pipeline(PipelineConfig(detect=DetectConfig(max_candidates=1024)),
                    device=dev, profile=True)
    frames = make_zstack(16, 256, 256, n_spots=150, seed=1)
    fields = np.clip(make_experiment_stack(8, 4, 256, 256,
                                           spots_per_field=150, seed=2),
                     0, 65535).astype(np.uint16)
    calls = {
        "zstack": (lambda: pipe.run_zstack(frames, lean=True, max_spots=512),
                   ("api/zstack/background", "api/detect/candidates",
                    "api/detect/consolidate")),
        "experiment": (lambda: pipe.run_experiment(fields,
                                                   max_candidates=1024),
                       ("api/step/registration", "api/detect/candidates",
                        "api/detect/consolidate", "api/step/photometry"))}
    for name, (call, spans) in calls.items():
        call()                      # warm-up: builds, plans, allocator
        torch.cuda.synchronize()
        profiling.reset_timings()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = profiling.timings()
        device = [t[s]["device_total"] for s in spans]
        assert all(d > 0 for d in device), (name, device)
        assert sum(device) <= wall, (name, device, wall)
        assert t["api/fetch_wait"]["count"] >= 1
        assert "device_total" not in t["api/fetch_wait"]
        assert t["api/upload/pin"]["count"] == 1   # host frames: one copy
    profiling.reset_timings()


def _kernel_f_against_twin(dev, ch, cw, r2, valid, radius, cand=None):
    """Kernel F and the plain twin on the card: the keep masks and the
    rounds (the launch's largest, the twin's over one group of all the
    images) must be equal; the kernel is one launch, and none (no count)
    where there is no fit slot. Returns the mask."""
    from fluorosequencingimageanalysis_torch.ops import consolidate as cons
    from fluorosequencingimageanalysis_torch.utils import profiling

    args = [torch.as_tensor(a).to(dev) for a in (ch, cw, r2, valid)]
    extra = [torch.as_tensor(a).to(dev) for a in (cand or ())]
    B, n = args[0].shape
    group = max(1, cons._MAX_PAIRS // max(n * n, 1))
    parts = [cons._consolidate_group(*[a[lo:lo + group] for a in args],
                                     radius,
                                     *[a[lo:lo + group] for a in extra])
             for lo in range(0, B, group)]
    want = torch.cat([k for k, _ in parts])
    want_rounds = max(r for _, r in parts)
    profiling.reset_counters()
    before = cons.consolidate.launches
    with profiling.tracing():
        got = cons.consolidate(*args, radius, *extra)
    c = profiling.counters()
    profiling.reset_counters()
    launched = int(B * n > 0)
    assert cons.consolidate.launches == before + launched
    assert c.get("detect/consolidate_launches", 0) == launched
    assert torch.equal(got, want)
    assert c.get("detect/consolidate_rounds", 0) == want_rounds
    return got


@pytest.mark.parametrize("name", nms_cases.NAMES)
def test_kernel_f_matches_twin_on_every_case(dev, name):
    """Chains, NaN R^2 and ties, d2 == radius^2 exactly, centers outside
    the image and non-finite, every fit in one cell, no valid fit, N not a
    multiple of the block, the Monte-Carlo window gate, radii whose squares
    underflow or overflow, images with no fit slot (tests/nms_cases.py)."""
    ch, cw, r2, valid, radius, cand = nms_cases.case(name)
    _kernel_f_against_twin(dev, ch, cw, r2, valid, radius, cand)


def test_kernel_f_matches_twin_at_the_paths_shapes(dev):
    """A sequencing group's 96 x 4,096 candidates (8 fields x 12 cycles of
    the dense cell's 2,000 spots a field; every image fills the bucket)
    and a z-stack group's 8 x 8,192 (config 2, ~6,800 candidates a frame),
    each fitted by kernel B and gated at R^2 0.7 as detect_and_fit_batch
    does: the keep masks bit for bit and the rounds equal."""
    from fluorosequencingimageanalysis_torch.ops.background import (
        subtract_background_stack)
    from fluorosequencingimageanalysis_torch.utils.synth import make_zstack
    seq = torch.from_numpy(make_experiment_stack(
        8, 12, 512, 512, spots_per_field=2000, seed=3).reshape(96, 512, 512))
    for images, k in ((seq.to(dev), 4096),
                      (subtract_background_stack(make_zstack(8), device=dev),
                       8192)):
        hs, ws, valid, _ = find_candidates_batch(images, max_candidates=k)
        fq = fit_quality(images, hs, ws, 60, 1)
        passed = valid & ~(fq[4] < 0.7)
        keep = _kernel_f_against_twin(dev, fq[1], fq[2], fq[4], passed, 4.0)
        assert int(keep.sum()) > images.shape[0] * 300


def test_kernel_f_rejects_what_it_does_not_take(dev):
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    x = torch.zeros((2, 64), device=dev)
    v = torch.ones((2, 64), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="float32"):
        consolidate(x.double(), x.double(), x.double(), v)
    with pytest.raises(TypeError, match="bool valid"):
        consolidate(x, x, x, v.to(torch.uint8))
    with pytest.raises(ValueError, match="one \\(..., N\\) shape"):
        consolidate(x, x[:, :32], x, v)
    with pytest.raises(ValueError, match="share a device"):
        consolidate(x, x.cpu(), x, v)
    with pytest.raises(ValueError, match="both cand_h and cand_w"):
        consolidate(x, x, x, v, 4.0, x)
