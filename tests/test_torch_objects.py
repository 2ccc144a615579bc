"""Port parity: the object layer (``Spot``, ``Image``, tracking, the
experiment classes) vs the JAX package's.

The same numpy-seeded inputs go through the JAX package's objects and the
port's with the process default device set to the CPU. Integer outputs,
keys, categories, counts and row order must be equal exactly. Photometries
are float32 sums taken in another order on each side and are held at the
bound of tests/test_fast_experiment.py (rtol 1e-5, atol 1e-2); step fits
and offsets are float64 and held equal. The slice as a whole: the class
path (detection, ``Image``/``Spot``, ``SequenceExperiment``, the CSV
emitter) of each package on the same stack, and the port's class path
against its own ``Pipeline(device="cpu").run_experiment``.
"""

import ast
import csv
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fast_experiment import class_path_rows as jax_class_path_rows
from test_fast_experiment import make_stack
from test_tracking_differential import (_assert_same_traces,
                                        _random_field_movie)
from tracking_oracle import greedy_particle_tracking_oracle

from fluorosequencingimageanalysis_tpu import batch as jax_batch
from fluorosequencingimageanalysis_tpu.models.detect import (
    find_peptides_batch as jax_find_peptides_batch)
from fluorosequencingimageanalysis_tpu.ops import photometry as jax_phot
from fluorosequencingimageanalysis_tpu.ops import registration as jax_reg
from fluorosequencingimageanalysis_tpu.pipeline import (
    experiment as jax_experiment, spots as jax_spots,
    tracking as jax_tracking)

from fluorosequencingimageanalysis_torch import _device
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.ops import photometry as port_phot
from fluorosequencingimageanalysis_torch.ops import registration as port_reg
from fluorosequencingimageanalysis_torch.pipeline import (
    experiment as port_experiment, spots as port_spots,
    tracking as port_tracking)
from fluorosequencingimageanalysis_torch.tools.class_path import (
    STAGES, class_path, read_rows)

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

PHOT_RTOL, PHOT_ATOL = 1e-5, 1e-2  # test_fast_experiment.py:140-147
MC = 512


class _Pkg:
    def __init__(self, spots, tracking, experiment):
        self.spots, self.tracking, self.experiment = (spots, tracking,
                                                      experiment)


JAX = _Pkg(jax_spots, jax_tracking, jax_experiment)
PORT = _Pkg(port_spots, port_tracking, port_experiment)


@pytest.fixture(autouse=True)
def _cpu_default(monkeypatch):
    """The object layer on the CPU, as a user names it; restored after."""
    monkeypatch.setattr(_device, "_DEFAULT", None)
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def stack():
    return make_stack(F=2, C=4, seed=0)


@pytest.fixture(scope="module")
def jax_psfs(stack):
    """The JAX package's detections, fed to both object layers where a
    test isolates the object layer from detection."""
    return [jax_find_peptides_batch(stack[f], max_candidates=MC,
                                    num_iters=60)
            for f in range(stack.shape[0])]


def _mfmc(pkg, stack, psfs):
    """The class path of ``pkg`` from per-field psfs lists (the loop of
    test_fast_experiment.class_path_rows)."""
    fields = []
    for f in range(stack.shape[0]):
        images = []
        for c in range(stack.shape[1]):
            img = pkg.spots.Image(image=stack[f, c],
                                  metadata={"filepath": f"mem://{f}/{c}"},
                                  spots=None)
            spots = []
            for (h, w), gf in psfs[f][c].items():
                try:
                    spots.append(pkg.spots.Spot(
                        img, int(pkg.tracking._py2_round(h)),
                        int(pkg.tracking._py2_round(w)), 5,
                        gaussian_fit=gf))
                except Exception:
                    pass
            img.spots = spots
            images.append(img)
        ex = pkg.experiment.SequenceExperiment(images,
                                               alignment_frames=images)
        ex.offsets_from_frames()
        fields.append(pkg.experiment.MultichannelSequenceExperiment(
            {"ch1": ex}))
    mfmc = pkg.experiment.MultifieldMultichannelSequenceExperiment(fields)
    mfmc.trace_existing_spots()
    return mfmc


def _csv_rows(mfmc, path, **kw):
    n = mfmc.track_photometries_as_csv(str(path), **kw)
    with open(path) as fh:
        rows = list(csv.reader(fh))
    assert n == len(rows) - 1
    return rows


def _assert_rows_match(got, want):
    """Header, keys, categories and order equal; values within bound."""
    assert got[0] == want[0]
    assert len(got) == len(want) > 1
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        assert a[:5] == b[:5], (i, a[:5], b[:5])
        assert len(a) == len(b)
        np.testing.assert_allclose([float(x) for x in a[5:]],
                                   [float(x) for x in b[5:]],
                                   rtol=PHOT_RTOL, atol=PHOT_ATOL,
                                   err_msg=f"row {i}")


def _trace_keys(traces):
    return [tuple(None if s is None else (s.h, s.w) for s in t)
            for t in traces]


# -- the slice as a whole ---------------------------------------------------

def _port_class_path_rows(stack, tmp_path):
    path = tmp_path / "port.csv"
    mfmc, seconds = class_path(stack, path, max_candidates=MC)
    assert sorted(seconds) == sorted(STAGES + ("photometry",))
    assert 0 < seconds["photometry"] <= seconds["discard"] + seconds["csv"]
    header, rows = read_rows(path)
    return [header] + rows


def test_class_path_matches_jax_class_path_and_run_experiment(stack,
                                                              tmp_path):
    rows = _port_class_path_rows(stack, tmp_path)
    header, ref = jax_class_path_rows(stack, max_candidates=MC)
    _assert_rows_match(rows, [header] + ref)

    res = Pipeline(device="cpu").run_experiment(stack, max_candidates=MC,
                                                max_spots=256)
    assert len(res["rows"]) == len(rows) - 1
    for i, ((ch, f, h, w, cat, ph), row) in enumerate(
            zip(res["rows"], rows[1:])):
        assert [str(ch), str(f), str(h), str(w), str(cat)] == row[:5], i
        np.testing.assert_allclose(ph, [float(x) for x in row[5:]],
                                   rtol=PHOT_RTOL, atol=PHOT_ATOL,
                                   err_msg=f"row {i}")
    cats = {r[4] for r in rows[1:]}
    assert len(cats) > 2  # gaps, head holes and tail holes are exercised


# -- the experiment classes, from the same detections ----------------------

@pytest.mark.parametrize("method,save_averages", [
    ("mexican_hat", True), ("simple", False), ("maximum", False),
    ("gaussian_volume", False), ("sigmas", False), ("sextractor", False)])
def test_track_photometries_csv_of_every_method(stack, jax_psfs, tmp_path,
                                                method, save_averages):
    out = []
    for pkg in (JAX, PORT):
        mfmc = _mfmc(pkg, stack, jax_psfs)
        mfmc.discard_invalid_traces(photometry_method=method)
        out.append(_csv_rows(mfmc, tmp_path / "t.csv",
                             photometry_method=method,
                             save_averages=save_averages))
    _assert_rows_match(out[1], out[0])


def test_counts_offsets_and_emitters_match_jax(stack, jax_psfs, tmp_path):
    m = {name: _mfmc(pkg, stack, jax_psfs)
         for name, pkg in (("jax", JAX), ("port", PORT))}
    j, p = m["jax"], m["port"]
    for fn in ("get_offsets", "get_offsets_by_frame", "offsets_as_string",
               "spot_count", "trace_count", "singleton_count",
               "count_discarded_spots", "count_remainders",
               "filtered_binary_trace_category_counts"):
        assert getattr(p, fn)() == getattr(j, fn)(), fn
    assert p.count_binary_trace_categories()[0] == \
        j.count_binary_trace_categories()[0]
    for collate in (False, True):
        assert p.category_counts_as_string(collate_fields=collate) == \
            j.category_counts_as_string(collate_fields=collate)
        texts = []
        for name, mf in m.items():
            path = tmp_path / f"{name}_{collate}.csv"
            mf.category_counts_as_csv(str(path), collate_fields=collate)
            texts.append(path.read_text())
        assert texts[0] == texts[1]
    # The offsets dict the reference's script pickles.
    dicts = []
    for name, mf in m.items():
        path = tmp_path / f"offsets_{name}.pkl"
        mf.save_offsets_as_dict(str(path))
        with open(path, "rb") as fh:
            dicts.append(pickle.load(fh))
    assert dicts[0] == dicts[1] and len(dicts[0]) == stack.shape[1]
    # Trace discards: the same traces dropped, the same filled positions.
    inv_j = j.discard_invalid_traces()
    inv_p = p.discard_invalid_traces()
    for a, b in zip(inv_p, inv_j):
        assert a.keys() == b.keys()
        for c in a:
            assert _trace_keys(a[c]) == _trace_keys(b[c])
    for exj, exp in zip(j.experimental_fields, p.experimental_fields):
        tj, tp = exj.channels["ch1"], exp.channels["ch1"]
        assert _trace_keys(tp.spot_traces) == _trace_keys(tj.spot_traces)
        for trj, trp in zip(tj.spot_traces, tp.spot_traces):
            assert _trace_keys([tp.fill_in_trace(trp)]) == \
                _trace_keys([tj.fill_in_trace(trj)])
    # extract_tracks samples with the random module.
    pattern = (True, True, True, True)
    random.seed(5)
    ej = j.extract_tracks(pattern, radius=3, number=4)
    random.seed(5)
    ep = p.extract_tracks(pattern, radius=3, number=4)
    assert ej.keys() == ep.keys()
    for c in ej:
        assert len(ej[c]) == len(ep[c]) > 0
        for ((hw_j, seq_j), (hw_p, seq_p)) in zip(ej[c], ep[c]):
            assert hw_j == hw_p
            for (sj, _), (sp, _) in zip(seq_j, seq_p):
                np.testing.assert_array_equal(sp, sj)


def test_mdma_and_remainder_qc_match_jax(stack, jax_psfs, tmp_path):
    rows, adjs, masks = [], [], []
    for pkg in (JAX, PORT):
        mfmc = _mfmc(pkg, stack, jax_psfs)
        mfmc.discard_invalid_traces()
        adjs.append(mfmc.multiplicative_delta_median_adjustments())
        masks.append(list(mfmc.remainder_threshold_fields(min_remainders=5)))
        rows.append(_csv_rows(
            mfmc, tmp_path / "m.csv", save_averages=False,
            ignore_invalid_fields=True,
            adjustment_function=pkg.experiment.SequenceExperiment
            .mdma_adjustment))
    assert masks[0] == masks[1]
    for a, b in zip(adjs[1], adjs[0]):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["ch1"], b["ch1"], rtol=1e-4, atol=1e-6)
    assert any(any(x != 0.0 for x in a["ch1"]) for a in adjs[1])
    _assert_rows_match(rows[1], rows[0])


def test_psfs_pickle_from_jax_loads_to_the_same_spots(stack, jax_psfs,
                                                      tmp_path):
    from PIL import Image as PILImage
    tif = str(tmp_path / "field.tif")
    PILImage.fromarray(np.clip(stack[0, 0], 0, 65535).astype(np.uint16),
                       mode="I;16").save(tif)
    jax_batch.save_psfs_pkl(jax_psfs[0][0], image_path=tif,
                            timestamp_epoch=1500000000)
    got, nd_p = port_experiment.Experiment.easy_load_processed_image(tif)
    want, nd_j = jax_experiment.Experiment.easy_load_processed_image(tif)
    assert nd_p == nd_j
    np.testing.assert_array_equal(got.image, want.image)
    assert len(got.spots) == len(want.spots) > 10
    for a, b in zip(got.spots, want.spots):
        assert (a.h, a.w, a.size) == (b.h, b.w, b.size)
        assert a.parent_Image is got
        for x, y in zip(a.gaussian_fit, b.gaussian_fit):
            np.testing.assert_array_equal(x, y)
        assert a.photometry() == pytest.approx(b.photometry(), rel=1e-5,
                                               abs=1e-2)


# -- Spot and Image ---------------------------------------------------------

def _even_image(seed=0, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    img = rng.normal(400, 8, shape)
    hh, ww = np.indices(shape).astype(float)
    for h, w in [(20.3, 20.6), (40.4, 45.2), (3.2, 4.1), (60.1, 31.0)]:
        img += 3000.0 * np.exp(-((hh - h) ** 2 + (ww - w) ** 2) / 3.4)
    return np.round(img).astype(np.uint16)


CENTERS = [(20, 21), (40, 45), (3, 4), (60, 31), (9, 9), (32, 54)]


@pytest.mark.parametrize("method,kw", [
    ("mexican_hat", {}), ("mexican_hat", {"brim_size": 3, "radius": 6}),
    ("simple", {}), ("maximum", {}), ("maximum", {"top": 3}),
    ("maximum", {"background_adjust": "additive", "top": 2}),
    ("maximum", {"top": 0}), ("gaussian_volume", {}), ("sigmas", {}),
    ("sextractor", {})])
def test_spot_photometry_of_every_method_matches_jax(method, kw):
    arr = _even_image()
    fit = (2.4, 2.6, 400.0, 3000.0, 1.2, 1.3, 0.0, None,
           np.zeros((5, 5)), 1.0, 0.9, 10.0)
    values = []
    for pkg in (JAX, PORT):
        img = pkg.spots.Image(image=arr, metadata={"filepath": "mem://0"})
        img.spots = [pkg.spots.Spot(img, h, w, 5, gaussian_fit=fit)
                     for h, w in CENTERS]
        img.spots.append(pkg.spots.Spot(img, 30, 12, 7))  # own size
        loose = pkg.spots.Spot(img, 50, 50, 5)  # not in img.spots
        values.append([s.photometry(method, **kw)
                       for s in img.spots + [loose]] +
                      [s.photometry(method, return_invalid=False, **kw)
                       for s in img.spots])
    assert [v is None for v in values[1]] == [v is None for v in values[0]]
    got = [v for v in values[1] if v is not None]
    want = [v for v in values[0] if v is not None]
    np.testing.assert_allclose(got, want, rtol=PHOT_RTOL, atol=PHOT_ATOL)


def test_median_adjust_takes_the_middle_pair_on_an_even_image():
    """An even pixel count: the median is the mean of the two middle
    values, as jnp.median's (torch.median returns the lower one)."""
    arr = np.random.default_rng(3).normal(400, 8, (64, 64)).astype(
        np.float32)
    hs, ws = np.array([10, 30, 50]), np.array([12, 33, 40])
    # The JAX function unjitted: its median_adjust is not a static
    # argument (its Spot calls maximum_host, never this batch form).
    want = np.asarray(jax_phot.maximum_batch.__wrapped__(
        jnp.asarray(arr), jnp.asarray(hs, jnp.int32),
        jnp.asarray(ws, jnp.int32), radius=5, top=2, median_adjust=True))
    got = port_phot.maximum_batch(torch.from_numpy(arr),
                                  torch.from_numpy(hs),
                                  torch.from_numpy(ws), radius=5, top=2,
                                  median_adjust=True).numpy()
    np.testing.assert_array_equal(got, want)
    lower = float(torch.from_numpy(arr).median())
    assert float(np.median(arr)) != lower  # the case that tells them apart
    top2 = np.sort(arr[5:16, 7:18].ravel())[-2:]
    assert got[0] == np.float32(np.sum(top2 - np.median(arr)))
    batch = np.stack([arr, arr[::-1].copy()])
    got_b = port_phot.maximum_batch(
        torch.from_numpy(batch), torch.from_numpy(np.stack([hs, hs])),
        torch.from_numpy(np.stack([ws, ws])), radius=5, top=2,
        median_adjust=True).numpy()
    np.testing.assert_array_equal(got_b[0], got)


def test_image_uploads_once_per_device_and_pickles_without_it():
    arr = _even_image()
    img = port_spots.Image(image=arr)
    img.spots = [port_spots.Spot(img, h, w, 5) for h, w in CENTERS]
    first = img.device_image()
    assert first.device.type == "cpu" and first.dtype == torch.float32
    img.spots[0].photometry("simple")
    img.spots[0].photometry("maximum", top=2)
    assert img.device_image() is first  # no second upload
    loaded = pickle.loads(pickle.dumps(img.spots[0]))
    assert "_device_images" not in loaded.parent_Image.__dict__
    img.image = arr.astype(np.float32) + 1  # another array: uploaded anew
    assert img.device_image() is not first
    img.photometry_cache_clear()
    assert img.spots[0].photometry("simple") == pytest.approx(
        float(arr[18:23, 19:24].sum()) + 25)


def test_photometry_cache_measures_only_the_spots_it_lacks(monkeypatch):
    """A spot appended after a measurement (an interpolated one) is
    measured alone, to the value a fresh image gives it; the spots already
    measured are not measured again."""
    arr = _even_image()
    img = port_spots.Image(image=arr)
    img.spots = [port_spots.Spot(img, h, w, 5) for h, w in CENTERS[:4]]
    img.spots[0].photometry("mexican_hat")
    sizes = []
    orig = port_spots.Image._compute_photometries

    def spy(self, method, kwargs, spots=None):
        sizes.append(len(self.spots if spots is None else spots))
        return orig(self, method, kwargs, spots)
    monkeypatch.setattr(port_spots.Image, "_compute_photometries", spy)
    for s in img.spots:
        s.photometry("mexican_hat")  # all hits
    late = port_spots.Spot(img, 32, 40, 5)
    img.spots.append(late)
    got = late.photometry("mexican_hat")
    assert sizes == [1]
    fresh = port_spots.Image(image=arr)
    fresh.spots = [port_spots.Spot(fresh, 32, 40, 5)]
    assert got == fresh.spots[0].photometry("mexican_hat")
    want = jax_spots.Image(image=arr)
    want.spots = [jax_spots.Spot(want, h, w, 5)
                  for h, w in CENTERS[:4] + [(32, 40)]]
    assert got == pytest.approx(want.spots[-1].photometry("mexican_hat"),
                                rel=PHOT_RTOL, abs=PHOT_ATOL)


def test_aperture_cache_and_illumina_s_n_match_jax():
    arr = _even_image()
    for pkg in (JAX, PORT):
        img = pkg.spots.Image(image=arr)
        img.spots = [pkg.spots.Spot(img, h, w, 5) for h, w in CENTERS[:3]]
        ap = img.get_photometry_aperture(img.spots[1], radius=3)
        assert (ap.r, list(ap.positions)) == (3.0, [45.0, 40.0])
    sn = [pkg.spots.Spot(pkg.spots.Image(image=arr), 20, 21, 5)
          .illumina_s_n() for pkg in (JAX, PORT)]
    assert sn[0] == sn[1]


# -- tracking ---------------------------------------------------------------

@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("seed,drift,ties", [(0, 0.0, 0.0), (1, 1.5, 0.0),
                                             (2, 0.0, 0.4)])
def test_greedy_tracking_matches_jax_and_the_oracle(seed, drift, ties,
                                                    native):
    rng = np.random.default_rng(seed)
    frames, offsets = _random_field_movie(rng, 6, (48, 48), 60,
                                          drift=drift, tie_fraction=ties)
    kw = dict(frame_shape=(48, 48), candidate_radius=2, offsets=offsets)
    got = port_tracking.greedy_particle_tracking(frames, use_native=native,
                                                 **kw)
    _assert_same_traces(got, greedy_particle_tracking_oracle(frames, **kw))
    want = jax_tracking.greedy_particle_tracking(frames, use_native=False,
                                                 **kw)
    assert got[1] == want[1]
    assert _trace_keys(got[0]) == _trace_keys(want[0])  # order too


def test_tracking_helpers_match_jax():
    rng = np.random.default_rng(4)
    frames, offsets = _random_field_movie(rng, 4, (40, 40), 30, drift=2.0)
    cum = port_tracking.accumulate_offsets(offsets)
    assert cum == jax_tracking.accumulate_offsets(offsets)
    for r in (0, 3):
        got = port_tracking.discard_dropouts(frames[1], [cum[1]] *
                                             len(frames[1]), cum, (40, 40),
                                             spot_radius=r)
        want = jax_tracking.discard_dropouts(frames[1], [cum[1]] *
                                             len(frames[1]), cum, (40, 40),
                                             spot_radius=r)
        assert got[1] == want[1] and got[0] == want[0]
    for f, g in [(3, 0), (1, 2)]:
        assert port_tracking.get_cumulative_offset(offsets, f, g) == \
            jax_tracking.get_cumulative_offset(offsets, f, g)
        assert port_tracking.offset_frame_coordinates(
            offsets, (10.5, 3.25), f, g) == \
            jax_tracking.offset_frame_coordinates(offsets, (10.5, 3.25), f,
                                                  g)
    assert port_tracking.round_coordinates(2.5, -2.5) == \
        jax_tracking.round_coordinates(2.5, -2.5) == (3, -3)
    gen = (iter(fr) for fr in frames)  # one-shot iterators are accepted
    got = port_tracking.greedy_particle_tracking(list(gen), (40, 40),
                                                 offsets=offsets)
    want = jax_tracking.greedy_particle_tracking(frames, (40, 40),
                                                 offsets=offsets,
                                                 use_native=False)
    assert _trace_keys(got[0]) == _trace_keys(want[0])


@pytest.mark.parametrize("off_h", [0, 25, 28, 31, 34, 37, 58])
def test_luminosity_centroid_tracking_matches_jax(off_h):
    """Offsets that drive the window origins through every regime of the
    reference's slice-shape rule: in bounds, a partial slice (None) and a
    full window wrapped from the opposite edge (test_pipeline.py:734)."""
    rng = np.random.default_rng(23 + off_h)
    arrays = [rng.normal(400, 6, (64, 64)) for _ in range(3)]
    arrays[0][28:33, 28:33] += 4000.0
    arrays[1][29:34, 27:32] += 4000.0
    out = []
    for pkg in (JAX, PORT):
        frames = [pkg.spots.Image(image=a) for a in arrays]
        starts = [pkg.spots.Spot(frames[0], h, w, 5)
                  for h, w in [(30, 30), (5, 60), (40, 12)]]
        frames[0].spots.extend(starts)
        tracks = pkg.tracking.luminosity_centroid_particle_tracking(
            frames, starts, search_radius=3, s_n_cutoff=2.0,
            offsets=[(0, 0), (off_h, -2), (1, 1)])
        out.append(_trace_keys(tracks))
    assert out[0] == out[1]


# -- TimetraceExperiment ----------------------------------------------------

def _movie(T=12, shape=(64, 64), seed=2):
    rng = np.random.default_rng(seed)
    hh, ww = np.indices(shape).astype(float)
    frames = []
    for f in range(T):
        img = 400 + rng.normal(0, 6, shape)
        # A bleaching spot, a persistent one, and a drifting one.
        for (h, w), on in [((20.3, 20.6), f < 6), ((40.6, 44.3), True),
                           ((12.0 + 0.4 * f, 48.3), f < 9)]:
            if on:
                img += 3000.0 * np.exp(-((hh - h) ** 2 + (ww - w) ** 2) /
                                       (2 * 1.2 ** 2))
        frames.append(np.round(img).astype(np.uint16))
    return frames


def _timetrace(pkg, frames, psfs):
    images = [pkg.spots.Image(image=a, metadata={"filepath": f"mem://{i}"})
              for i, a in enumerate(frames)]
    images[0].spots = [pkg.spots.Spot(images[0], h, w, 5, gaussian_fit=gf)
                       for (h, w), gf in psfs.items()]
    tte = pkg.experiment.TimetraceExperiment(frames=images)
    tte.lc_create_traces()
    return tte


@pytest.mark.parametrize("batched", [True, False])
def test_timetrace_experiment_matches_jax(tmp_path, batched):
    frames = _movie()
    psfs = jax_find_peptides_batch(np.stack(frames[:1]), max_candidates=64,
                                   num_iters=60)[0]
    assert len(psfs) == 3
    texts = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        tte = _timetrace(pkg, frames, psfs)
        fits, inter = tte.stepfit_tracks(mirror_start=4, chung_kennedy=1,
                                         p_threshold=0.01, batched=batched)
        texts.append((tte, fits, inter))
        path = tmp_path / f"{name}.csv"
        tte.save_experiment_as_csv(str(path), include_step_fits=True,
                                   include_intermediates=True)
        with open(path) as fh:
            texts[-1] += (list(csv.reader(fh)),)
    (tj, fj, ij, rj), (tp, fp, ip, rp) = texts
    assert [tr.coordinates(f) for tr in tp.spot_traces
            for f in range(len(frames))] == \
        [tr.coordinates(f) for tr in tj.spot_traces
         for f in range(len(frames))]
    assert fp.keys() == fj.keys() and ip.keys() == ij.keys()
    for k in fj:
        assert [p[:2] for p in fp[k].trace] == [p[:2] for p in fj[k].trace]
        np.testing.assert_allclose([p[2] for p in fp[k].trace],
                                   [p[2] for p in fj[k].trace],
                                   rtol=PHOT_RTOL, atol=PHOT_ATOL)
    assert rp[0] == rj[0] and len(rp) == len(rj) == 3 * len(frames) + 1
    for a, b in zip(rp[1:], rj[1:]):
        assert a[:4] == b[:4] and a[5] == b[5]  # trace, coords, frame, step
        for x, y in zip(a[4:], b[4:]):
            if x == "None" or y == "None":
                assert x == y
                continue
            np.testing.assert_allclose(
                np.asarray(ast.literal_eval(x), float),
                np.asarray(ast.literal_eval(y), float),
                rtol=PHOT_RTOL, atol=PHOT_ATOL)
    with pytest.raises(DeprecationWarning):
        tp.save_stepfits_as_csv()


def test_track_overlays_match_jax(tmp_path):
    """wildcolor_plot_tracks and SequenceExperiment.plot_traces write the
    same PNG files as the JAX package's (colours drawn from the random
    module, seeded alike)."""
    import imageio.v2 as iio
    frames = _movie(T=4)
    paths = []
    for i, a in enumerate(frames):
        paths.append(str(tmp_path / f"frame_{i}.png"))
        iio.imwrite(paths[-1], a)
    psfs = jax_find_peptides_batch(np.stack(frames[:1]), max_candidates=64,
                                   num_iters=60)[0]
    out = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        images = [pkg.spots.Image(image=a, metadata={"filepath": p})
                  for a, p in zip(frames, paths)]
        images[0].spots = [pkg.spots.Spot(images[0], h, w, 5,
                                          gaussian_fit=gf)
                           for (h, w), gf in psfs.items()]
        tte = pkg.experiment.TimetraceExperiment(frames=images)
        tte.lc_create_traces()
        random.seed(3)
        pngs = list(tte.wildcolor_plot_tracks(str(tmp_path / f"{name}_")))
        fresh = [pkg.spots.Image(image=a, metadata={"filepath": p})
                 for a, p in zip(frames, paths)]
        for f, img in enumerate(fresh):
            img.spots = [pkg.spots.Spot(img, h, w, 5)
                         for h, w in list(psfs)[:3 - f % 2]]
        ex = pkg.experiment.SequenceExperiment(fresh)
        ex.trace_existing_spots()
        pngs += ex.plot_traces(timestamp_epoch=1500000000,
                               trace_directory=str(tmp_path / name),
                               prefix="f")
        out.append([open(p, "rb").read() for p in pngs])
    assert len(out[0]) == len(out[1]) == 8
    assert out[0] == out[1]


def test_next_frame_spot_by_luminosity_centroid_matches_jax():
    frames = _movie()
    out = []
    for pkg in (JAX, PORT):
        a = pkg.spots.Image(image=frames[2])
        b = pkg.spots.Image(image=frames[3])
        nxt = [pkg.experiment.Experiment.next_frame_spot_by_luminosity_centroid(
            pkg.spots.Spot(a, h, w, 5), b, offset=(0.4, -0.6))
            for h, w in [(13, 48), (20, 21), (40, 44), (2, 2)]]
        out.append([None if s is None else (s.h, s.w) for s in nxt])
    assert out[0] == out[1] and out[0][-1] is None


# -- registration -----------------------------------------------------------

@pytest.mark.parametrize("upsample", [1, 20])
def test_phase_correlate_single_pair_matches_jax(upsample):
    rng = np.random.default_rng(1)
    img = rng.normal(100, 10, (64, 48))
    img[20:24, 10:13] += 400
    reg = np.roll(np.roll(img, 3, axis=0), -2, axis=1)
    got = port_reg.phase_correlate(img, reg, upsample)
    want = jax_reg.phase_correlate(img, reg, upsample)
    assert all(isinstance(x, float) for x in got)
    assert got[:2] == want[:2] == (-3.0, 2.0)
    # error and diffphase of an exact shift are rounding noise near 0.
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-9, atol=1e-7)
    with pytest.raises(ValueError, match="same size"):
        port_reg.phase_correlate(img, img[:-1])
    with pytest.raises(ValueError, match="2D"):
        port_reg.phase_correlate(img[None], img[None])


# -- the device ---------------------------------------------------------------

def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("FSIA_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _device.default_device() == "cuda"
    arr = _even_image()
    img = port_spots.Image(image=arr)
    img.spots = [port_spots.Spot(img, 20, 21, 5)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        img.spots[0].photometry("mexican_hat")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_experiment.SequenceExperiment([img, img],
                                           alignment_frames=[img, img])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_reg.phase_correlate(arr, arr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.set_default_device("cuda")
    assert _device._DEFAULT is None  # a refused device is not kept
    # Read at call time: the environment, then set_default_device.
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cpu")
    assert img.spots[0].photometry("simple") == pytest.approx(
        float(arr[18:23, 19:24].sum()))
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cuda")
    assert _device.set_default_device("cpu") == torch.device("cpu")
    assert _device.default_device() == "cpu"
    assert _device.set_default_device(None) is None
    assert _device.default_device() == "cuda"
