"""Port parity: the experiment slice (``Pipeline.run_experiment``) vs JAX.

The same seeded numpy stacks go through the JAX package's
``Pipeline().run_experiment`` and the port's
``Pipeline(device="cpu").run_experiment``, and through each host piece
(spot lists, linking, fill-in, rows, category filter, host photometry,
CSV writers). Integer parts, categories, counts, summaries and row order
must be equal. Photometry must agree within rtol 1e-4 with an atol of
5e-2: each value is a float32 sum of ~2e4 (49 crown pixels of ~400 minus
49 times the brim median) taken in another order on each side, which
differs by a few ulp (2e-3 each), and a background hole's value near 0
cannot absorb that relatively. mdma factors are ratios of those values:
rtol 1e-4, atol 1e-6. The fit-product metrics (gaussian_volume, sigmas)
are products of float32 LM parameters, which the two packages reach by
different reduction orders; they agree within the LM's converged
tolerance (1e-3, as the step's centers in test_torch_step.py), so these
two metrics are held at rtol 1e-3 (on the stack below, 10 of 344 values
differ by 1e-4 to 3.1e-4 relative; ROADMAP Queue 3).
"""

import csv
import logging

import numpy as np
import pytest
import torch

import bench
from test_fast_experiment import make_stack as make_edge_stack

from fluorosequencingimageanalysis_tpu.api import Pipeline as JaxPipeline
from fluorosequencingimageanalysis_tpu.config import (
    PhotometryConfig as JaxPhotometryConfig,
    PipelineConfig as JaxPipelineConfig)
from fluorosequencingimageanalysis_tpu.ops import photometry as jax_phot
from fluorosequencingimageanalysis_tpu.pipeline import (
    experiment as jax_experiment, fast_experiment as jax_fe,
    tracking as jax_tracking)
from fluorosequencingimageanalysis_tpu.utils import rounding as jax_rounding

from fluorosequencingimageanalysis_torch import api
from fluorosequencingimageanalysis_torch.api import (EXPERIMENT_KEYS,
                                                     Pipeline)
from fluorosequencingimageanalysis_torch.config import (PhotometryConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.ops import photometry as port_phot
from fluorosequencingimageanalysis_torch.pipeline import (
    experiment as port_experiment, fast_experiment as port_fe,
    tracking as port_tracking)
from fluorosequencingimageanalysis_torch.utils import rounding, synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

MC = 256
PHOT_RTOL, PHOT_ATOL = 1e-4, 5e-2
FIT_PRODUCT_RTOL = 1e-3
MDMA_RTOL, MDMA_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def stack():
    # Config 4's recipe at 3 fields x 4 cycles of 128x128, 30 spots each:
    # integer drift and ~15% per-cycle dropouts (holes to fill).
    return synth.make_experiment_stack(3, 4, 128, 128, spots_per_field=30,
                                       seed=0)


def _jax(stack, method="mexican_hat", **kw):
    cfg = JaxPipelineConfig(photometry=JaxPhotometryConfig(method=method))
    return JaxPipeline(cfg).run_experiment(stack, max_candidates=MC, **kw)


def _port(stack, method="mexican_hat", **kw):
    cfg = PipelineConfig(photometry=PhotometryConfig(method=method))
    return Pipeline(cfg, device="cpu").run_experiment(stack,
                                                      max_candidates=MC,
                                                      **kw)


@pytest.fixture(scope="module")
def ref(stack):
    return _jax(stack)


@pytest.fixture(scope="module")
def got(stack):
    return _port(stack)


def _assert_values_close(g, r, msg, rtol):
    if isinstance(r, (float, np.floating)):  # save_averages' mean
        np.testing.assert_allclose(g, r, rtol=rtol, atol=PHOT_ATOL,
                                   err_msg=msg)
        return
    assert len(g) == len(r), msg
    for i, (a, b) in enumerate(zip(g, r)):
        assert (a is None) == (b is None), (msg, i)
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=PHOT_ATOL,
                                       err_msg=f"{msg} {i}")


def _assert_same(g, r, rtol=PHOT_RTOL):
    """Every output of run_experiment equal, photometry within tolerance."""
    assert len(g["rows"]) == len(r["rows"])
    for i, (a, b) in enumerate(zip(g["rows"], r["rows"])):
        assert a[:5] == b[:5], (i, a[:5], b[:5])
        _assert_values_close(a[5], b[5], f"row {i}", rtol)
    for k in ("category_counts", "filtered_category_counts", "summary",
              "remainder_counts", "invalid_fields_mask", "csv_path",
              "category_csv_path"):
        assert g[k] == r[k], k
    assert set(g["offsets"]) == set(r["offsets"])
    for ch in r["offsets"]:
        for a, b in zip(g["offsets"][ch], r["offsets"][ch]):
            np.testing.assert_array_equal(a, b)
    if r["mdma_adjustments"] is None:
        assert g["mdma_adjustments"] is None
    else:
        assert g["mdma_adjustments"].keys() == r["mdma_adjustments"].keys()
        for ch, by_f in r["mdma_adjustments"].items():
            assert g["mdma_adjustments"][ch].keys() == by_f.keys()
            for f, af in by_f.items():
                np.testing.assert_allclose(g["mdma_adjustments"][ch][f], af,
                                           rtol=MDMA_RTOL, atol=MDMA_ATOL)


def _assert_rows_identical(a, b):
    """Bit-identical rows (one implementation, two schedules)."""
    assert len(a["rows"]) == len(b["rows"]) > 0
    for ra, rb in zip(a["rows"], b["rows"]):
        assert ra[:5] == rb[:5]
        np.testing.assert_array_equal(ra[5], rb[5])


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _assert_csv_same(g_path, r_path):
    g, r = _read_csv(g_path), _read_csv(r_path)
    assert g[0] == r[0] and len(g) == len(r)
    n_fixed = 5 if r[0][0] == "CHANNEL" else len(r[0])
    for a, b in zip(g[1:], r[1:]):
        assert a[:n_fixed] == b[:n_fixed]
        for x, y in zip(a[n_fixed:], b[n_fixed:]):
            np.testing.assert_allclose(float(x), float(y), rtol=PHOT_RTOL,
                                       atol=PHOT_ATOL)


# -- host pieces -----------------------------------------------------------

def test_rounding_matches_jax():
    x32 = np.float32(0.49999997)
    assert rounding.py2_round_array(np.asarray([x32], np.float32)).tolist() \
        == [0]
    assert rounding.py2_round(float(x32)) == 0
    vals = np.asarray([-0.5, 0.5, 1.5, -1.5, 2.49999988], np.float32)
    assert rounding.py2_round_array(vals).tolist() == [-1, 1, 2, -2, 2]
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-50, 50, 2000),
                        np.arange(-20, 20) + 0.5,
                        [0.49999999999999994, -0.49999999999999994]])
    np.testing.assert_array_equal(rounding.py2_round_array(x),
                                  jax_tracking._py2_round_array(x))
    assert [rounding.py2_round(v) for v in x] == \
        [jax_rounding.py2_round(v) for v in x]


def test_accumulate_offsets_matches_jax():
    offs = [(0.0, 0.0), (0.05, -1.95), (1.1, 0.35), (-0.7, 2.15)]
    assert port_tracking.accumulate_offsets(offs) == \
        jax_tracking.accumulate_offsets(offs)
    with pytest.raises(ValueError, match="first image"):
        port_tracking.accumulate_offsets([(1.0, 0.0)])


def test_make_experiment_stack_is_the_bench_recipe():
    got, pos, present, drift = synth.make_experiment_stack(
        2, 3, 64, 64, spots_per_field=12, seed=3, return_truth=True)
    np.testing.assert_array_equal(
        got, bench.make_experiment_stack(2, 3, 64, 64, spots_per_field=12,
                                         seed=3))
    assert pos.shape == (2, 12, 2) and present.shape == (2, 12, 3)
    assert present[:, :, 0].all()


@pytest.fixture(scope="module")
def step_out(stack):
    """The JAX step's compact bucket for the stack, as run_experiment
    fetches it."""
    return JaxPipeline().run_stack(stack, max_candidates=MC,
                                   keys=EXPERIMENT_KEYS, photometry_min=None)


def test_spot_lists_link_and_fill_match_jax(step_out, stack):
    F, C, H, W = stack.shape
    j_rh, j_rw, j_vals = jax_fe._spot_lists(step_out, F, C, H, W,
                                            with_values=True)
    p_rh, p_rw, p_vals = port_fe._spot_lists(step_out, F, C)
    n_traces = n_holes = 0
    for f in range(F):
        for c in range(C):
            np.testing.assert_array_equal(p_rh[f][c], j_rh[f][c])
            np.testing.assert_array_equal(p_rw[f][c], j_rw[f][c])
            np.testing.assert_array_equal(p_vals[f][c], j_vals[f][c])
        offs = [(float(step_out["offsets_h"][f, c]),
                 float(step_out["offsets_w"][f, c])) for c in range(C)]
        cum = np.asarray(jax_tracking.accumulate_offsets(offs), np.float64)
        pos, present = port_fe._link_field(p_rh[f], p_rw[f], (H, W), cum)
        jpos, jpresent = jax_fe._link_field(j_rh[f], j_rw[f], (H, W), offs)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(present, jpresent)
        for r in (9, 2, 0):
            a = port_fe._fill_traces(pos, present, cum, (H, W),
                                     photometry_radius=r)
            b = jax_fe._fill_traces(jpos, jpresent, cum, (H, W),
                                    photometry_radius=r, return_masks=True)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        n_traces += len(pos)
        n_holes += int((~present).sum())
    assert n_traces > 60 and n_holes > 0  # the stack must exercise both


def test_link_field_subpixel_offsets_and_dropouts_match_jax():
    rng = np.random.default_rng(7)
    C, H, W = 6, 40, 40
    rhs = [rng.integers(0, H, 25) for _ in range(C)]
    rws = [rng.integers(0, W, 25) for _ in range(C)]
    for c in range(C):  # unique bins per frame, as the dedup guarantees
        keys = np.unique(rhs[c] * W + rws[c])
        rhs[c], rws[c] = keys // W, keys % W
    offs = [(0.0, 0.0)] + [(round(rng.uniform(-2, 2) * 20) / 20,
                            round(rng.uniform(-2, 2) * 20) / 20)
                           for _ in range(C - 1)]
    cum = np.asarray(port_tracking.accumulate_offsets(offs), np.float64)
    pos, present = port_fe._link_field(rhs, rws, (H, W), cum)
    jpos, jpresent = jax_fe._link_field(rhs, rws, (H, W), offs)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(present, jpresent)
    assert present.sum() < sum(len(r) for r in rhs)  # dropouts discarded
    assert (present.sum(axis=1) > 1).any()           # and links made


@pytest.mark.parametrize("C", [4, 70])
def test_rows_by_field_matches_jax(C):
    rng = np.random.default_rng(C)
    sizes = [7, 0, 30]
    T = sum(sizes)
    cats = rng.random((T, C)) < 0.6
    cats[:, 0] |= rng.random(T) < 0.5
    pos = rng.integers(0, 100, (T, C, 2))
    phot = rng.normal(0, 1e4, (T, C))
    a = port_fe._rows_by_field(pos, cats, phot, sizes, len(sizes))
    b = jax_fe._rows_by_field(pos, cats, phot, sizes, len(sizes))
    assert len(a) == len(b) == len(sizes)
    for ra, rb in zip(a, b):
        assert [r[:3] for r in ra] == [r[:3] for r in rb]
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x[3], y[3])


def test_filter_monotone_categories_matches_jax():
    counts = {"a": {0: {(True, True, False): 3, (True, False, True): 2,
                        (False, True, True): 1, (True, True, True): 5},
                    1: {}},
              "b": {0: {(False, False, False): 1, (True, False, False): 4}}}
    assert port_fe.filter_monotone_categories(counts) == \
        jax_fe.filter_monotone_categories(counts)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_host_photometry_matches_jax(dtype):
    rng = np.random.default_rng(1)
    img = rng.normal(400, 30, (40, 50)).clip(0).astype(dtype)
    for h, w in [(0, 0), (3, 47), (20, 25), (39, 10), (8, 49), (35, 44)]:
        assert port_phot.mexican_hat_host(img, h, w) == \
            jax_phot.mexican_hat_host(img, h, w)
        assert port_phot.mexican_hat_host(img, h, w, brim_size=2,
                                          radius=4) == \
            jax_phot.mexican_hat_host(img, h, w, brim_size=2, radius=4)
        assert port_phot.simple_host(img, h, w) == \
            jax_phot.simple_host(img, h, w)
        for top in (1, 3):
            assert port_phot.maximum_host(img, h, w, top=top) == \
                jax_phot.maximum_host(img, h, w, top=top)


def test_csv_writers_match_jax(tmp_path):
    rows = [("ch1", 0, 10, 12, (True, False), np.asarray([1.5, -2.25])),
            ("ch1", 1, None, None, (False, True), (None, 3.0))]
    for name, mod in (("p", port_fe), ("j", jax_fe)):
        mod.write_track_rows_csv(rows, 2, str(tmp_path / f"{name}.csv"))
        mod.write_track_rows_csv([r[:5] + (0.5,) for r in rows], 2,
                                 str(tmp_path / f"{name}_avg.csv"),
                                 save_averages=True)
    counts = {"ch1": {0: {(True, False): 2}, 1: {}},
              "ch2": {0: {(False, True): 1, (True, True): 4}}}
    for collate in (False, True):
        port_experiment.write_category_counts_csv(
            counts, str(tmp_path / "pc.csv"), collate_fields=collate)
        jax_experiment.write_category_counts_csv(
            counts, str(tmp_path / "jc.csv"), collate_fields=collate)
        assert (tmp_path / "pc.csv").read_bytes() == \
            (tmp_path / "jc.csv").read_bytes()
    for suffix in (".csv", "_avg.csv"):
        assert (tmp_path / f"p{suffix}").read_bytes() == \
            (tmp_path / f"j{suffix}").read_bytes()


def test_hole_gathers_match_windows_and_read_uint16_exactly():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 65536, (2, 3, 30, 40)).astype(np.uint16)
    img_id = np.array([0, 5, 3, 2])
    hs = np.array([9, 15, 20, 9])
    ws = np.array([9, 30, 12, 22])
    for t in (torch.from_numpy(x), torch.from_numpy(x.astype(np.float32))):
        win = port_fe.gather_windows(
            t.reshape(6, 30, 40), torch.from_numpy(img_id),
            torch.from_numpy(hs), torch.from_numpy(ws), 9)
        flat = x.reshape(6, 30, 40)
        want = np.stack([flat[i, h - 9:h + 10, w - 9:w + 10].reshape(-1)
                         for i, h, w in zip(img_id, hs, ws)])
        np.testing.assert_array_equal(win.numpy(), want.astype(np.float32))
    queue = []
    phot = np.full((4, 1), np.nan)
    queue.append((port_fe._queue_photometry(
        torch.from_numpy(x), img_id, hs, ws, "simple", 2, 6, chunk=3),
        phot, np.arange(4), np.zeros(4, np.int64)))
    port_fe.flush_hole_queue(queue)
    assert queue == []
    np.testing.assert_array_equal(
        phot[:, 0], [float(flat[i, h - 2:h + 3, w - 2:w + 3].sum())
                     for i, h, w in zip(img_id, hs, ws)])


# -- the whole path --------------------------------------------------------

def test_run_experiment_matches_jax(stack, ref, got, tmp_path):
    _assert_same(got, ref)
    assert len(got["rows"]) > 60
    assert any(not all(r[4]) for r in got["rows"])  # rows with holes
    for name, fn in (("p", _port), ("j", _jax)):
        fn(stack, csv_path=str(tmp_path / f"{name}.csv"),
           category_csv_path=str(tmp_path / f"{name}_cat.csv"),
           category_csv_filtered=False, category_csv_collate_fields=True)
    _assert_csv_same(tmp_path / "p.csv", tmp_path / "j.csv")
    assert (tmp_path / "p_cat.csv").read_bytes() == \
        (tmp_path / "j_cat.csv").read_bytes()
    assert _read_csv(tmp_path / "p.csv")[0] == \
        ["CHANNEL", "FIELD", "H", "W", "CATEGORY"] + \
        [f"FRAME {i}" for i in range(4)]


@pytest.mark.parametrize("method", ["simple", "maximum", "gaussian_volume",
                                    "sigmas"])
def test_run_experiment_photometry_methods_match_jax(stack, method):
    _assert_same(_port(stack, method), _jax(stack, method),
                 rtol=(FIT_PRODUCT_RTOL if method in ("gaussian_volume",
                                                      "sigmas")
                       else PHOT_RTOL))


@pytest.mark.parametrize("with_fn", [False, True])
def test_save_averages_matches_jax(stack, with_fn, tmp_path):
    def fn(photometry, frame, adjustments):
        return 7.5 * frame if photometry is None else photometry * 1.1

    kw = dict(save_averages=True, adjustment_function=fn if with_fn
              else None)
    g = _port(stack, csv_path=str(tmp_path / "p.csv"), **kw)
    r = _jax(stack, csv_path=str(tmp_path / "j.csv"), **kw)
    g["csv_path"] = r["csv_path"] = None
    _assert_same(g, r)
    _assert_csv_same(tmp_path / "p.csv", tmp_path / "j.csv")


def test_mdma_and_adjustment_function_match_jax(stack):
    seen = []

    def fn(photometry, frame, adjustments):
        seen.append(adjustments is not None)
        return photometry * (1.0 - adjustments["mdma"][frame]) + frame

    for kw in (dict(mdma=True), dict(mdma=True, adjustment_function=fn)):
        g, r = _port(stack, **kw), _jax(stack, **kw)
        _assert_same(g, r)
        assert g["mdma_adjustments"]["ch1"]
    assert seen and all(seen)


@pytest.mark.parametrize("mdma", [False, True])
def test_keep_invalid_matches_jax(mdma, tmp_path):
    # Spots 4 px from the border: clipped windows (measured on the host)
    # and out-of-box holes (None) both occur.
    edge = make_edge_stack(F=1, C=5, seed=10, n_spots=30, presence_p=0.6,
                           edge_margin=4)
    g = _port(edge, keep_invalid=True, mdma=mdma,
              csv_path=str(tmp_path / "p.csv"))
    r = _jax(edge, keep_invalid=True, mdma=mdma,
             csv_path=str(tmp_path / "j.csv"))
    g["csv_path"] = r["csv_path"] = None
    _assert_same(g, r)
    assert any(v is None for row in g["rows"] for v in row[5])
    assert len(g["rows"]) > len(_port(edge)["rows"])
    _assert_csv_same(tmp_path / "p.csv", tmp_path / "j.csv")


def test_two_channels_and_remainder_threshold_match_jax(stack, got):
    other = np.ascontiguousarray(stack[::-1] * np.float32(0.9))
    stacks = {"ch1": stack, "ch2": other}
    # Fields with fewer all-ON traces than ch1's best field are masked.
    thr = max(got["remainder_counts"]["ch1"])
    for chans in (None, ["ch2"]):
        kw = dict(remainder_threshold=thr, remainder_channels=chans)
        g, r = _port(stacks, **kw), _jax(stacks, **kw)
        _assert_same(g, r)
        assert not all(r["invalid_fields_mask"])  # some field masked
        assert {row[0] for row in g["rows"]} == {"ch1", "ch2"}
    with pytest.raises(ValueError, match="remainder_channels"):
        _port(stacks, remainder_threshold=1, remainder_channels=["nope"])


def test_empty_field_matches_jax(stack, tmp_path):
    # Field 1 holds no spot: the same noise frame in every cycle (pure
    # noise that changes per cycle leaves registration no peak to find,
    # and its argmax is then arbitrary; ROADMAP Queue 3).
    empty = stack.copy()
    empty[1] = np.random.default_rng(5).normal(400.0, 6.0, empty.shape[2:])
    kw = dict(category_csv_collate_fields=True)
    g = _port(empty, category_csv_path=str(tmp_path / "p.csv"), **kw)
    r = _jax(empty, category_csv_path=str(tmp_path / "j.csv"), **kw)
    g["category_csv_path"] = r["category_csv_path"] = None
    _assert_same(g, r)
    assert g["category_counts"]["ch1"][1] == {}
    assert {row[1] for row in g["rows"]} == {0, 2}
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("group_fields,dispatch", [(1, "eager"),
                                                   (2, "window")])
def test_groups_and_dispatch_do_not_change_rows(stack, got, monkeypatch,
                                                group_fields, dispatch):
    # The default group (8 fields) holds the whole stack in one step.
    monkeypatch.setattr(api, "GROUP_FIELDS", group_fields)
    pipe = Pipeline(device="cpu")
    _assert_rows_identical(pipe.run_experiment(stack, max_candidates=MC,
                                               dispatch=dispatch), got)
    with pytest.raises(ValueError, match="dispatch"):
        pipe.run_experiment(stack, max_candidates=MC, dispatch="lazy")


def test_run_experiment_stack_queued_and_direct_holes_agree(step_out,
                                                            stack):
    F, C = stack.shape[:2]
    rhs, rws, values = port_fe._spot_lists(step_out, F, C)
    args = (torch.from_numpy(stack), step_out["offsets_h"],
            step_out["offsets_w"], (rhs, rws), values)
    direct = port_fe.run_experiment_stack(*args)
    queue = []
    queued = port_fe.run_experiment_stack(*args, hole_queue=queue)
    assert any(np.isnan(r[3]).any() for rows in queued for r in rows)
    port_fe.flush_hole_queue(queue)
    for a, b in zip(direct, queued):
        assert [r[:3] for r in a] == [r[:3] for r in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[3], y[3])
    with pytest.raises(ValueError, match="spot_values"):
        port_fe.run_experiment_stack(*args[:4], None)
    with pytest.raises(ValueError, match="host_images"):
        port_fe.run_experiment_stack(*args, keep_invalid=True)


def test_uint16_equals_float32(stack, got):
    u16 = np.clip(stack, 0, 65535).astype(np.uint16)
    out_u = _port(u16)
    _assert_rows_identical(out_u, _port(u16.astype(np.float32)))
    _assert_same(out_u, _jax(u16))


def test_sextractor_raises_and_overflow_warns(stack, caplog):
    # sextractor measures on the host inside run_experiment; the device
    # step has no such bucket, so a direct run_stack raises, as in the JAX
    # package.
    cfg = PipelineConfig(photometry=PhotometryConfig(method="sextractor"))
    with pytest.raises(ValueError, match="photometry_method.*sextractor"):
        Pipeline(cfg, device="cpu").run_stack(stack[:1])
    with caplog.at_level(logging.WARNING,
                         logger="fluorosequencingimageanalysis_torch.api"):
        _port(stack[:1], max_spots=4)
    assert any("max_spots" in r.message for r in caplog.records)
    assert any("max_candidates" in r.message for r in caplog.records)


SEXTRACTOR_RTOL = 1e-6  # host float64 aperture sums on both sides


@pytest.mark.parametrize("kw", [dict(), dict(keep_invalid=True),
                                dict(save_averages=True)])
def test_sextractor_photometry_matches_jax(stack, kw):
    g = _port(stack, method="sextractor", **kw)
    r = _jax(stack, method="sextractor", **kw)
    assert len(r["rows"]) > 0
    _assert_same(g, r, rtol=SEXTRACTOR_RTOL)
    if not kw:
        # The aperture parameters ride the config.
        cfg = PipelineConfig(photometry=PhotometryConfig(
            method="sextractor", aperture_radius=2.5, box_size=16,
            filter_size=3))
        jcfg = JaxPipelineConfig(photometry=JaxPhotometryConfig(
            method="sextractor", aperture_radius=2.5, box_size=16,
            filter_size=3))
        g2 = Pipeline(cfg, device="cpu").run_experiment(
            stack[:1], max_candidates=MC)
        r2 = JaxPipeline(jcfg).run_experiment(stack[:1], max_candidates=MC)
        _assert_same(g2, r2, rtol=SEXTRACTOR_RTOL)
        assert not np.allclose(g2["rows"][0][5], g["rows"][0][5])


def test_experiment_recovery_of_planted_spots(stack, got):
    _, pos, present, drift = synth.make_experiment_stack(
        3, 4, 128, 128, spots_per_field=30, seed=0, return_truth=True)
    step = Pipeline(device="cpu").run_stack(
        stack, max_candidates=MC, keys=("spot_rh", "spot_rw", "spot_state"))
    rec = synth.experiment_recovery(got["rows"], step, pos, present, drift)
    assert rec["planted_every_cycle"] == int(present.all(axis=2).sum())
    assert rec["detected_every_cycle"] > 0.8 * rec["planted_every_cycle"]
    assert rec["recovered_of_detected"] == 1.0
    assert rec["image_recall"] > 0.9


def test_profiling_registry_is_thread_safe():
    """run_experiment updates the stage and counter registry from its
    worker thread and the calling thread at once: no update may be lost."""
    import sys
    import threading

    from fluorosequencingimageanalysis_torch.utils import profiling

    profiling.reset_counters()
    profiling.reset_timings()
    n_threads, n_each = 16, 500

    def work():
        for _ in range(n_each):
            profiling.bump("stress/events")
            profiling.bump("stress/bytes", 3)
            with profiling.stage("stress/stage"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_each
    assert profiling.counters() == {"stress/events": total,
                                    "stress/bytes": 3 * total}
    assert profiling.timings()["stress/stage"]["count"] == total
    assert "stress/stage" in profiling.report()
    profiling.reset_counters()
    profiling.reset_timings()
    assert profiling.counters() == {} and profiling.timings() == {}
