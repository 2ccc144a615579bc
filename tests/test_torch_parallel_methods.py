"""Port parity: the ops and ``Pipeline`` methods that shard over a device
list (``run_zstack``, ``run_timetrace``, ``run_timetraces``, ``stepfit``,
``fluor_counts``, ``fluor_counts_calibrated``, ``per_cycle_gmm``) and
``simulate_signals`` on one.

On the CPU a device list is "cpu" entries: two, and a ragged three against
row counts that do not divide. Every op and method over a list must equal
the port's one-device call bit for bit: the rows (frames, tracks, traces,
models) are independent, and each share runs the one-device code on its
rows. Against the JAX package's mesh-sharded functions on conftest's 8
host devices (``make_mesh(8)``) the port is held at the tolerances of the
JAX package's own sharded tests (tests/test_background.py:94 and :202,
tests/test_fast_timetrace.py:309, tests/test_mesh.py:191 and :218,
tests/test_gmm_batch.py:129) where those cover the one-device difference
between the two packages, and otherwise at the port's one-device parity
tolerance of that op's own test file, named beside each comparison.
"""

import csv
import os

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh)

from fluorosequencingimageanalysis_torch import api
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (
    DetectConfig, LognormalConfig, PipelineConfig, StepfitConfig)
from fluorosequencingimageanalysis_torch._device import (
    Mesh, data_devices, make_mesh, shares)
from fluorosequencingimageanalysis_torch.utils import synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

LISTS = [["cpu"] * 2, ["cpu"] * 3]
LIST_IDS = ["two", "three"]
DET = dict(max_candidates=256, num_iters=20)
BOX = dict(box_size=16, filter_size=3)


def _equal(a, b, what=""):
    """Two results of the same function: equal bit for bit, recursively
    (arrays with their dtypes, NaN where NaN)."""
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        _equal(a.numpy(), b.numpy(), what)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), what
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), what
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def _zstack(T=5):
    """uint16 frames of 96x96 with planted spots on a sloped background
    (tests/test_torch_zstack.py's recipe)."""
    rng = np.random.default_rng(23)
    H = W = 96
    yy, xx = np.mgrid[:H, :W]
    frames = np.empty((T, H, W))
    pos = rng.uniform(8, H - 8, (12, 2))
    amp = rng.uniform(900, 1800, 12)
    for t in range(T):
        img = 800 + 2.0 * yy + 1.2 * xx + 15 * t + rng.normal(0, 4, (H, W))
        for (h, w), a in zip(pos, amp):
            img += a * np.exp(-((yy - h) ** 2 + (xx - w) ** 2) / 2.6)
        frames[t] = img
    return np.round(frames).astype(np.uint16)


def _track_movie():
    """tests/test_fast_timetrace.py:309's drifting-spot movie and starts."""
    rng = np.random.default_rng(4)
    T, H, W, n = 6, 96, 96, 13
    movie = rng.normal(400, 8, (T, H, W)).astype(np.float32)
    ys = rng.uniform(12, H - 12, n)
    xs = rng.uniform(12, W - 12, n)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        for i in range(n):
            movie[t] += (2500 * np.exp(
                -(((yy - ys[i] - 0.3 * t) ** 2 +
                   (xx - xs[i] + 0.2 * t) ** 2) / (2 * 1.3 ** 2)))
            ).astype(np.float32)
    return movie, ys, xs


def _v8_inputs():
    """tests/test_mesh.py:191's traces: 333 rows, ragged against the
    chunk of 128 and every device count."""
    import math
    rng = np.random.default_rng(4)
    T, F, K = 333, 6, 3
    beta = 30000.0
    lfm = [math.log(beta) + math.log(i + 1.0) for i in range(K + 2)]
    counts = np.maximum(3 - np.cumsum(rng.random((T, F)) < 0.3, axis=1), 0)
    ints = np.where(counts > 0,
                    beta * np.maximum(counts, 1) *
                    np.exp(0.1 * rng.normal(0, 1, (T, F))), 0.0)
    return ints, counts > 0, lfm, K


def _gmm_groups():
    """tests/test_gmm_batch.py:129's two groups (9 models: ragged)."""
    rng = np.random.default_rng(5)

    def mixture(means, sigmas, counts):
        return np.concatenate([rng.normal(m, s, n)
                               for m, s, n in zip(means, sigmas, counts)])
    return [mixture([0.0, 7.0], [0.5, 0.8], [900, 1100]),
            mixture([0.0, 4.0, 9.0], [0.4, 0.5, 0.6], [700, 600, 700])]


# -- the helpers --------------------------------------------------------------

def test_data_devices_and_row_shares(monkeypatch):
    cpu = torch.device("cpu")
    assert data_devices("cpu") == [cpu]
    assert data_devices(["cpu", torch.device("cpu")]) == [cpu, cpu]
    mesh = make_mesh(devices=["cpu"] * 8, data_axis=4)
    assert isinstance(mesh, Mesh) and data_devices(mesh) == [cpu] * 4
    with pytest.raises(ValueError, match="empty device list"):
        data_devices([])
    devs = [torch.device("cpu", i) for i in range(3)]
    assert shares(10, devs) == [(0, 4, devs[0]), (4, 7, devs[1]),
                                (7, 10, devs[2])]
    assert shares(2, devs) == [(0, 1, devs[0]), (1, 2, devs[1])]
    assert shares(0, devs) == [(0, 0, devs[0])]
    assert shares(5, "cpu") == [(0, 5, cpu)]
    # A CUDA device the process cannot reach raises; nothing falls back.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (["cpu", "cuda"], ("cpu", "cuda:1")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            data_devices(device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Pipeline(device=device)


def _launchers():
    """Each kernel's launcher with CPU arguments of its shapes."""
    from fluorosequencingimageanalysis_torch.ops import (
        consolidate, fused_candidates, fused_fit, fused_gmm_em,
        fused_lognormal, fused_mc_fit)
    i32, u8 = torch.int32, torch.uint8
    z = torch.zeros
    return {
        "candidate_map_launch": lambda: fused_candidates._launch(
            z(2, 16, 16), [0.0] * 25),
        "fit_quality_launch": lambda: fused_fit._launch(
            z(2, 16, 16), z(2, 3, dtype=i32), z(2, 3, dtype=i32), 5, 1),
        "v8_score_launch": lambda: fused_lognormal._launch(
            z(4, 3, 5), z(4, 3, 5, dtype=u8), z(3, 7, dtype=i32),
            z(7, dtype=u8)),
        "mc_fit_launch": lambda: fused_mc_fit._launch(
            z(4, 5, 5), z(6, 10)),
        "gmm_em_launch": lambda: fused_gmm_em._launch(
            z(2, 50), z(2, dtype=i32), z(2, 3, 4), z(2, 3, 4), z(2, 3, 4),
            z(2, 3, 4, dtype=torch.bool), 5, 1e-6),
        "consolidate_launch": lambda: consolidate._launch(
            (z(2, 9), z(2, 9), z(2, 9), z(2, 9, dtype=torch.bool)), 4.0),
    }


@pytest.mark.parametrize("name", ["candidate_map_launch",
                                  "fit_quality_launch", "v8_score_launch",
                                  "mc_fit_launch", "gmm_em_launch",
                                  "consolidate_launch"])
def test_kernel_launches_with_its_device_current(name, monkeypatch):
    """Every kernel launches with its tensors' device current, so that a
    piece on a second card launches there: the library is a stand-in that
    records the device current at each call."""
    from fluorosequencingimageanalysis_torch import _build
    current, seen = [None], []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    class Fn:
        def __init__(self, fn_name):
            self.fn_name = fn_name

        def __call__(self, *args):
            seen.append((self.fn_name, current[0]))
            return 0

    class Lib:
        def __getattr__(self, fn_name):
            fn = Fn(fn_name)
            setattr(self, fn_name, fn)
            return fn

    monkeypatch.setattr(_build, "load", lambda _name: Lib())
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    from fluorosequencingimageanalysis_torch.ops import (
        consolidate, fused_candidates, fused_fit, fused_gmm_em,
        fused_lognormal, fused_mc_fit)
    for wrapper in (fused_candidates.candidate_map_fused,
                    fused_fit.fit_quality, fused_lognormal.v8_score_fused,
                    fused_mc_fit.mc_fit, fused_gmm_em.gmm_em,
                    consolidate.consolidate):
        # The stand-in's launches leave the counts as they were.
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    _launchers()[name]()
    assert [d for n, d in seen if n == name] == [torch.device("cpu")]


# -- the ops against their one-device calls ----------------------------------

@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_background_ops_over_a_device_list(devices):
    from fluorosequencingimageanalysis_torch.ops.background import (
        stack_background, subtract_background_stack)
    frames = _zstack(5)
    for fn in (stack_background, subtract_background_stack):
        one = fn(frames, device="cpu", **BOX)
        for x in (frames, torch.from_numpy(frames.astype(np.float32)),
                  frames[0]):
            want = one if x.ndim == 3 else one[0]
            if isinstance(x, torch.Tensor):
                want = fn(x, device="cpu", **BOX)
            _equal(fn(x, device=devices, **BOX), want, fn.__name__)
    mesh = make_mesh(devices=["cpu"] * 4, data_axis=2)
    _equal(stack_background(frames, device=mesh, **BOX),
           stack_background(frames, device="cpu", **BOX))


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_lc_track_over_a_device_list(devices):
    from fluorosequencingimageanalysis_torch.pipeline.fast_timetrace import (
        lc_track)
    movie, ys, xs = _track_movie()
    one = lc_track(movie, ys, xs, device="cpu")
    _equal(lc_track(movie, ys, xs, device=devices), one)
    _equal(lc_track(torch.from_numpy(movie), ys, xs, device=devices), one)
    # Fewer tracks than devices, and none.
    _equal(lc_track(movie, ys[:2], xs[:2], device=devices),
           lc_track(movie, ys[:2], xs[:2], device="cpu"))
    _equal(lc_track(movie, [], [], device=devices),
           lc_track(movie, [], [], device="cpu"))


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_stepfit_batched_over_a_device_list(devices):
    from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
        stepfit_batched)
    traces = synth.make_step_traces(37, 40, seed=5)
    kw = dict(mirror_start=5, chung_kennedy=1, p_threshold=0.01,
              n_threads=1)
    one = stepfit_batched(traces, device="cpu", **kw)
    for chunk in (None, 16):   # one chunk, and three chunks of shares
        _equal(stepfit_batched(traces, device=devices, chunk=chunk, **kw),
               one)
    _equal(stepfit_batched(traces, device=devices, chung_kennedy=0,
                           mirror_start=0, n_threads=1),
           stepfit_batched(traces, device="cpu", chung_kennedy=0,
                           mirror_start=0, n_threads=1))


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_score_traces_over_a_device_list(devices):
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    from fluorosequencingimageanalysis_torch.ops.lognormal import (
        score_traces)
    ints, cats, lfm, K = _v8_inputs()
    one = score_traces(ints, cats, lfm, 0.1, max_possible=K, chunk=128,
                       device="cpu")
    for chunk in (128, None):
        _equal(score_traces(ints, cats, lfm, 0.1, max_possible=K,
                            chunk=chunk, device=devices), one)
    # The CPU twin takes no launch; the wrapper is called once a (chunk,
    # device) share (the card's count), which the card's smoke checks.
    assert v8_score_fused.launches == 0


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_gmm_fit_batched_over_a_device_list(devices):
    from fluorosequencingimageanalysis_torch.ops.gmm_batch import (
        gmm_fit_batched)
    groups = _gmm_groups()
    kw = dict(n_init=3, n_iter=60, seed=1)
    one = gmm_fit_batched(groups, [2, 3, 4], device="cpu", **kw)
    _equal(gmm_fit_batched(groups, [2, 3, 4], device=devices, **kw), one)
    # Fewer models than devices.
    _equal(gmm_fit_batched(groups, [2], n_init=1, n_iter=20,
                           device=devices),
           gmm_fit_batched(groups, [2], n_init=1, n_iter=20, device="cpu"))


# -- the ops against the JAX package's mesh-sharded functions -----------------

def test_stack_background_equals_the_jax_mesh_function():
    """tests/test_background.py:94's tolerance (rtol 1e-6, atol 1e-4)."""
    from fluorosequencingimageanalysis_tpu.ops.background import (
        stack_background as jax_stack_background)
    from fluorosequencingimageanalysis_torch.ops.background import (
        stack_background)
    frames = _zstack(5)
    want = np.asarray(jax_stack_background(frames, 10, 4,
                                           mesh=jax_make_mesh(8)))
    got = stack_background(frames, 10, 4, device=["cpu"] * 3).numpy()
    assert got.shape == want.shape == frames.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_lc_track_equals_the_jax_mesh_function():
    """tests/test_fast_timetrace.py:309: bit for bit."""
    from fluorosequencingimageanalysis_tpu.pipeline.fast_timetrace import (
        lc_track as jax_lc_track)
    from fluorosequencingimageanalysis_torch.pipeline.fast_timetrace import (
        lc_track)
    movie, ys, xs = _track_movie()
    want = jax_lc_track(movie, ys, xs, mesh=jax_make_mesh(8))
    got = lc_track(movie, ys, xs, device=["cpu"] * 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_stepfit_batched_equals_the_jax_mesh_function():
    """tests/test_mesh.py:218: CK traces within atol 1e-9, plateau bounds
    of both fits equal."""
    from fluorosequencingimageanalysis_tpu.ops.stepfit_batch import (
        stepfit_batched as jax_stepfit_batched)
    from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
        stepfit_batched)
    traces = synth.make_step_traces(37, 40, seed=5)
    kw = dict(mirror_start=5, chung_kennedy=1, p_threshold=0.01)
    want = jax_stepfit_batched(traces, mesh=jax_make_mesh(8), **kw)
    got = stepfit_batched(traces, device=["cpu"] * 3, n_threads=1, **kw)
    assert len(got) == len(want) == 37
    for (p0, ck0, pl0, t0), (p1, ck1, pl1, t1) in zip(want, got):
        np.testing.assert_allclose(ck0, ck1, atol=1e-9)
        assert [(a, b) for a, b, _ in pl0] == [(a, b) for a, b, _ in pl1]
        assert [(a, b) for a, b, _ in t0] == [(a, b) for a, b, _ in t1]


def test_score_traces_equals_the_jax_mesh_function():
    """tests/test_mesh.py:191: winners and found flags equal; log-scores
    at tests/test_torch_lognormal.py's one-device tolerance (rtol 1e-6,
    atol 2e-6: float32 sums in another order than XLA's)."""
    from fluorosequencingimageanalysis_tpu.ops.lognormal import (
        score_traces as jax_score_traces)
    from fluorosequencingimageanalysis_torch.ops.lognormal import (
        score_traces)
    ints, cats, lfm, K = _v8_inputs()
    want = jax_score_traces(ints, cats, lfm, 0.1, max_possible=K, chunk=128,
                            mesh=jax_make_mesh(8))
    got = score_traces(ints, cats, lfm, 0.1, max_possible=K, chunk=128,
                       device=["cpu"] * 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=2e-6)


def test_gmm_fit_batched_equals_the_jax_mesh_function():
    """tests/test_gmm_batch.py:129's tolerance (rtol 1e-5, atol 1e-6) on
    the BIC-selected fits; every model's BIC at
    tests/test_torch_gmm.py's one-device bound (the EM sums in another
    order than XLA's)."""
    from test_torch_gmm import LL_REL

    from fluorosequencingimageanalysis_tpu.ops.gmm_batch import (
        gmm_fit_batched as jax_gmm_fit_batched)
    from fluorosequencingimageanalysis_torch.ops.gmm_batch import (
        gmm_fit_batched)
    groups = _gmm_groups()
    kw = dict(n_init=3, n_iter=60, seed=1)
    want = jax_gmm_fit_batched(groups, [2, 3, 4], mesh=jax_make_mesh(8),
                               **kw)
    got = gmm_fit_batched(groups, [2, 3, 4], device=["cpu"] * 3, **kw)
    np.testing.assert_array_equal(got["bic"].argmin(1),
                                  want["bic"].argmin(1))
    np.testing.assert_allclose(got["bic"], want["bic"], rtol=2 * LL_REL,
                               atol=0)
    for g, j in enumerate(want["bic"].argmin(1)):
        for key in ("weights", "means", "vars", "loglik", "bic"):
            np.testing.assert_allclose(got[key][g, j], want[key][g, j],
                                       rtol=1e-5, atol=1e-6, err_msg=key)


# -- the Pipeline methods -----------------------------------------------------

def _zstack_pipe(device):
    return Pipeline(PipelineConfig(detect=DetectConfig(**DET)),
                    device=device)


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_run_zstack_over_a_device_list(devices, monkeypatch):
    """Capped (with the background), lean, psfs and exhaustive; in one
    group, and in groups of two frames dealt to the devices with a ragged
    tail; and a stack already on the device, which a device list runs in
    the groups of frames from the host. Every value bit for bit."""
    frames = _zstack(5)
    one, multi = _zstack_pipe("cpu"), _zstack_pipe(devices)
    calls = [dict(return_background=True), dict(lean=True, max_spots=16),
             dict(psfs=True), dict(max_candidates="exhaustive")]
    for group in (api.GROUP_FRAMES, 2):
        monkeypatch.setattr(api, "GROUP_FRAMES", group)
        for kw in calls:
            _equal(multi.run_zstack(frames, **BOX, **kw),
                   one.run_zstack(frames, **BOX, **kw), f"{group} {kw}")
    _equal(multi.run_zstack(torch.from_numpy(frames), **BOX),
           one.run_zstack(frames, **BOX))


def test_run_zstack_equals_the_jax_mesh_pipeline():
    """``Pipeline(device=["cpu"] * 2)`` against the JAX
    ``Pipeline(mesh=make_mesh(8))``, as tests/test_background.py:202 holds
    the JAX mesh against one device: keep and cand_count equal; kept
    centers at tests/test_torch_zstack.py's one-device bound (1e-3 px),
    kept params (theta apart) within rtol 5e-3, atol 5e-3: the two
    packages' one-device gap, wider than the JAX sharded test's bounds,
    which hold one package against itself. That sharding adds nothing to
    the gap is held here too: the device list's result equals the port's
    one-device result bit for bit."""
    from fluorosequencingimageanalysis_tpu.api import Pipeline as JaxPipeline
    from fluorosequencingimageanalysis_tpu.config import (
        DetectConfig as JaxDetectConfig, PipelineConfig as JaxConfig)
    frames = _zstack(3)
    want = JaxPipeline(JaxConfig(detect=JaxDetectConfig(**DET)),
                       mesh=jax_make_mesh(8)).run_zstack(frames, **BOX)
    got = _zstack_pipe(["cpu"] * 2).run_zstack(frames, **BOX)
    _equal(got, _zstack_pipe("cpu").run_zstack(frames, **BOX))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    np.testing.assert_array_equal(got["cand_count"], want["cand_count"])
    keep = want["keep"]
    assert keep.sum() >= 3 * 8
    for k in ("center_h", "center_w"):
        np.testing.assert_allclose(got[k][keep], want[k][keep], atol=1e-3)
    np.testing.assert_allclose(got["params"][keep][:, :6],
                               want["params"][keep][:, :6], rtol=5e-3,
                               atol=5e-3)


def _movie():
    return synth.make_movie(T=12, H=96, W=96, n_spots=20)


TT_KW = dict(search_radius=3, s_n_cutoff=3.0, mirror_start=3,
             chung_kennedy=1, p_threshold=0.01)


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_run_timetrace_and_run_timetraces_over_a_device_list(devices,
                                                             tmp_path):
    """The fused one-device path against the two-step sharded one: tracks,
    photometries, step fits and the CSV's bytes equal."""
    movie = _movie()
    one, multi = Pipeline(device="cpu"), Pipeline(device=devices)
    a = one.run_timetrace(movie, csv_path=str(tmp_path / "one.csv"),
                          **TT_KW)
    b = multi.run_timetrace(movie, csv_path=str(tmp_path / "multi.csv"),
                            **TT_KW)
    assert a["trace_count"] >= 10
    with open(tmp_path / "one.csv", "rb") as fa, \
            open(tmp_path / "multi.csv", "rb") as fb:
        assert fa.read() == fb.read()
    _equal(b["traces"], a["traces"])
    _equal(b["photometries"], a["photometries"])
    assert list(b["step_fits"]) == list(a["step_fits"])
    _equal([v.trace for v in b["step_fits"].values()],
           [v.trace for v in a["step_fits"].values()])
    movies = [movie, movie[:, ::-1].copy()]
    paths = [str(tmp_path / f"m{i}.csv") for i in range(2)]
    outs = multi.run_timetraces(movies, csv_paths=paths, **TT_KW)
    for m, out, path in zip(movies, outs, paths):
        ref = one.run_timetrace(m, csv_path=str(tmp_path / "ref.csv"),
                                **TT_KW)
        _equal(out["photometries"], ref["photometries"])
        with open(path, "rb") as fa, open(tmp_path / "ref.csv", "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_stepfit_and_per_cycle_gmm_over_a_device_list(devices):
    traces = synth.make_step_traces(37, 40, seed=5)
    cfg = PipelineConfig(stepfit=StepfitConfig(
        mirror_start=5, chung_kennedy=1, p_threshold=0.01))
    _equal(Pipeline(cfg, device=devices).stepfit(traces),
           Pipeline(cfg, device="cpu").stepfit(traces))
    phot = synth.make_gmm_photometries(300, 3, seed=1)
    kw = dict(max_fluors=2, n_init=3, n_iter=30)
    got = Pipeline(device=devices).per_cycle_gmm(phot, **kw)
    want = Pipeline(device="cpu").per_cycle_gmm(phot, **kw)
    assert list(got[0]) == list(want[0]) == [0, 1, 2]
    for cycle in want[0]:
        bf_g, nf_g, bic_g, fm_g = got[0][cycle]
        bf_w, nf_w, bic_w, fm_w = want[0][cycle]
        assert (nf_g, bic_g) == (nf_w, bic_w)
        _equal([np.asarray(m) for m in fm_g], [np.asarray(m) for m in fm_w])
        assert len(got[1][cycle]) == len(want[1][cycle]) == 2
        for fit_g, fit_w in zip(got[1][cycle], want[1][cycle]):
            assert (fit_g._loglik, fit_g._n_samples) == (
                fit_w._loglik, fit_w._n_samples)
            for attr in ("means_", "covars_", "weights_"):
                _equal(np.asarray(getattr(fit_g, attr)),
                       np.asarray(getattr(fit_w, attr)), attr)
        _equal(got[2][cycle], want[2][cycle])


@pytest.mark.parametrize("devices", LISTS, ids=LIST_IDS)
def test_fluor_counting_over_a_device_list(devices, tmp_path):
    """fluor_counts on a track CSV and on its dict, and
    fluor_counts_calibrated: signals, totals, every fit-info field and
    the calibration equal."""
    from test_torch_inference import (_calibration_tracks, _ladder_rows,
                                      _write_tracks_csv)

    from fluorosequencingimageanalysis_torch.inference.photometries import (
        read_track_photometries_csv, write_photometries_dict_to_csv)
    path = str(tmp_path / "tracks.csv")
    _write_tracks_csv(path, _ladder_rows(np.random.default_rng(0), 120), 5)
    cfg = PipelineConfig(lognormal=LognormalConfig(max_possible=4,
                                                   allow_multidrop=True))
    one, multi = Pipeline(cfg, device="cpu"), Pipeline(cfg, device=devices)
    kw = dict(beta=30000.0, beta_sigma=0.2)
    _equal(multi.fluor_counts(path, **kw), one.fluor_counts(path, **kw))
    phot, _ = read_track_photometries_csv(path)
    _equal(multi.fluor_counts(phot, **kw), one.fluor_counts(phot, **kw))
    # device= names another device list, or one device.
    _equal(one.fluor_counts(path, device=devices, **kw),
           one.fluor_counts(path, **kw))
    cal_path = str(tmp_path / "cal.csv")
    write_photometries_dict_to_csv(_calibration_tracks(), cal_path)
    _equal(multi.fluor_counts_calibrated(cal_path),
           one.fluor_counts_calibrated(cal_path))


def test_simulate_signals_runs_on_the_host_whatever_the_devices():
    peptides = {"P1": (("AKCAK", ""),)}
    windows = {"C": (1, 2, 3), "K": (1, 2, 3)}
    args = (peptides, 0.9, 0.05, 0.1, windows)
    want = Pipeline(device="cpu").simulate_signals(*args, sample_size=200,
                                                   random_seed=3)
    for device in (["cpu"] * 3, make_mesh(devices=["cpu"] * 2)):
        got = Pipeline(device=device).simulate_signals(
            *args, sample_size=200, random_seed=3)
        leaves = [sorted((s, sorted(dict(c).items()))
                         for s, c, _ in t.leaf_iterator())
                  for t in (got, want)]
        assert leaves[0] == leaves[1] and leaves[0]


# -- the CLI ------------------------------------------------------------------

def test_cli_device_lists_shard_and_single_device_subcommands_refuse(
        tmp_path, capsys):
    from fluorosequencingimageanalysis_torch.__main__ import _devices, main
    assert _devices("cpu") == "cpu"
    assert _devices("cpu,cpu") == _devices(" cpu, cpu,") == ["cpu", "cpu"]
    with pytest.raises(SystemExit, match="no device"):
        _devices(",")
    image = str(tmp_path / "a.npy")
    np.save(image, np.zeros((16, 16), np.uint16))
    for argv in (["detect", image], ["simulate", "ACK", "C"]):
        with pytest.raises(SystemExit, match="runs on one device"):
            main(argv + ["--device", "cpu,cpu"])
    # stepfit over a two-entry list writes the one-device CSV.
    npy = str(tmp_path / "phot.npy")
    np.save(npy, synth.make_step_traces(24, 60, seed=5))
    for method, flags in (("t_test", ["--mirror-start", "10"]),
                          ("chi_squared", ["--num-steps", "6"])):
        argv = ["stepfit", "--npy", npy, "--method", method,
                "--chung-kennedy", "1", *flags]
        csvs = []
        for device in ("cpu", "cpu,cpu"):
            out = str(tmp_path / f"{method}-{device}")
            assert main([*argv, "--output-dir", out, "--device",
                         device]) == 0
            capsys.readouterr()
            with open(os.path.join(out, "step_fits.csv"), "rb") as fh:
                csvs.append(fh.read())
        assert csvs[0] == csvs[1] and len(csvs[0]) > 1000, method
    # zstack over the list writes the one-device spots CSV.
    frames = str(tmp_path / "frames.npy")
    np.save(frames, _zstack(3))
    rows = []
    for device in ("cpu", "cpu,cpu"):
        out = str(tmp_path / f"z-{device}.csv")
        assert main(["zstack", frames, "--output", out, "--device",
                     device, "--box-size", "16", "--filter-size", "3"]) == 0
        capsys.readouterr()
        with open(out, newline="") as fh:
            rows.append(list(csv.reader(fh)))
    assert rows[0] == rows[1] and len(rows[0]) > 3
