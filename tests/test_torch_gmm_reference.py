"""The reference's mixture and cluster fits (inference/gmm.py, notebook.py)
in the JAX package, on scikit-learn, against the port's copies, on the
port's own estimators (ops/kmeans.py, ops/mixture.py) with scikit-learn
blocked, on the CPU.

The same numpy-seeded inputs go to both sides, with numpy's global random
state seeded the same before each (the reference draws from it). Stated
tolerances: integer results (selected ``num_fluors`` and ``k``,
``n_iter_``, fits, ``is_zero``, ``none_fits``, signal counts) equal;
floats (BICs, means, weights, variances, scores, fluor intensities)
within rtol 1e-9; the random state equal afterwards. A fitted mixture is
compared with its components in mean order (restarts that reach one
mixture with its components permuted tie to the last bits; which wins
follows the order of the sums, tests/test_torch_mixture.py).
"""

import contextlib
import csv
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
import torch

from fluorosequencingimageanalysis_tpu import notebook as jax_notebook
from fluorosequencingimageanalysis_tpu.inference import gmm as J

from fluorosequencingimageanalysis_torch import _device, notebook
from fluorosequencingimageanalysis_torch.compat import MCsimlib as compat_mc
from fluorosequencingimageanalysis_torch.inference import gmm as P
from fluorosequencingimageanalysis_torch.utils.synth import (
    make_gmm_photometries, make_v8_workload)

pytest.importorskip("sklearn")
RTOL = 1e-9
torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


@pytest.fixture(autouse=True)
def _one_openmp_thread():
    """scikit-learn's OpenMP loops on one thread a worker, as torch's."""
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(_device, "_DEFAULT", None)
    monkeypatch.setenv("FSIA_TORCH_DEVICE", "cpu")


@contextlib.contextmanager
def _without_sklearn():
    """scikit-learn unimportable, as on the card's machine."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "sklearn" or k.startswith("sklearn.")}
    for k in saved:
        sys.modules[k] = None
    sys.modules["sklearn"] = None
    try:
        yield
    finally:
        for k in list(sys.modules):
            if k == "sklearn" or k.startswith("sklearn."):
                del sys.modules[k]
        sys.modules.update(saved)


def _state():
    s = np.random.get_state()
    return s[1].copy(), s[2:]


def _run(seed, jax_call, port_call):
    """Each side after ``np.random.seed(seed)``; the random states after
    must agree."""
    np.random.seed(seed)
    a = jax_call()
    sa = _state()
    np.random.seed(seed)
    with _without_sklearn():
        b = port_call()
    sb = _state()
    assert np.array_equal(sa[0], sb[0]) and sa[1] == sb[1]
    return a, b


def _mixture(g):
    o = np.argsort(np.ravel(g.means_))
    cov = np.ravel(g.covariances_)
    return (np.ravel(g.weights_)[o], np.ravel(g.means_)[o],
            cov if cov.size == 1 else cov[o])


def _same(a, b, path="out"):
    """Equal structure; integers, strings and flags equal; floats within
    RTOL; fitted mixtures as in ``_mixture`` with equal n_iter_."""
    if hasattr(a, "means_") and hasattr(b, "means_"):
        assert type(a).__name__ == type(b).__name__, path
        for u, v in zip(_mixture(b), _mixture(a)):
            np.testing.assert_allclose(u, v, rtol=RTOL, atol=0,
                                       err_msg=path)
        if hasattr(a, "n_iter_"):
            assert a.n_iter_ == b.n_iter_ and \
                a.converged_ == b.converged_, path
        assert hasattr(a, "covars_") == hasattr(b, "covars_"), path
        if hasattr(a, "covars_"):
            for g, o in ((a, np.argsort(np.ravel(a.means_))),
                         (b, np.argsort(np.ravel(b.means_)))):
                c = np.ravel(g.covars_)
                g_cov = c if c.size == 1 else c[o]
                if g is a:
                    want = g_cov
            np.testing.assert_allclose(g_cov, want, rtol=RTOL, atol=0)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape, path
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0,
                                       err_msg=path)
        else:
            assert np.array_equal(a, b), path
    elif isinstance(a, (bool, np.bool_, int, np.integer, str, type(None))):
        assert a == b and type(a) is type(b), (path, a, b)
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), path
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0, err_msg=path)
    else:
        raise AssertionError(f"{path}: cannot compare {type(a)}")


def _sorted_means(means):
    return sorted(float(np.ravel(m)[0]) for m in means)


@pytest.fixture(scope="module")
def phot():
    return make_gmm_photometries(600, 3, seed=3)


CASES = ["plain", "cycle", "lower_bound", "force_num_fluors", "raw",
         "integers"]


@pytest.mark.parametrize("case", CASES)
def test_gmm_photometries(phot, case):
    """"integers": a track CSV's photometries are integers, and sklearn
    scores (the BIC) integer data with truncated squared distances."""
    raw = [v[1][0] for f in phot["ch1"].values() for v in f.values()]
    kw = {"plain": {}, "cycle": dict(cycle=1),
          "lower_bound": dict(cycle=0, lower_bound=2500.0),
          "force_num_fluors": dict(cycle=2, force_num_fluors=3),
          "raw": dict(raw_photometries=raw[:400]),
          "integers": dict(raw_photometries=[int(round(v)) for v in
                                             raw])}[case]
    a, b = _run(CASES.index(case),
                lambda: J._gmm_photometries(phot, max_fluors=4, **kw),
                lambda: P._gmm_photometries(phot, max_fluors=4, **kw))
    fm_a, bf_a, n_a, bic_a, all_a, raw_a = a
    fm_b, bf_b, n_b, bic_b, all_b, raw_b = b
    assert n_a == n_b
    np.testing.assert_allclose(bic_b, bic_a, rtol=RTOL)
    np.testing.assert_allclose(_sorted_means(fm_b), _sorted_means(fm_a),
                               rtol=RTOL)
    _same(bf_a, bf_b)
    assert len(all_a) == len(all_b)
    for (ga, ba), (gb, bb) in zip(all_a, all_b):
        _same(ga, gb)
        np.testing.assert_allclose(bb, ba, rtol=RTOL)
    assert np.array_equal(raw_a, raw_b)


def test_gmm_photometries_dpgmm_raises_as_the_jax_package(phot):
    """``BayesianGaussianMixture`` at sklearn's default n_components=1 is
    fitted, then ``bic`` is not there, on both sides."""
    def call(mod):
        with pytest.raises(AttributeError) as e:
            mod._gmm_photometries(phot, cycle=0, dpgmm=True)
        return str(e.value)

    a, b = _run(4, lambda: call(J), lambda: call(P))
    assert a == b == "'BayesianGaussianMixture' object has no attribute " \
                     "'bic'"
    x = np.array([[p] for p in P._collect_raw(phot, 0)])
    fits = _run(4, lambda: J._fit_gmm(x, 1, 1, 100, "full", dpgmm=True),
                lambda: P._fit_gmm(x, 1, 1, 100, "full", dpgmm=True))
    _same(fits[0], fits[1])
    np.testing.assert_allclose(fits[1].lower_bound_, fits[0].lower_bound_,
                               rtol=RTOL)


def test_gmm_photometries_mp(phot):
    a, b = _run(5, lambda: J._gmm_photometries_MP(phot, max_fluors=4,
                                                  cycle=0, n_init=4),
                lambda: P._gmm_photometries_MP(phot, max_fluors=4,
                                               cycle=0, n_init=4))
    _same(list(a[:4]), list(b[:4]))
    _same(a[4], b[4])
    assert np.array_equal(a[5], b[5])


def test_per_cycle_gmm_mp(phot):
    a, b = _run(6, lambda: J._per_cycle_gmm_MP(phot),
                lambda: P._per_cycle_gmm_MP(phot))
    assert list(a[0]) == list(b[0]) == [0, 1, 2]
    for c in a[0]:
        fa, fb = a[0][c], b[0][c]
        assert fa[1] == fb[1]
        np.testing.assert_allclose(fb[2], fa[2], rtol=RTOL)
        np.testing.assert_allclose(_sorted_means(fb[3]),
                                   _sorted_means(fa[3]), rtol=RTOL)
        _same(fa[0], fb[0])
        _same(a[1][c], b[1][c])
        assert np.array_equal(a[2][c], b[2][c])


def test_find_experiment_levels_up_to_every_value():
    """``max_num_levels`` None fits 1 to len(values) components (40)."""
    rng = np.random.default_rng(7)
    fits = []
    for t in range(10):
        lv = sorted(rng.integers(0, 4, 2).tolist(), reverse=True)
        fits.append(([[float(rng.normal(30000 * v + 2000, 800))
                       for _ in range(2)] for v in lv],
                     float(rng.uniform(0.5, 1.0))))
    a, b = _run(8, lambda: J._find_experiment_levels(fits),
                lambda: P._find_experiment_levels(fits))
    n = sum(len(p) for f, r in fits if r >= 0.7 for p in f)
    assert n >= 24
    assert a[3] == b[3]
    np.testing.assert_allclose(b[2], a[2], rtol=RTOL)
    np.testing.assert_allclose(_sorted_means(b[0]), _sorted_means(a[0]),
                               rtol=RTOL)
    _same(a[1], b[1])
    plateaus = [[40000.0, 41000.0], [1900.0]]
    assert J._translate_plateaus_into_signal(plateaus, a[1]) == \
        P._translate_plateaus_into_signal(plateaus, b[1])


def _legacy_inputs():
    rng = np.random.default_rng(6)
    return ([float(rng.normal(60000, 2000)) for _ in range(4)] +
            [float(rng.normal(30000, 2000)) for _ in range(4)] +
            [float(rng.normal(500, 300)) for _ in range(4)])


def _traces(n, seed=9):
    """Integer ladders with exact zero tails (a track CSV's traces)."""
    x = make_v8_workload(n, seed=seed)[0]
    return [tuple(float(v) for v in np.rint(r)) for r in x]


def test_cluster_fit_2():
    kw = dict(max_num_drops=3, zero_level=5000, single_fluor_min=20000,
              single_fluor_max=40000, fluor_std=5000, n_init=3,
              gaussian_score_min=0.0)
    a, b = _run(10, lambda: J._cluster_fit_2(_legacy_inputs(), **kw),
                lambda: P._cluster_fit_2(_legacy_inputs(), **kw))
    _same(a, b)
    sweep = dict(max_num_drops=5, zero_level=4000.0, integer_deviation=1.4,
                 gaussian_score_min=0.0, gaussian_std_max=3,
                 largest_coincidence=5, single_fluor_min=20000.0,
                 single_fluor_max=42000.0, fluor_std=8000.0)
    traces = _traces(50)
    a, b = _run(11, lambda: [J._cluster_fit_2(t, **sweep) for t in traces],
                lambda: [P._cluster_fit_2(t, **sweep) for t in traces])
    _same(a, b)
    assert sum(f[0] is not None for f in a) >= 25


def _phot_of(traces):
    return {"ch1": {f: {(t % 20, t): ((True,) * len(x), x, t)
                        for t, x in enumerate(traces) if t // 20 == f}
                    for f in range((len(traces) + 19) // 20)},
            "ch2": {0: {(0, 0): ((True,), (1.0,), 99)}}}


def test_parallel_cluster_fit_batched_equals_the_loop():
    """The batched k-means give the per-trace loop's results (here the
    JAX package's loop on scikit-learn, and the port's own loop through
    ``_cluster_fit_2``), the random state included."""
    phot = _phot_of(_traces(60, seed=12))
    kw = dict(max_num_drops=5, zero_level=4000.0, gaussian_score_min=0.0,
              gaussian_std_max=3, largest_coincidence=5,
              single_fluor_min=20000.0, single_fluor_max=42000.0,
              fluor_std=8000.0, algorithm="_cluster_fit_2", version="v")
    a, b = _run(12, lambda: J._parallel_cluster_fit(phot, **kw),
                lambda: P._parallel_cluster_fit(phot, **kw))
    _same(a, b)
    assert sum(a[2].values()) >= 20

    def loop():
        out = []
        for fdict in phot["ch1"].values():
            for cat, x, r in fdict.values():
                out.append(P._cluster_fit_2(
                    x, **{k: v for k, v in kw.items()
                          if k not in ("algorithm", "version")}))
        return out

    np.random.seed(12)
    with _without_sklearn():
        per_trace = loop()
    st = _state()
    np.random.seed(12)
    with _without_sklearn():
        batched = P._parallel_cluster_fit(phot, **kw)
    st2 = _state()
    assert np.array_equal(st[0], st2[0]) and st[1] == st2[1]
    got = {r: v for r, v in batched[4].items()}
    want = [f for f in per_trace]
    rows = [r for fdict in phot["ch1"].values() for _, _, r in
            fdict.values()]
    for r, f in zip(rows, want):
        if f[0] is None:
            assert r in batched[5]
        else:
            assert got[r][5:] == [f[2], f[3]]


def test_parallel_cluster_fit_short_traces_raise_as_the_loop():
    """A trace shorter than the largest cluster count: the loop raises
    sklearn's ValueError at that trace, the batched form too."""
    phot = _phot_of([(30000.0, 0.0, 0.0, 0.0), (30000.0, 0.0)])
    for mod in (J, P):
        with pytest.raises(ValueError, match="should be >= n_clusters"):
            ctx = _without_sklearn() if mod is P else \
                contextlib.nullcontext()
            with ctx:
                mod._parallel_cluster_fit(phot, max_num_drops=3)


def _write_csv(path, traces, cats):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(len(traces[0]))])
        for i, (x, c) in enumerate(zip(traces, cats)):
            w.writerow(["ch1", i // 100, i % 100, (7 * i) % 100,
                        str(tuple(c.tolist()))] + [int(v) for v in x])


def _bleaching(T, seed):
    """Integer traces of 12 frames, 1-3 fluors at 30,000 each bleaching
    with p 0.4 a frame, OFF frames from N(2000, 300^2): mostly OFF, as the
    sweep's zero level (its heaviest component) assumes."""
    rng = np.random.default_rng(seed)
    c = np.zeros((T, 12), int)
    c[:, 0] = rng.integers(1, 4, T)
    for i in range(1, 12):
        c[:, i] = np.maximum(c[:, i - 1] - (rng.random(T) < 0.4), 0)
    x = np.where(c > 0, 30000 * np.maximum(c, 1) *
                 np.exp(0.1 * rng.normal(size=(T, 12))),
                 rng.normal(2000, 300, (T, 12)))
    return np.rint(x), c > 0


def test_parameter_sweep_2(tmp_path, monkeypatch):
    """The whole sweep on a 150-trace CSV: the pickles' contents."""
    traces, cats = _bleaching(150, 13)
    path = str(tmp_path / "tracks.csv")
    _write_csv(path, traces, cats)
    out = {}
    for name, mod in (("jax", J), ("port", P)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        np.random.seed(14)
        ctx = _without_sklearn() if mod is P else contextlib.nullcontext()
        with ctx:
            res = mod._parameter_sweep_2(path, fname_hash="h", max_fluors=4,
                                         n_init=3)
        with open(d / "tracks.csvh_results.pkl", "rb") as fh:
            out[name] = (res, pickle.load(fh), _state())
    (ra, pa, sa), (rb, pb, sb) = out["jax"], out["port"]
    assert np.array_equal(sa[0], sb[0]) and sa[1] == sb[1]
    _same(ra, rb)
    results_a, params_a, gmm_a, adj_a, mods_a = pa
    results_b, params_b, gmm_b, adj_b, mods_b = pb
    _same(results_a, results_b)
    _same(params_a, params_b)
    _same(list(gmm_a), list(gmm_b))
    assert adj_a is None and adj_b is None and mods_a == mods_b
    assert sum(results_a[2].values()) >= 50


def test_gmm_raw_photometries(phot):
    raw = P._collect_raw(phot, 0)
    a, b = _run(15, lambda: jax_notebook.gmm_raw_photometries(raw),
                lambda: notebook.gmm_raw_photometries(raw))
    _same(a[0], b[0])
    np.testing.assert_allclose(b[1:], a[1:], rtol=RTOL)


@pytest.mark.parametrize("test", ["test_gmm_photometries",
                                  "test_cluster_fit_2_and_translate",
                                  "test_parallel_cluster_fit"])
def test_legacy_fitters_checks_on_compat(test, monkeypatch):
    """tests/test_legacy_fitters.py's checks, run on compat.MCsimlib with
    scikit-learn blocked."""
    import test_legacy_fitters
    monkeypatch.setattr(test_legacy_fitters, "MCsimlib", compat_mc)
    with _without_sklearn():
        getattr(test_legacy_fitters, test)()


def test_port_runs_its_mixtures_without_sklearn(tmp_path):
    """In a process where scikit-learn cannot be imported, the port's
    mixture entry points import and fit."""
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from fluorosequencingimageanalysis_torch import _device\n"
        "_device.set_default_device('cpu')\n"
        "from fluorosequencingimageanalysis_torch.compat import MCsimlib\n"
        "from fluorosequencingimageanalysis_torch.compat import "
        "jupyter_development as jd\n"
        "from fluorosequencingimageanalysis_torch.utils.synth import "
        "make_gmm_photometries\n"
        "p = make_gmm_photometries(200, 2, seed=1)\n"
        "s, f, r = MCsimlib._per_cycle_gmm_MP(p, max_fluors=2)\n"
        "g, m, sd = jd.gmm_raw_photometries(r[0])\n"
        "print(sorted(s), np.isfinite(m), 'sklearn' in sys.modules and "
        "sys.modules['sklearn'] is not None)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(P.__file__))) + os.pathsep + os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(P.__file__)))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[0,", "1]", "True", "False"]
