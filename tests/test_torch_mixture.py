"""The port's KMeans, GaussianMixture and BayesianGaussianMixture
(ops/kmeans.py, ops/mixture.py) against scikit-learn on the CPU.

Tolerances: integer results (labels, ``n_iter_``, ``converged_``,
selections) equal; floats (centres, inertia, weights, means, covariances,
precisions, lower bounds, scores) within rtol 1e-9; numpy's global random
state equal after the same seeded calls. Two gaps are scikit-learn's own
last-bit freedom and are held at the tolerance they need, each in a test
of its own:

- restarts that reach one mixture with its components permuted tie in
  their lower bounds to a few ulps, and which of them wins follows the
  order of the sums (BLAS's in sklearn, torch's here): the same mixture in
  another component order (``test_permuted_restarts_tie_within_ulps``);
- sklearn sums a k-means inertia in an OpenMP reduction whose order varies
  from run to run, so between different clusterings of exactly equal
  inertia its own pick varies (``test_kmeans_exact_inertia_tie``).
"""

import pickle
import warnings

import numpy as np
import pytest
import threadpoolctl
import torch

from fluorosequencingimageanalysis_torch.ops import kmeans as pk
from fluorosequencingimageanalysis_torch.ops.kmeans import (
    ConvergenceWarning, KMeans, kmeans_batched)
from fluorosequencingimageanalysis_torch.ops.mixture import (
    BayesianGaussianMixture, GaussianMixture)
from fluorosequencingimageanalysis_torch.utils.convert import port_mixture

sk_cluster = pytest.importorskip("sklearn.cluster")
sk_mixture = pytest.importorskip("sklearn.mixture")

RTOL = 1e-9
torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


@pytest.fixture(autouse=True)
def _one_openmp_thread():
    """scikit-learn's OpenMP loops on one thread a worker, as torch's."""
    with threadpoolctl.threadpool_limits(1):
        yield
COV_TYPES = ["full", "tied", "diag", "spherical"]


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def _state():
    s = np.random.get_state()
    return s[1].copy(), s[2], s[3], s[4]


def _same_state(a, b):
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]


def _both(seed, make_sk, make_port, X):
    """Fit each side after ``np.random.seed(seed)``; the states after."""
    with warnings.catch_warnings(record=True) as w_sk:
        warnings.simplefilter("always")
        np.random.seed(seed)
        a = make_sk().fit(X)
        st_a = _state()
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        np.random.seed(seed)
        b = make_port().fit(X)
        st_b = _state()
    _same_state(st_a, st_b)
    return a, b, w_sk, w_port


def _separated(rng, n=600):
    return np.concatenate([rng.normal(m, 300, n // 3)
                           for m in (2000, 30000, 61000)])


def _ladders(rng, n=600):
    lv = rng.integers(0, 6, n)
    return np.where(lv > 0, np.exp(np.log(30000 * np.maximum(lv, 1)) +
                                   0.2 * rng.normal(size=n)),
                    rng.normal(2000, 300, n))


def _trace(rng, kind):
    """12 points: a noisy ladder, an integer ladder with exact zeros, or
    fewer distinct values than clusters."""
    lv = np.sort(rng.integers(0, 5, 12))[::-1]
    if kind == "noisy":
        return lv * 30000.0 + rng.normal(0, 3000, 12)
    if kind == "integer_zeros":
        return np.where(lv > 0, np.rint(lv * 30000.0 +
                                        rng.normal(0, 3000, 12)), 0.0)
    return np.array([0.0, 17.0, 61.0])[rng.integers(0, 3, 12)]


# -- KMeans ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["noisy", "integer_zeros", "few_distinct"])
def test_kmeans_shared_start_matches_sklearn(kind):
    rng = np.random.default_rng(1)
    for _ in range(20):
        x = _trace(rng, kind).reshape(-1, 1)
        for k in (2, 3, 5):
            init = np.sort(rng.choice(x[:, 0], k, replace=False)
                           if len(np.unique(x)) >= k else
                           rng.uniform(0, 60, k)).reshape(-1, 1)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                a = sk_cluster.KMeans(k, init=init, n_init=1).fit(x)
                b = KMeans(k, init=init, n_init=1, device="cpu").fit(x)
            assert np.array_equal(a.labels_, b.labels_)
            assert a.n_iter_ == b.n_iter_
            _close(b.cluster_centers_, a.cluster_centers_)
            _close(b.inertia_, a.inertia_)
            assert np.array_equal(a.predict(x), b.predict(x))


@pytest.mark.parametrize("kind", ["noisy", "integer_zeros", "few_distinct"])
def test_kmeans_seeded_matches_sklearn(kind):
    """k 1-6 with 10 restarts on 12-point traces: labels, centres, inertia,
    n_iter, the random state and the duplicate-point warnings."""
    rng = np.random.default_rng(2)
    for s in range(25):
        x = _trace(rng, kind).reshape(-1, 1)
        for k in range(1, 7):
            a, b, wa, wb = _both(
                s, lambda: sk_cluster.KMeans(k, n_init=10),
                lambda: KMeans(k, n_init=10, device="cpu"), x)
            assert np.array_equal(a.labels_, b.labels_), (s, k)
            assert b.labels_.dtype == np.int32 and a.n_iter_ == b.n_iter_
            _close(b.cluster_centers_, a.cluster_centers_)
            _close(b.inertia_, a.inertia_)
            assert [str(w.message) for w in wa] == \
                [str(w.message) for w in wb]
            assert all(issubclass(w.category, ConvergenceWarning)
                       for w in wb)


@pytest.mark.parametrize("data", ["separated", "ladders"])
def test_kmeans_seeded_matches_sklearn_on_long_rows(data):
    """Rows longer than ``SMALL_N`` sum with torch's reductions."""
    rng = np.random.default_rng(3)
    for s in range(4):
        x = (_separated if data == "separated" else _ladders)(rng)
        x = x.reshape(-1, 1)
        for k in (2, 3, 6):
            a, b, _, _ = _both(s, lambda: sk_cluster.KMeans(k, n_init=4),
                               lambda: KMeans(k, n_init=4, device="cpu"), x)
            assert np.array_equal(a.labels_, b.labels_)
            assert a.n_iter_ == b.n_iter_
            _close(b.cluster_centers_, a.cluster_centers_)
            _close(b.inertia_, a.inertia_)


def test_kmeans_batched_equals_per_row_fits():
    """One ``kmeans_batched`` over many rows equals a KMeans fit a row in
    order, and leaves the random state where those fits leave it."""
    rng = np.random.default_rng(4)
    X = np.stack([_trace(rng, ("noisy", "integer_zeros", "few_distinct")
                         [t % 3]) for t in range(30)])
    np.random.seed(5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = kmeans_batched(X, 4, 10, device="cpu")
        st = _state()
        np.random.seed(5)
        for t in range(len(X)):
            km = sk_cluster.KMeans(4, n_init=10).fit(X[t][:, None])
            assert np.array_equal(km.labels_, res["labels"][t])
            _close(res["centers"][t], km.cluster_centers_[:, 0])
            assert km.n_iter_ == res["n_iter"][t]
    _same_state(st, _state())


def test_kmeans_exact_inertia_tie():
    """Between two clusterings of exactly equal inertia sklearn's own pick
    varies from run to run (its OpenMP sum); the port's restarts are its
    restarts one by one, and its pick is one sklearn makes."""
    x = np.array([20., 20., 0., 0., 20., 0., 10., 10., 20., 20., 0., 0.])
    x = x.reshape(-1, 1)
    rs_a, rs_b = np.random.RandomState(182), np.random.RandomState(182)
    clusterings = []
    for _ in range(10):
        a = sk_cluster.KMeans(2, n_init=1, random_state=rs_a).fit(x)
        b = KMeans(2, n_init=1, random_state=rs_b, device="cpu").fit(x)
        assert np.array_equal(a.labels_, b.labels_) and \
            a.n_iter_ == b.n_iter_
        _close(b.inertia_, a.inertia_, rtol=1e-15)
        clusterings.append(tuple(a.labels_ == a.labels_[0]))
    assert len(set(clusterings)) == 2   # two clusterings, equal inertia
    b = KMeans(2, n_init=10, random_state=182, device="cpu").fit(x)
    assert tuple(b.labels_ == b.labels_[0]) in set(clusterings)


def test_kmeans_plusplus_potential_tie():
    """Two k-means++ candidates whose potentials tie in exact arithmetic
    (symmetric small integers): sklearn sums each potential in OpenBLAS's
    gemv order, the port left to right, so one restart picks the other
    candidate. Here the ten restarts still reach the same clustering and
    inertia; the restart kept, and so ``n_iter_``, may differ."""
    x = np.array([2., -6., -1., -6., -5., 9., 4., 3., -0., -2., -0., -2.])
    x = x.reshape(-1, 1)
    a, b, _, _ = _both(251, lambda: sk_cluster.KMeans(2, n_init=10),
                       lambda: KMeans(2, n_init=10, device="cpu"), x)
    assert np.array_equal(a.labels_, b.labels_)
    _close(b.cluster_centers_, a.cluster_centers_)
    _close(b.inertia_, a.inertia_)


def test_kmeans_plusplus_draws_match_sklearn():
    """The k-means++ picks from the same generator state, and the count of
    uniforms a start takes."""
    from sklearn.cluster._kmeans import _kmeans_plusplus
    rng = np.random.default_rng(6)
    for s in range(30):
        x = _trace(rng, ("noisy", "integer_zeros")[s % 2]).reshape(-1, 1)
        X = x - x.mean(axis=0)
        for k in (2, 4, 6):
            rs = np.random.RandomState(s)
            st = rs.get_state()
            _, idx = _kmeans_plusplus(X, k, (X * X)[:, 0], np.ones(12), rs)
            used = np.random.RandomState()
            used.set_state(st)
            u = used.random_sample((1, pk.draws_per_init(k)))
            a, b = rs.get_state(), used.get_state()
            assert np.array_equal(a[1], b[1]) and a[2:] == b[2:]
            xc = torch.as_tensor(X[:, 0])[None]
            _, idx2 = pk.kmeans_plusplus(xc, xc * xc, k, u)
            assert idx2[0].tolist() == idx.tolist()


def test_more_clusters_than_samples_raises():
    x = np.arange(3.0).reshape(-1, 1)
    with pytest.raises(ValueError, match="n_samples=3 should be >= "
                                         "n_clusters=4"):
        KMeans(4, device="cpu").fit(x)
    with pytest.raises(ValueError, match="n_samples=3 should be >= "
                                         "n_clusters=4"):
        sk_cluster.KMeans(4).fit(x)
    for cls in (GaussianMixture, sk_mixture.GaussianMixture):
        with pytest.raises(ValueError, match="Expected n_samples >= "
                                             "n_components"):
            cls(n_components=4).fit(x) if cls is not GaussianMixture else \
                cls(n_components=4, device="cpu").fit(x)
    with pytest.raises(ValueError, match="minimum of 2"):
        GaussianMixture(device="cpu").fit(np.ones((1, 1)))


# -- GaussianMixture ---------------------------------------------------------

@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_gmm_shared_start_matches_sklearn(cov_type):
    rng = np.random.default_rng(7)
    x = _ladders(rng).reshape(-1, 1)
    k = 4
    w0 = np.full(k, 1.0 / k)
    m0 = np.array([[2000.0], [30000.0], [60000.0], [90000.0]])
    p0 = {"full": np.full((k, 1, 1), 1e-8), "tied": np.full((1, 1), 1e-8),
          "diag": np.full((k, 1), 1e-8), "spherical": np.full(k, 1e-8)}[
        cov_type]
    kw = dict(n_components=k, covariance_type=cov_type, weights_init=w0,
              means_init=m0, precisions_init=p0, max_iter=100)
    a = sk_mixture.GaussianMixture(**kw).fit(x)
    b = GaussianMixture(**kw, device="cpu").fit(x)
    assert a.n_iter_ == b.n_iter_ and a.converged_ == b.converged_
    for name in ("weights_", "means_", "covariances_",
                 "precisions_cholesky_", "precisions_"):
        _close(getattr(b, name), getattr(a, name))
    _close(b.lower_bound_, a.lower_bound_)
    _close(b.lower_bounds_, a.lower_bounds_)
    assert np.array_equal(a.predict(x), b.predict(x))


def _sorted_mixture(g):
    order = np.argsort(np.ravel(g.means_))
    return order, [np.ravel(g.weights_)[order], np.ravel(g.means_)[order]]


@pytest.mark.parametrize("data", ["separated", "ladders", "integers"])
@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_gmm_seeded_matches_sklearn(data, cov_type):
    """Kmeans-seeded fits with restarts: the same mixture (components in
    mean order), n_iter, convergence, labels and the random state."""
    rng = np.random.default_rng({"separated": 8, "ladders": 9,
                                 "integers": 10}[data])
    x = {"separated": lambda: _separated(rng, 300),
         "ladders": lambda: _ladders(rng, 600),
         "integers": lambda: np.rint(rng.normal(0, 1000, 400))}[data]()
    x = x.reshape(-1, 1)
    for k in (1, 2, 4, 6):
        a, b, wa, wb = _both(
            k, lambda: sk_mixture.GaussianMixture(k, covariance_type=cov_type,
                                                  n_init=3),
            lambda: GaussianMixture(k, covariance_type=cov_type, n_init=3,
                                    device="cpu"), x)
        assert a.n_iter_ == b.n_iter_ and a.converged_ == b.converged_
        oa, sa = _sorted_mixture(a)
        ob, sb = _sorted_mixture(b)
        for u, v in zip(sb, sa):
            _close(u, v)
        cov = (lambda g, o: np.ravel(g.covariances_) if cov_type == "tied"
               else np.ravel(g.covariances_)[o])
        _close(cov(b, ob), cov(a, oa))
        _close(b.lower_bound_, a.lower_bound_)
        _close(b.bic(x), a.bic(x))
        _close(b.aic(x), a.aic(x))
        # labels through the mean order of each side's components
        ra, rb = np.argsort(oa), np.argsort(ob)
        assert np.array_equal(ra[a.predict(x)], rb[b.predict(x)])
        assert len(wa) == len(wb)


def test_permuted_restarts_tie_within_ulps():
    """Two restarts that reach one mixture in another component order tie
    in their lower bounds to the last bits; sklearn and the port may pick
    different ones of them: the same components, in another order, and
    lower bounds within 4 ulps."""
    rng = np.random.default_rng(1)
    for s in range(16):
        x = {0: lambda: np.concatenate([rng.normal(m, 300, 100) for m in
                                        (2000, 30000, 60000)]),
             1: lambda: _ladders(rng, 600),
             2: lambda: np.rint(rng.normal(0, 1, 2000) * 1000)}[s % 3]()
    x = x.reshape(-1, 1)  # the 16th of the sequence: seed 15, "tied", k=2
    rs_a, rs_b = np.random.RandomState(15), np.random.RandomState(15)
    lbs_a, lbs_b = [], []
    for _ in range(3):
        a = sk_mixture.GaussianMixture(2, covariance_type="tied",
                                       random_state=rs_a).fit(x)
        b = GaussianMixture(2, covariance_type="tied", random_state=rs_b,
                            device="cpu").fit(x)
        assert a.n_iter_ == b.n_iter_
        for u, v in zip(_sorted_mixture(b)[1], _sorted_mixture(a)[1]):
            _close(u, v)
        lbs_a.append(a.lower_bound_)
        lbs_b.append(b.lower_bound_)
    ulp = np.spacing(abs(lbs_a[0]))
    assert max(lbs_a) - min(lbs_a) <= 4 * ulp
    assert np.max(np.abs(np.array(lbs_a) - np.array(lbs_b))) <= 4 * ulp


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_scoring_surface_on_the_same_parameters(cov_type):
    """bic, aic, score, predict, predict_proba and score_samples of a port
    mixture built from a sklearn fit's parameters."""
    rng = np.random.default_rng(11)
    x = _ladders(rng).reshape(-1, 1)
    a = sk_mixture.GaussianMixture(3, covariance_type=cov_type,
                                   random_state=0).fit(x)
    b = port_mixture(a.weights_, a.means_, a.covariances_, cov_type)
    b.device = "cpu"
    q = np.concatenate([x[:50], [[0.0], [1e5]]])
    assert np.array_equal(a.predict(q), b.predict(q))
    _close(b.predict_proba(q), a.predict_proba(q), rtol=1e-9)
    _close(b.score_samples(q), a.score_samples(q))
    _close(b.score(q), a.score(q))
    _close(b.bic(x), a.bic(x))
    _close(b.aic(x), a.aic(x))
    _close(b.precisions_cholesky_, a.precisions_cholesky_)


@pytest.mark.parametrize("cov_type", COV_TYPES)
def test_integer_data_score_as_sklearn_scores_them(cov_type):
    """sklearn keeps the "full" and "tied" squared distances of integer X
    in an integer array (the fractions go); its fits take float64."""
    rng = np.random.default_rng(15)
    x = np.rint(_ladders(rng)).astype(np.int64).reshape(-1, 1)
    a = sk_mixture.GaussianMixture(3, covariance_type=cov_type,
                                   random_state=0).fit(x)
    b = port_mixture(a.weights_, a.means_, a.covariances_, cov_type)
    b.device = "cpu"
    for q in (x, x.tolist()):
        _close(b.score_samples(q), a.score_samples(q))
        assert np.array_equal(a.predict(q), b.predict(q))
        _close(b.predict_proba(q), a.predict_proba(q))
    _close(b.bic(x), a.bic(x))
    if cov_type in ("full", "tied"):
        assert abs(a.score(x) - a.score(x.astype(float))) > 1e-3


def test_port_mixture_from_a_batched_fit():
    """A JAX package ``BatchedGMM1D`` carried across scores as it does."""
    from fluorosequencingimageanalysis_tpu.inference.gmm import BatchedGMM1D
    rng = np.random.default_rng(12)
    x = _separated(rng).reshape(-1, 1)
    j = BatchedGMM1D([0.3, 0.3, 0.4], [2000.0, 30000.0, 61000.0],
                     [9e4, 1e5, 8e4], loglik=0.0, n_samples=len(x))
    b = port_mixture(j.weights_, j.means_, j.covariances_)
    b.device = "cpu"
    assert b.covariances_.shape == (3, 1, 1)
    assert np.array_equal(j.predict(x), b.predict(x))
    _close(b.score_samples(x), j.score_samples(x))
    _close(b.bic(x), j.bic(x))
    _close(b.aic(x), j.aic(x))


def test_fits_pickle_without_tensors(tmp_path):
    rng = np.random.default_rng(13)
    x = _separated(rng).reshape(-1, 1)
    fits = [GaussianMixture(3, n_init=2, random_state=0, device="cpu").fit(x),
            BayesianGaussianMixture(n_components=2, random_state=0,
                                    device="cpu").fit(x),
            KMeans(3, n_init=2, random_state=0, device="cpu").fit(x)]
    for f in fits:
        blob = pickle.dumps(f)
        assert b"_rebuild" not in blob and b"torch.storage" not in blob
        g = pickle.loads(blob)
        assert np.array_equal(f.predict(x), g.predict(x))
        if hasattr(f, "score_samples"):
            assert np.array_equal(f.score_samples(x), g.score_samples(x))


# -- BayesianGaussianMixture -------------------------------------------------

@pytest.mark.parametrize("n_components", [1, 3])
@pytest.mark.parametrize("cov_type", COV_TYPES)
@pytest.mark.parametrize("data", ["separated", "ladders"])
def test_bayesian_mixture_matches_sklearn(n_components, cov_type, data):
    """sklearn's default priors (the reference's), at the reached setting
    n_components=1 and at 3."""
    rng = np.random.default_rng(14)
    x = (_separated if data == "separated" else _ladders)(rng, 600)
    x = x.reshape(-1, 1)
    kw = dict(n_components=n_components, covariance_type=cov_type,
              max_iter=100)
    a, b, _, _ = _both(3, lambda: sk_mixture.BayesianGaussianMixture(**kw),
                       lambda: BayesianGaussianMixture(**kw, device="cpu"), x)
    assert a.n_iter_ == b.n_iter_ and a.converged_ == b.converged_
    for name in ("weights_", "means_", "covariances_",
                 "precisions_cholesky_", "mean_precision_",
                 "degrees_of_freedom_", "lower_bound_"):
        _close(getattr(b, name), getattr(a, name))
    _close(b.score_samples(x), a.score_samples(x))
    _close(b.predict_proba(x), a.predict_proba(x))
    assert np.array_equal(a.predict(x), b.predict(x))
    assert not hasattr(b, "bic") and not hasattr(b, "aic")
    assert not hasattr(a, "bic")
