"""scikit-learn's KMeans for 1D data in PyTorch float64, batched over rows.

The reference clusters each trace's intensities with scikit-learn's
``KMeans`` (MCsimlib.py:2792-2982 [_cluster_fit_2]) and seeds every
Gaussian mixture with one (sklearn/mixture/_base.py). This module follows
scikit-learn 1.9.0 (BSD-3-Clause; sklearn/cluster/_kmeans.py,
_k_means_lloyd.pyx, _k_means_common.pyx) operation by operation and
imports nothing of it:

- the data are centred on their mean before the fit, and ``tol`` is
  scaled by the mean variance of the data;
- k-means++ takes ``2 + int(log k)`` local trials a centre, on squared
  distances computed as ``(-2 c x + c^2) + x^2`` clamped at 0, with a
  cumulative sum and ``searchsorted``;
- Lloyd's loop ends on unchanged labels (then no relabel) or on a total
  squared centre shift at or under the scaled tol (then a final relabel);
- an empty cluster takes the point farthest from its centre (numpy's
  ``argpartition`` on the host, as sklearn; only rows with an empty
  cluster and a nonzero distance go there), else the centre of the
  heaviest cluster, copied before or after its own division as sklearn's
  in-place loop copies it;
- the restart with the lowest inertia wins, the first on a tie, and a
  later one only where its clustering is not the best one's relabelled;
- a ``ConvergenceWarning`` where fewer distinct clusters than
  ``n_clusters`` come back.

Sums over a row of at most ``SMALL_N`` points run in numpy's and the
Cython loops' order (pairwise, sequential), so a 12-point trace gives
sklearn's labels bit for bit, ties included, on the card and on the CPU;
longer rows sum with ``torch.sum``/``torch.cumsum``, within an ulp.

Random state is sklearn's ``check_random_state``: None is numpy's global
``RandomState``, an int a new ``RandomState(int)``, a ``RandomState`` is
used as given. The uniforms are drawn on the host in sklearn's order (a
k-means++ start takes one ``choice`` and ``(k - 1) * (2 + int(log k))``
uniforms, whatever the data) and used on the device, so a batched fit
leaves the generator where the sequential fits leave it.

``kmeans_batched`` fits every restart of every row at once on ``device``
(None: ``_device.default_device()``); ``KMeans`` carries sklearn's
surface over it; ``batched_trace_fits`` and ``cluster_fit_prefits`` run
the per-trace fits of the reference's cluster fit batched, in the loop's
random-state order, and ``PrefitKMeans`` hands them to code written
against the ``KMeans`` constructor.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from .. import _device

SMALL_N = 128  # rows up to this long sum in numpy's order


class ConvergenceWarning(UserWarning):
    """Issued where scikit-learn issues its ConvergenceWarning."""


def check_random_state(seed):
    """sklearn.utils.check_random_state: the generator ``seed`` names."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError("%r cannot be used to seed a numpy.random.RandomState"
                     " instance" % seed)


def resolve(device):
    """``device``, or the port's default device where it is None."""
    return _device.resolve_device(_device.default_device() if device is None
                                  else device)


def n_local_trials(k):
    return 2 + int(np.log(k))


def draws_per_init(k):
    """Uniforms one k-means++ start consumes: one ``choice`` and
    ``n_local_trials`` for each centre after the first."""
    return 1 + (k - 1) * n_local_trials(k)


def true_div(a, n):
    """``a / n`` rounded as numpy rounds it. A CUDA tensor divided by a
    Python number is multiplied by the number's reciprocal (torch's
    kernel), an ulp off; divided by a device tensor it is a true
    division, as on the CPU."""
    return a / torch.full((), float(n), dtype=a.dtype, device=a.device)


def np_sum(x):
    """Sum over the last axis in numpy's order: pairwise, 8 accumulators a
    block of up to 128 (numpy's ``pairwise_sum``); ``torch.sum`` beyond
    ``SMALL_N``."""
    n = x.shape[-1]
    if n > SMALL_N:
        return x.sum(-1)
    if n < 8:
        r = torch.zeros_like(x[..., 0])
        for i in range(n):
            r = r + x[..., i]
        return r
    r = [x[..., j] for j in range(8)]
    i = 8
    while i < n - n % 8:
        r = [r[j] + x[..., i + j] for j in range(8)]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for i in range(n - n % 8, n):
        res = res + x[..., i]
    return res


def seq_sum(x):
    """Sum over the last axis left to right from 0 (a Cython loop, and
    BLAS's dot and one-row gemv under 16 terms); ``torch.sum`` beyond
    ``SMALL_N``."""
    n = x.shape[-1]
    if n > SMALL_N:
        return x.sum(-1)
    r = torch.zeros_like(x[..., 0])
    for i in range(n):
        r = r + x[..., i]
    return r


def seq_cumsum(x):
    """numpy's cumsum over the last axis (left to right)."""
    n = x.shape[-1]
    if n > SMALL_N:
        return torch.cumsum(x, -1)
    out, r = [], x[..., 0]
    out.append(r)
    for i in range(1, n):
        r = r + x[..., i]
        out.append(r)
    return torch.stack(out, -1)


def _first_index(u, n):
    """``RandomState.choice(n, p=ones(n) / n)`` from its one uniform."""
    w = np.ones(n)
    cdf = np.cumsum(w / w.sum())
    cdf /= cdf[-1]
    return np.searchsorted(cdf, u, side="right")


def kmeans_plusplus(Xc, xsq, k, u):
    """k-means++ on rows ``Xc`` (M, n) with squared norms ``xsq`` and the
    uniforms ``u`` (M, draws_per_init(k)) float64 host array.
    Returns the centres (M, k) and their indices (M, k)."""
    M, n = Xc.shape
    dev = Xc.device
    trials = n_local_trials(k)
    first = torch.as_tensor(_first_index(u[:, 0], n), device=dev)
    ud = torch.as_tensor(u, dtype=torch.float64, device=dev)
    idx = [first]
    c0 = Xc.gather(1, first[:, None])
    closest = torch.clamp_min(((-2.0 * (c0 * Xc)) + c0 * c0) + xsq, 0.0)
    pot = seq_sum(closest)
    rows = torch.arange(M, device=dev)
    for c in range(1, k):
        rand = ud[:, 1 + (c - 1) * trials:1 + c * trials] * pot[:, None]
        cand = torch.searchsorted(seq_cumsum(closest).contiguous(),
                                  rand.contiguous())
        cand = torch.clamp(cand, max=n - 1)
        xc = Xc.gather(1, cand)[:, :, None]
        d = torch.clamp_min(((-2.0 * (xc * Xc[:, None, :])) + xc * xc)
                            + xsq[:, None, :], 0.0)
        d = torch.minimum(closest[:, None, :], d)
        pots = seq_sum(d)
        best = torch.argmin(pots, 1)
        pot = pots[rows, best]
        closest = d[rows, best]
        idx.append(cand[rows, best])
    idx = torch.stack(idx, 1)
    return Xc.gather(1, idx), idx


def _assign(Xc, centers):
    """Labels (M, n): the first nearest centre by ``c^2 - 2 x c``."""
    pd = (centers * centers)[:, None, :] + \
        (-2.0 * (Xc[:, :, None] * centers[:, None, :]))
    return torch.argmin(pd, 2)


def _cluster_sums(Xc, onehot):
    """Per-cluster sums of the points (M, k), in point order."""
    n = Xc.shape[1]
    if n > SMALL_N:
        return torch.where(onehot, Xc[:, :, None], 0.0).sum(1)
    s = torch.zeros(onehot.shape[0], onehot.shape[2], dtype=Xc.dtype,
                    device=Xc.device)
    for i in range(n):
        s = s + torch.where(onehot[:, i], Xc[:, i:i + 1], 0.0)
    return s


def _average(sums, w):
    """_average_centers: each centre times 1/weight in cluster order; an
    empty one takes the heaviest cluster's centre as the loop left it
    (divided where that cluster comes first, else still its sum)."""
    k = w.shape[1]
    heavy = torch.argmax(w, 1, keepdim=True)
    scaled = torch.where(w > 0, sums * (1.0 / torch.where(w > 0, w, 1.0)),
                         sums)
    ar = torch.arange(k, device=w.device)
    src = torch.where(heavy < ar, scaled.gather(1, heavy),
                      sums.gather(1, heavy))
    return torch.where(w > 0, scaled, src)


def _relocate(rows, Xc, dist, labels, sums, w):
    """_relocate_empty_clusters_dense on the host for ``rows``: each empty
    cluster takes the farthest point (numpy's argpartition order)."""
    xs, ds = Xc[rows].cpu().numpy(), dist[rows].cpu().numpy()
    ls = labels[rows].cpu().numpy()
    ss, ws = sums[rows].cpu().numpy().copy(), w[rows].cpu().numpy().copy()
    for j in range(len(rows)):
        empty = np.where(np.equal(ws[j], 0))[0]
        n_empty = empty.shape[0]
        far = np.argpartition(ds[j], -n_empty)[:-n_empty - 1:-1]
        for e in range(n_empty):
            new, fi = empty[e], far[e]
            old = ls[j][fi]
            ss[j, old] -= xs[j, fi] * 1.0
            ss[j, new] = xs[j, fi] * 1.0
            ws[j, new] = 1.0
            ws[j, old] -= 1.0
    sums, w = sums.clone(), w.clone()
    sums[rows] = torch.as_tensor(ss, device=sums.device)
    w[rows] = torch.as_tensor(ws, device=w.device)
    return sums, w


def lloyd(Xc, centers, tol, max_iter=300):
    """Lloyd's loop for every row at once; each row stops at its own
    iteration. ``tol`` (M,) is the scaled tolerance. Returns labels (M, n),
    centres (M, k) and n_iter (M,). One host read an iteration (two where
    a cluster empties)."""
    M, n = Xc.shape
    k = centers.shape[1]
    dev = Xc.device
    ar = torch.arange(k, device=dev)
    labels_old = torch.full((M, n), -1, dtype=torch.long, device=dev)
    labels_out = labels_old.clone()
    active = torch.ones(M, dtype=torch.bool, device=dev)
    strict = torch.zeros_like(active)
    n_iter = torch.zeros(M, dtype=torch.long, device=dev)
    for i in range(max_iter):
        labels = _assign(Xc, centers)
        onehot = labels[:, :, None] == ar
        w = onehot.sum(1).to(Xc.dtype)
        sums = _cluster_sums(Xc, onehot)
        dist = (Xc - centers.gather(1, labels)) ** 2
        need = active & (w == 0).any(1) & (dist.amax(1) > 0)

        def advance(sums, w):
            new = _average(sums, w)
            d = new - centers
            tot = np_sum(torch.sqrt(d * d) ** 2)
            same = (labels == labels_old).all(1)
            s = active & same
            t = active & ~same & (tot <= tol)
            return new, s, t

        new, s, t = advance(sums, w)
        go_on = active & ~(s | t)
        flags = torch.stack([need.any(), go_on.any()]).tolist()
        if flags[0]:
            sums, w = _relocate(need.nonzero()[:, 0], Xc, dist, labels,
                                sums, w)
            new, s, t = advance(sums, w)
            go_on = active & ~(s | t)
            flags[1] = bool(go_on.any())
        centers = torch.where(active[:, None], new, centers)
        labels_out = torch.where(active[:, None], labels, labels_out)
        n_iter = torch.where(active, i + 1, n_iter)
        strict = strict | s
        active = go_on
        labels_old = labels
        if not flags[1]:
            break
    labels_out = torch.where(strict[:, None], labels_out,
                             _assign(Xc, centers))
    return labels_out, centers, n_iter


def _same_clustering(a, b, k):
    """sklearn's _is_same_clustering for each row: every label of ``a``
    maps to one label of ``b``."""
    same = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    big = torch.iinfo(b.dtype).max
    for j in range(k):
        m = a == j
        lo = torch.where(m, b, big).amin(1)
        hi = torch.where(m, b, -1).amax(1)
        same = same & (~m.any(1) | (lo == hi))
    return same


def kmeans_batched(X, n_clusters, n_init=1, *, init="k-means++",
                   max_iter=300, tol=1e-4, random_state=None, uniforms=None,
                   device=None):
    """KMeans on each row of ``X`` (T, n): every restart of every row in
    one device program. ``uniforms`` (T, n_init, draws_per_init(k))
    replaces the draws from ``random_state`` (taken in row, then restart
    order); ``init`` may be an array of centres (k,) or (T, k) instead of
    "k-means++" (one restart, no draws).

    Returns a dict of numpy arrays: labels (T, n) int32, centers (T, k),
    inertia (T,), n_iter (T,) and n_distinct (T,), the number of distinct
    labels (sklearn warns where it is under ``n_clusters``)."""
    dev = resolve(device)
    Xh = np.array(X, dtype=np.float64, order="C")
    T, n = Xh.shape
    k = int(n_clusters)
    if n < k:
        raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
    Xd = torch.as_tensor(Xh, device=dev)
    mean = true_div(np_sum(Xd), n)
    xc1 = Xd - mean[:, None]
    if tol == 0:
        tol_s = torch.zeros(T, dtype=torch.float64, device=dev)
    else:
        d = Xd - true_div(np_sum(Xd)[:, None], n)
        tol_s = true_div(np_sum(d * d), n) * tol
    given = not (isinstance(init, str) and init == "k-means++")
    if given:
        R = 1
        c = torch.as_tensor(np.broadcast_to(np.asarray(
            init, np.float64).reshape(-1, k), (T, k)).copy(), device=dev)
        centers0 = c - mean[:, None]
    else:
        R = int(n_init)
        if uniforms is None:
            uniforms = check_random_state(random_state).random_sample(
                (T, R, draws_per_init(k)))
        u = np.asarray(uniforms, np.float64).reshape(T * R, -1)
    Xc = xc1.repeat_interleave(R, 0)
    if not given:
        centers0, _ = kmeans_plusplus(Xc, Xc * Xc, k, u)
    labels, centers, n_iter = lloyd(Xc, centers0,
                                    tol_s.repeat_interleave(R, 0), max_iter)
    inertia = seq_sum((Xc - centers.gather(1, labels)) *
                      (Xc - centers.gather(1, labels)) * 1.0)
    labels = labels.view(T, R, n)
    centers = centers.view(T, R, k)
    inertia, n_iter = inertia.view(T, R), n_iter.view(T, R)
    b_lab, b_cen = labels[:, 0], centers[:, 0]
    b_in, b_it = inertia[:, 0], n_iter[:, 0]
    for r in range(1, R):
        take = (inertia[:, r] < b_in) & ~_same_clustering(labels[:, r],
                                                          b_lab, k)
        b_lab = torch.where(take[:, None], labels[:, r], b_lab)
        b_cen = torch.where(take[:, None], centers[:, r], b_cen)
        b_in = torch.where(take, inertia[:, r], b_in)
        b_it = torch.where(take, n_iter[:, r], b_it)
    b_cen = b_cen + mean[:, None]
    ar = torch.arange(k, device=dev)
    distinct = (b_lab[:, :, None] == ar).any(1).sum(1)
    return {"labels": b_lab.to(torch.int32).cpu().numpy(),
            "centers": b_cen.cpu().numpy(),
            "inertia": b_in.cpu().numpy(),
            "n_iter": b_it.cpu().numpy(),
            "n_distinct": distinct.cpu().numpy()}


def _distinct_warning(n_distinct, k):
    warnings.warn(
        "Number of distinct clusters ({}) found smaller than n_clusters "
        "({}). Possibly due to duplicate points in X.".format(n_distinct, k),
        ConvergenceWarning, stacklevel=3)


def check_X(X, name, min_samples=1):
    """X as a float64 (n, 1) array; sklearn's errors for the rest (the
    port's estimators fit one feature)."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError(f"Expected 2D array, got {X.ndim}D array instead")
    if X.shape[1] != 1:
        raise ValueError(f"{name} of this port fits one feature; X has "
                         f"{X.shape[1]}")
    if X.shape[0] < min_samples:
        raise ValueError(
            f"Found array with {X.shape[0]} sample(s) (shape={X.shape}) "
            f"while a minimum of {min_samples} is required by {name}.")
    return X


class KMeans:
    """sklearn.cluster.KMeans (Lloyd, 1D) on ``device`` through
    ``kmeans_batched``. Fitted attributes are numpy, so a fit pickles with
    no tensor in it."""

    def __init__(self, n_clusters=8, *, init="k-means++", n_init="auto",
                 max_iter=300, tol=1e-4, random_state=None, device=None):
        self.n_clusters = n_clusters
        self.init = init
        self.n_init = n_init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.device = device

    def fit(self, X, y=None):
        X = check_X(X, "KMeans")
        given = not isinstance(self.init, str)
        if not given and self.init != "k-means++":
            raise ValueError("the port's KMeans seeds with 'k-means++' or "
                             "given centres; got " + repr(self.init))
        n_init = 1 if self.n_init == "auto" else self.n_init
        if given and n_init != 1:
            warnings.warn(
                "Explicit initial center position passed: performing only"
                f" one init in KMeans instead of n_init={n_init}.",
                RuntimeWarning, stacklevel=2)
        if X.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={X.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        res = kmeans_batched(
            X[:, 0][None], self.n_clusters, n_init,
            init=np.asarray(self.init, np.float64) if given else self.init,
            max_iter=self.max_iter, tol=self.tol,
            random_state=self.random_state, device=self.device)
        self._set(res, 0)
        return self

    def _set(self, res, t):
        if res["n_distinct"][t] < self.n_clusters:
            _distinct_warning(int(res["n_distinct"][t]), self.n_clusters)
        self.cluster_centers_ = res["centers"][t].reshape(-1, 1).copy()
        self.labels_ = res["labels"][t].copy()
        self.inertia_ = float(res["inertia"][t])
        self.n_iter_ = int(res["n_iter"][t])

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_

    def predict(self, X):
        X = check_X(X, "KMeans")
        dev = resolve(self.device)
        c = torch.as_tensor(self.cluster_centers_[:, 0], device=dev)[None]
        x = torch.as_tensor(X[:, 0], device=dev)[None]
        return _assign(x, c)[0].to(torch.int32).cpu().numpy()


class PrefitKMeans:
    """Stands in for the ``KMeans`` class in code that builds one
    ``KMeans(n_clusters=..., ...)`` a fit and calls ``fit_predict(X)``:
    hands back this row's fits from ``kmeans_batched``, one per
    n_clusters, with sklearn's warning where it would warn. ``X`` must be
    the array the batch was fitted on."""

    def __init__(self, X, fits, n_init, max_iter, tol):
        self._X = X
        self._fits = fits  # {n_clusters: (result dict, row)}
        self._args = (n_init, max_iter, tol)

    def __call__(self, n_clusters, init="k-means++", n_init="auto",
                 max_iter=300, tol=1e-4, **kwargs):
        if (init != "k-means++" or (n_init, max_iter, tol) != self._args or
                kwargs):
            raise ValueError("the batched fit was made with other "
                             "arguments")
        km = KMeans(n_clusters, n_init=n_init, max_iter=max_iter, tol=tol)
        res, row = self._fits[n_clusters]

        def fit_predict(X, y=None):
            if not np.array_equal(np.asarray(X, np.float64), self._X):
                raise ValueError("the batched fit was made on other data")
            km._set(res, row)
            return km.labels_

        km.fit_predict = fit_predict
        return km


def batched_trace_fits(traces, ks, n_init, max_iter=300, tol=1e-4,
                       random_state=None, device=None):
    """One KMeans fit for each trace (a 1D array) and each k of ``ks``,
    as a loop over traces, then ks, would make them, with the random state
    consumed in that order: the uniforms of every fit are drawn at once,
    and one ``kmeans_batched`` runs each k over the traces of each length.
    Returns one ``{k: (result, row)}`` per trace."""
    rs = check_random_state(random_state)
    per = [n_init * draws_per_init(k) for k in ks]
    u = rs.random_sample((len(traces), sum(per)))
    cols = np.cumsum([0] + per)
    out = [dict() for _ in traces]
    by_len = {}
    for t, x in enumerate(traces):
        by_len.setdefault(len(x), []).append(t)
    for n, rows in by_len.items():
        X = np.stack([traces[t] for t in rows])
        for j, k in enumerate(ks):
            res = kmeans_batched(
                X, k, n_init, max_iter=max_iter, tol=tol,
                uniforms=u[rows, cols[j]:cols[j + 1]].reshape(
                    len(rows), n_init, -1), device=device)
            for i, t in enumerate(rows):
                out[t][k] = (res, i)
    return out


def cluster_fit_prefits(photometries, channel, kwargs, cluster_fit):
    """The ``_kmeans`` keyword of each ``cluster_fit`` call (the reference's
    ``_cluster_fit_2``) that ``_parallel_cluster_fit`` makes, in its loop's
    order: every trace's KMeans fits for each ``num_drops``, batched, on
    the data ``cluster_fit`` builds from ``intensities``. Yields empty
    dicts (the per-call KMeans) where a trace has fewer points than the
    largest cluster count, so the loop raises where it would."""
    import inspect
    defaults = {p.name: p.default for p in
                inspect.signature(inspect.unwrap(cluster_fit))
                .parameters.values()}
    arg = {**defaults, **kwargs}
    traces = []
    for chan, cdict in photometries.items():
        if chan != channel:
            continue
        for field, fdict in cdict.items():
            for (h, w), (categories, intensities, r) in fdict.items():
                corr = arg["intensity_corrections"]
                if corr is not None:
                    if arg["intensity_correction_div"]:
                        m = float(np.amax(corr))
                        intensities = [i * m / corr[k]
                                       for k, i in enumerate(intensities)]
                    else:
                        intensities = [i - corr[k]
                                       for k, i in enumerate(intensities)]
                traces.append(np.array(intensities, dtype=float))
    ks = [d + 1 for d in range(arg["min_num_drops"],
                               arg["max_num_drops"] + 1)]
    if not ks or any(len(x) < max(ks) for x in traces):
        for _ in traces:
            yield {}
        return
    fits = batched_trace_fits(traces, ks, arg["n_init"])
    for x, f in zip(traces, fits):
        yield {"_kmeans": PrefitKMeans(x.reshape(-1, 1), f, arg["n_init"],
                                       300, 0.0001)}
