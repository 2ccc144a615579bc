"""Random signal generation: single-peptide sampling and trie accumulation.

Parity: MCsimlib.py:863-1226. Note the reference's
``monte_carlo_trie`` depends on a C extension (``randsiggen``) that is NOT
present in its tree (its docstring admits the .c file is elsewhere,
MCsimlib.py:1981-1982), so it cannot actually run there; our version uses
the exact Python model and therefore works. The ``monte_carlo_dictionary``
family is deprecated in the reference and stays deprecated.

Distributional contract (tested against the batched native sampler in
tests/test_native.py):
- every labeled acid is independently a dud with probability u;
- each surviving head fluor's drop is its ideal Edman position plus a
  cumulative negative-binomial delay (gap length d, success p);
- head fluors may instead photobleach at an earlier exposure of their
  color (geometric in the exposure count with rate b); tail fluors can
  ONLY photobleach (they are never cleaved off);
- only drops bracketed by two exposures of their color are observable.
"""

from __future__ import annotations

import math
import random

from .proteome import _dp, _exposure_positions


def _kill_duds(sequence, labeled, u):
    """Each labeled acid independently becomes a dud ('x') with
    probability u."""
    return "".join("x" if ch in labeled and random.random() <= u else ch
                   for ch in sequence)


def _sample_edman_delay(d, p):
    """Inverse-CDF draw of the number of Edman failures across a gap of
    length d (Bernoulli-delay distribution _dp); the reference walks the
    CDF until it passes the uniform draw or stops increasing (float
    underflow guard for tiny p)."""
    point = random.random()
    cdf, prev, e = 0.0, -1.0, 0
    while cdf - prev > 0.0:  # stop once the CDF is numerically exhausted
        prev = cdf
        cdf += _dp(d, e, p)
        if cdf >= point:
            return e
        e += 1
    return e


def _sample_bleach_position(exposures, b):
    """Inverse-CDF draw over an ordered exposure list with per-exposure
    survival e^-b; returns the 1-based drop position, or None when the
    fluor outlives every exposure (no bleach event)."""
    point = random.random()
    scale = 1.0 - math.e ** -b  # zero when b == 0: never bleaches
    cdf = 0.0
    for k, position in enumerate(exposures):
        cdf += math.e ** (-b * k)
        if cdf * scale >= point:
            return position + 1
    return None


def random_signal(peptide, p=1.0, b=0.0, u=0.0, windows={}):
    """Sample one sequence of luminosity drops for a peptide
    (MCsimlib.py:863-1074): dud removal (u), Edman delays (p), head/tail
    photobleaching (b), then windowing."""
    p, b, u = float(p), float(b), float(u)
    head, tail = peptide
    # Dud removal. The reference processes one color at a time (head
    # occurrences, then tail); each occurrence draws independently, so
    # per-character sampling is the same distribution.
    for acid in windows:
        head = _kill_duds(head, acid, u)
        tail = _kill_duds(tail, acid, u)

    # Head fluors: ideal drop = 1-based position; Edman failures
    # accumulate across successive gaps.
    drops = []
    prev_ideal = 0
    cumulative_delay = 0
    for index, acid in enumerate(head):
        if acid not in windows:
            continue
        ideal = index + 1
        cumulative_delay += _sample_edman_delay(ideal - prev_ideal, p)
        prev_ideal = ideal
        drops.append((ideal + cumulative_delay, acid))

    # Exposure-position sets are per-color constants of this call — build
    # each once (this function is the Monte-Carlo inner loop; rebuilding
    # them per drop dominated the pure-Python sampler's profile).
    exposed = {acid: _exposure_positions(windows[acid]) for acid in windows}

    # Head photobleaching: a fluor may instead die at an exposure of its
    # color strictly before its Edman drop.
    for i, (position, acid) in enumerate(drops):
        exposures = sorted(x for x in exposed[acid] if x < position - 1)
        bleach = _sample_bleach_position(exposures, b)
        if bleach is not None:
            drops[i] = (bleach, acid)

    # Tail fluors never leave the slide: photobleaching only.
    for acid in windows:
        exposures = sorted(exposed[acid])
        for _ in range(tail.count(acid)):
            bleach = _sample_bleach_position(exposures, b)
            if bleach is not None:
                drops.append((bleach, acid))

    # Windowing: keep drops whose position AND prior position are exposed
    # for their color; dedupe, sort by position. Ties (two colors dropping
    # at the same cycle) sort canonically by (position, acid): the
    # reference's position-only sort leaves tie order to Python set
    # iteration — hash-randomized per process for strings, hence
    # irreproducible (the same Py2-dict pathology as consolidation order,
    # DESIGN.md section 13) — and the native sampler
    # (native/randsiggen.cpp) uses the same canonical order, so trie keys
    # agree across backends and processes.
    observable = {gap for gap in drops
                  if gap[0] in exposed[gap[1]]
                  and gap[0] - 1 in exposed[gap[1]]}
    return tuple(sorted(observable))


def monte_carlo_trie(peptides, p, b, u, windows, sample_size=100,
                     random_seed=None, silent=True):
    """Sample sample_size signals per peptide into a SignalTrie
    (MCsimlib.py:1787-1849; the reference shells out to the missing
    randsiggen C extension — we run the exact Python model)."""
    from .trie import SignalTrie

    return_trie = SignalTrie((None, None))
    random.seed(random_seed)
    for protein, protein_peptides in peptides.items():
        for peptide in protein_peptides:
            for _ in range(sample_size):
                signal = random_signal(peptide, p, b, u, windows)
                if signal:
                    return_trie.add_descendant(
                        sorted(signal, key=lambda x: x[0]), protein)
    return return_trie


def monte_carlo_trie_MP(peptides, p, b, u, windows, sample_size=1000,
                        alt_sample_sizes=None, child_count=None, silent=True):
    """Deprecated in the reference (MCsimlib.py:1851-1853)."""
    raise DeprecationWarning


def monte_carlo_dictionary(peptides, signals, p, b, u, windows,
                           sample_size=1000, result_queue=None,
                           child_number=0, silent=True):
    """Deprecated in the reference (MCsimlib.py:1076-1138)."""
    raise DeprecationWarning


def monte_carlo_dictionary_MP(peptides, signals, p, b, windows,
                              sample_size=1000, silent=True):
    """Deprecated in the reference (MCsimlib.py:1180-1187)."""
    raise DeprecationWarning
