"""Proteome preparation and the analytic Edman-delay model.

Parity: MCsimlib.py:42-861. The functions the reference
marks deprecated (raise DeprecationWarning at entry: discard,
truncate_heads, edman_failure_gaps(+_MP), perfect) keep that behavior.
"""

from __future__ import annotations

import math
import pickle


def _dp(d, e, p):
    """Bernoulli probability of e delays in a gap of length d, given Edman
    success p (MCsimlib.py:42-53)."""
    return math.comb(d - 1 + e, e) * p ** d * (1.0 - p) ** e


def load_proteome(filename, silent=True):
    """Unpickle {'PROTEIN': 'SEQUENCE'} (MCsimlib.py:55-86)."""
    with open(filename, "rb") as f:
        return pickle.load(f, encoding="latin1")


def homogenize(peptides, substitute_acid, target_acids):
    """Replace target acids with a substitute (MCsimlib.py:88-119).

    Parity note: the reference's inner loop re-replaces from the ORIGINAL
    sequence on every iteration, so only the LAST target acid's
    replacement survives. That quirk IS the observable contract;
    expressed here directly as a single last-acid substitution.
    """
    last = target_acids[-1] if target_acids else None
    return {protein: (seq.replace(last, substitute_acid) if last else seq)
            for protein, seq in peptides.items()}


def cleave(peptides, cleave_acid, silent=True):
    """Cleave after every cleave_acid (MCsimlib.py:121-190).

    Each fragment keeps its trailing cleave acid; empty fragments (and
    proteins left with no fragments) are dropped.
    """
    out = {}
    for protein, sequence in peptides.items():
        if not sequence:
            continue
        parts = sequence.split(cleave_acid)
        fragments = tuple(part + cleave_acid for part in parts[:-1])
        if parts[-1]:
            fragments += (parts[-1],)
        if fragments:
            out[protein] = fragments
    return out


def attach(peptides, attach_acid, silent=True):
    """Partition peptides into (head, tail) at the first attaching acid
    (MCsimlib.py:192-263). attach_acid='cterm' attaches everything by the
    carboxyl terminus (empty tails); otherwise peptides without the
    attach acid are dropped (they cannot stick to the slide)."""
    if attach_acid == "cterm":
        return {protein: tuple((seq, "") for seq in sequences)
                for protein, sequences in peptides.items()}
    out = {}
    for protein, sequences in peptides.items():
        pairs = []
        for seq in sequences:
            head, sep, rest = seq.partition(attach_acid)
            if sep:
                pairs.append((head, sep + rest))
        if pairs:
            out[protein] = tuple(pairs)
    return out


def homogenize_attached(peptides, substitute_acid, target_acids):
    """homogenize for attached (head, tail) pairs (MCsimlib.py:265-279).

    Unlike :func:`homogenize`, the reference applies every target acid
    cumulatively here (no re-replacement bug)."""
    def _sub(s):
        for acid in target_acids:
            s = s.replace(acid, substitute_acid)
        return s

    return {protein: tuple((_sub(head), _sub(tail))
                           for head, tail in sequences)
            for protein, sequences in peptides.items()}


def discard(peptides, label_acids, tot_range, silent=True):
    """Deprecated in the reference (MCsimlib.py:281-311)."""
    raise DeprecationWarning


def truncate_heads(peptides, max_edmans):
    """Deprecated in the reference (MCsimlib.py:345-372)."""
    raise DeprecationWarning


def edman_failure_gaps(peptides, label_acids, p, probability_threshold=0.1,
                       result_queue=None, child_number=0, silent=True):
    """Deprecated in the reference (MCsimlib.py:386-453)."""
    raise DeprecationWarning


def edman_failure_gaps_MP(peptides, label_acids, p, probability_threshold=0.1,
                          child_count=None, silent=True):
    """Deprecated in the reference (MCsimlib.py:585-596)."""
    raise DeprecationWarning


def _split_peptides_for_mp(peptides, child_count):
    """Partition proteins into child_count lists (MCsimlib.py:543-583):
    the first (len % child_count) children get one extra protein."""
    proteins = list(peptides)
    base, extra = divmod(len(proteins), child_count)
    out, at = [], 0
    for child in range(child_count):
        size = base + (1 if child < extra else 0)
        out.append(proteins[at:at + size])
        at += size
    return out


def _exposure_positions(window):
    """A window's exposed positions: each windowed cycle and the one
    before it (the drop between exposures is observable)."""
    return set(window) | {x - 1 for x in window}


def _exposures(position, windows):
    """Exposure counts per color before a position (MCsimlib.py:634-688)."""
    return {acid: sum(x < position for x in _exposure_positions(window))
            for acid, window in windows.items()}


def window_filter(signals, windows):
    """Filter signals down to observable drops (MCsimlib.py:690-726): a
    gap survives if its position AND the position before it are exposed
    for its color; surviving gaps are deduped and re-sorted by
    position."""
    exposed = {acid: _exposure_positions(window)
               for acid, window in windows.items()}
    out = []
    for signal in signals:
        kept = {gap for gap in signal
                if gap[1] in exposed
                and gap[0] in exposed[gap[1]]
                and gap[0] - 1 in exposed[gap[1]]}
        out.append(tuple(sorted(kept, key=lambda g: g[0])))
    return tuple(out)


def perfect(signal_to_protein, b, windows, probability_threshold=0.01):
    """Deprecated in the reference (MCsimlib.py:728-779)."""
    raise DeprecationWarning
