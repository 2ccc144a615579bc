"""Event-driven peptide simulator (host-exact).

Parity: peptide_simulator.py:1-568 — composable cycle
actions (dud, mock/edman, strip, tirf, count, positions) applied to a
molecule, with per-cycle dye counts and lognormal photometries. This is the
exact single-molecule model; the vectorized many-molecule path lives in
sim/dye_sim.py and is validated against this one statistically.
"""

from __future__ import annotations

import math
import random
import string
from collections import defaultdict, deque, namedtuple
from itertools import combinations

import numpy as np

FluorEvent = namedtuple("FluorEvent", ["original_position",
                                       "original_amino_acid", "event_name",
                                       "cycle_number", "message"])


def _define_reserved_character(sequence, labels):
    characters_used = set(labels) | set(sequence)
    possible = set(string.ascii_letters) | set(string.digits)
    available = possible - characters_used
    if not available:
        raise ValueError("sequence and labels use all possible "
                         "string.letters and string.digits. At least one "
                         "must remain available as a reserved letter for "
                         "simulation purposes.")
    return available.pop()


def _bleach_labeled(molecule, event_buffer, cycle, labels,
                    reserved_character, event_name, lose):
    """Walk the molecule's still-labeled residues in order; each one for
    which ``lose()`` fires emits a FluorEvent and is replaced in place by
    the reserved character. ``lose`` is called once per labeled residue
    (the per-residue uniform draw IS the reference's stream order).

    Parity note: the reference stores (reserved_char, position) in the
    (position, amino_acid) slot order-swapped (peptide_simulator.py:98);
    downstream only checks membership of element [1] in labels, so we
    store the consistent (position, reserved_char) instead."""
    for i, (position, amino_acid) in enumerate(molecule):
        if amino_acid in labels and lose():
            event_buffer.append(
                FluorEvent(position, amino_acid, event_name, cycle, None))
            molecule[i] = (position, reserved_character)


def _make_mock(reserved_character, labels, success_event_name=None,
               failure_event_name=None, **experimental_parameters):
    def _mock(molecule, event_buffer, cycle_number):
        pass
    return _mock


def _make_edman(reserved_character, labels, success_event_name="edman",
                failure_event_name="edman failure",
                **experimental_parameters):
    p = experimental_parameters["p"]

    def _edman(molecule, event_buffer, cycle_number):
        if not molecule:
            return
        position, amino_acid = molecule[0]
        if random.random() < p:
            if amino_acid in labels:
                event_buffer.append(FluorEvent(
                    position, amino_acid, success_event_name,
                    cycle_number[0], None))
            molecule.pop(0)
        else:
            event_buffer.append(FluorEvent(
                position, amino_acid, failure_event_name,
                cycle_number[0], None))
    return _edman


def _make_tirf(reserved_character, labels, success_event_name=None,
               failure_event_name="dye destruction",
               **experimental_parameters):
    """Photobleaching events occur during an exposure."""
    per_cycle_b = experimental_parameters.get(
        "per_cycle_b", math.e ** -experimental_parameters["b"])

    def _tirf(molecule, event_buffer, cycle_number):
        _bleach_labeled(molecule, event_buffer, cycle_number[0], labels,
                        reserved_character, failure_event_name,
                        lambda: random.random() > per_cycle_b)
    return _tirf


def _make_dud(reserved_character, labels, success_event_name=None,
              failure_event_name="dye dud", **experimental_parameters):
    u = experimental_parameters["u"]

    def _dud(molecule, event_buffer, cycle_number):
        _bleach_labeled(molecule, event_buffer, cycle_number[0], labels,
                        reserved_character, failure_event_name,
                        lambda: random.random() < u)
    return _dud


def _increment_cycle(molecule, event_buffer, cycle_number):
    cycle_number[0] = cycle_number[0] + 1


def _make_count_dyes(reserved_character, labels,
                     success_event_name="dye count", failure_event_name=None,
                     **experimental_parameters):
    def _count_dyes(molecule, event_buffer, cycle_number):
        counts = {L: 0 for L in labels}
        for _, amino_acid in molecule:
            if amino_acid in labels:
                counts[amino_acid] += 1
        event_buffer.append(FluorEvent(
            None, None, success_event_name, cycle_number[0], counts))
    return _count_dyes


def _make_strip_surface(reserved_character, labels, success_event_name=None,
                        failure_event_name="surface strip",
                        **experimental_parameters):
    s, sc = experimental_parameters["s"], experimental_parameters["sc"]
    s2 = experimental_parameters["s2"]

    def _strip_surface(molecule, event_buffer, cycle_number):
        # ONE draw per cycle; when it fires, every labeled residue is
        # lost (lose=True consumes no further stream draws).
        using_s = s if cycle_number[0] <= sc else s2
        if random.random() < using_s:
            _bleach_labeled(molecule, event_buffer, cycle_number[0],
                            labels, reserved_character,
                            failure_event_name, lambda: True)
    return _strip_surface


def _make_get_dye_positions(reserved_character, labels,
                            success_event_name="dye count",
                            failure_event_name=None,
                            **experimental_parameters):
    def _get_dye_positions(molecule, event_buffer, cycle_number):
        labeled = tuple(pa for pa in molecule if pa[1] in labels)
        event_buffer.append(FluorEvent(
            None, None, success_event_name, cycle_number[0], labeled))
    return _get_dye_positions


def simulate_dye_counts(sequence, labels, num_mocks, num_edmans,
                        num_simulations=1, random_seed=None,
                        reserved_character=None, **experimental_parameters):
    """Assumes C-term attachment (peptide_simulator.py:190-319)."""
    random.seed(random_seed)  # None reseeds from entropy, as ref does
    if reserved_character is None:
        reserved_character = _define_reserved_character(sequence, labels)
    labels = set(labels)
    kwargs = dict(reserved_character=reserved_character, labels=labels,
                  **experimental_parameters)
    _dud = _make_dud(**kwargs)
    _mock = _make_mock(**kwargs)
    _edman = _make_edman(**kwargs)
    _tirf = _make_tirf(**kwargs)
    _count_dyes = _make_count_dyes(**kwargs)
    _strip_surface = _make_strip_surface(**kwargs)
    _get_dye_positions = _make_get_dye_positions(
        success_event_name="dye positions", **kwargs)
    experimental_sequence = (
        [_dud, _tirf, _count_dyes, _get_dye_positions, _increment_cycle] +
        [_mock, _strip_surface, _tirf, _count_dyes, _get_dye_positions,
         _increment_cycle] * num_mocks +
        [_edman, _strip_surface, _tirf, _count_dyes, _get_dye_positions,
         _increment_cycle] * num_edmans)
    results = []
    for _ in range(num_simulations):
        molecule = list(enumerate(sequence, start=1))
        event_buffer = []
        cycle_number = [0]
        for action in experimental_sequence:
            action(molecule=molecule, event_buffer=event_buffer,
                   cycle_number=cycle_number)
        dye_decrements = []
        dye_counts = defaultdict(list)
        dye_position_tracker = []
        for event in event_buffer:
            if event.event_name in ("edman", "dye destruction", "dye dud",
                                    "surface strip"):
                dye_decrements.append((event.original_amino_acid,
                                      event.cycle_number))
            elif event.event_name == "dye count":
                for label, count in event.message.items():
                    dye_counts[label].append(count)
            elif event.event_name == "dye positions":
                dye_position_tracker.append(event.message)
        dye_counts = {label: tuple(count)
                      for label, count in dye_counts.items()}
        dye_decrements = tuple(sorted(dye_decrements, key=lambda x: x[1]))
        results.append((dye_decrements, dye_counts, event_buffer,
                        tuple(dye_position_tracker)))
    return results


def _superdye_conversions(deltas, num_remaining, number, rate):
    """Per-draw cumulative superdye conversion counts, one list per
    draw: within a draw, one uniform per dye lost in each cycle (cycle
    order) then one per surviving dye, cumulated from the back so entry
    c counts conversions at or after cycle c. Stream-order identical to
    the reference's nested loop (peptide_simulator.py:340-352) — these
    draws happen even at rate 0, so callers must not skip this."""
    out = []
    for _ in range(number):
        per_cycle = [sum(random.random() < rate for _ in range(drop))
                     for drop in deltas]
        per_cycle[-1] += sum(random.random() < rate
                             for _ in range(num_remaining))
        out.append(list(reversed(np.cumsum(per_cycle[::-1]).tolist())))
    return out


def _pairwise_ddif_total(dye_positions, distance_ddif):
    """Sum of each dye's distance-DDIF attenuation: every unordered pair
    contributes its |distance| lookup to BOTH endpoints
    (peptide_simulator.py:361-376)."""
    total = 0.0
    for (pos1, _), (pos2, _) in combinations(dye_positions, 2):
        total += 2 * distance_ddif.get(abs(pos2 - pos1), 0)
    return total


def simulate_photometries(dye_counts, beta, beta_sigma, number, ddif=None,
                          dye_position_tracker=None, distance_ddif=None,
                          superdye_rate=0, superdye_factor=1):
    """Lognormal intensities from dye counts
    (peptide_simulator.py:322-435), incl. DDIF / distance-DDIF / superdyes.
    """
    category = tuple(seq != 0 for seq in dye_counts)
    if not (0 <= superdye_rate <= 1):
        raise ValueError("superdye_rate must be between 0 and 1 (inclusive).")
    deltas = [0] + [prev - cur
                    for prev, cur in zip(dye_counts, dye_counts[1:])]
    assert sum(deltas) == dye_counts[0] - dye_counts[-1]
    conversions = _superdye_conversions(deltas, dye_counts[-1], number,
                                        superdye_rate)
    log_beta = math.log(beta)

    def _cycle_rows(base_count, shift, cycle_idx):
        """The `number` lognormal draws for one cycle (stream-exact:
        one size=number draw at rate 0, else one size=1 draw per n)."""
        if base_count == 0:
            return [0.0] * number
        if superdye_rate == 0:
            return np.random.lognormal(
                mean=log_beta + math.log(base_count) - shift,
                sigma=beta_sigma, size=number)
        return [float(np.random.lognormal(
            mean=log_beta - shift + math.log(
                base_count + conversions[n][cycle_idx] * superdye_factor),
            sigma=beta_sigma, size=1)[0]) for n in range(number)]

    if distance_ddif is not None:
        if dye_position_tracker is None:
            raise ValueError("distance_ddif requires dye_position_tracker.")
        intensities = [
            _cycle_rows(len(dp), _pairwise_ddif_total(dp, distance_ddif), c)
            for c, dp in enumerate(dye_position_tracker)]
    else:
        if ddif is None:
            ddif = [0.0] * len(dye_counts)
        intensities = [
            _cycle_rows(seq, ddif[seq - 1] if seq > 0 else 0.0, c)
            for c, seq in enumerate(dye_counts)]
    return category, tuple(zip(*intensities))


def peptide_simulation(sequence, labels, num_mocks, num_edmans,
                       num_simulations=1, random_seed=None,
                       num_processes=None, reserved_character=None,
                       **experimental_parameters):
    """Simulate many molecules + their photometries
    (peptide_simulator.py:438-502). The Pool fan-out is replaced by the
    vectorized batch simulator for the dye-count phase when the model
    permits (no per-event consumers need the event_buffer), falling back
    to the exact host loop otherwise.
    """
    labels = set(labels)
    results = simulate_dye_counts(sequence, labels, num_mocks, num_edmans,
                                  num_simulations,
                                  random_seed if random_seed is not None
                                  else random.random(),
                                  reserved_character,
                                  **experimental_parameters)
    merged = deque()
    beta = experimental_parameters["beta"]
    beta_sigma = experimental_parameters["beta_sigma"]
    ddif = experimental_parameters.get("ddif", None)
    distance_ddif = experimental_parameters.get("distance_ddif", None)
    superdye_rate = experimental_parameters.get("superdye_rate", 0)
    superdye_factor = experimental_parameters.get("superdye_factor", 2)
    while results:
        (dye_decrements, dye_counts, event_buffer,
         dye_position_tracker) = results.pop()
        categories_and_intensities = {
            L: simulate_photometries(
                dye_counts=counts, beta=beta, beta_sigma=beta_sigma,
                number=1, ddif=ddif,
                dye_position_tracker=dye_position_tracker,
                distance_ddif=distance_ddif, superdye_rate=superdye_rate,
                superdye_factor=superdye_factor)
            for L, counts in dye_counts.items()}
        merged.append((dye_decrements, dye_counts, event_buffer,
                       categories_and_intensities))
    return merged


def _pairwise(iterable):
    import itertools
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def convert_to_oldstyle(merged_dye_count_results):
    """Convert to the pre-peptide_simulator signal format
    (peptide_simulator.py:505-568)."""
    oldstyle_results = deque()
    for (dye_decrements, dye_counts, event_buffer,
         categories_and_intensities) in merged_dye_count_results:
        amino_acid_set = set(aa for aa, position in dye_decrements)
        if len(amino_acid_set) > 1:
            raise Exception("Oldstyle only works with one label.")
        oldstyle_decrements = tuple(("A", position)
                                    for amino_acid, position in dye_decrements
                                    if position != 0)
        if len(dye_counts) > 1:
            raise Exception("Oldstyle only works with one label.")
        counts = next(iter(dye_counts.values()))
        drops = sum(c1 - c2 for c1, c2 in _pairwise(counts))
        if len(oldstyle_decrements) == 0:
            oldstyle_decrements = (("A", 0),)
            assert drops == 0
        else:
            assert drops == len(oldstyle_decrements)
        oldstyle_ci = {"A": (category, (intensities,))
                       for label, (category, (intensities,))
                       in categories_and_intensities.items()
                       if True in category}
        if oldstyle_ci:
            oldstyle_results.append((oldstyle_decrements, dye_counts,
                                     event_buffer, oldstyle_ci))
    return oldstyle_results
