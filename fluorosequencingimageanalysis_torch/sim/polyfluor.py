"""Error-annotated peptide simulation: PolyfluorSignal / PolyfluorPeptide.

Parity: MCsimlib.py:1929-2532. The default_simulation model
follows [DOI: 10.1371/journal.pcbi.1004080] (dud removal, mock-phase
photobleaching, Edman delays, Edman-phase photobleaching), annotating every
fluor with its event history.
"""

from __future__ import annotations

import math
import random
import string
from collections import namedtuple

from .proteome import _dp
from .trie import PolyfluorSignalTrie


def _bleach_exposure(b, b2, num_exposures, random_point):
    """Sample the 1-based exposure at which a fluor photobleaches, or None
    if it survives all exposures.

    One shared inverse-CDF sampler for the mock-phase and Edman-phase
    bleach draws that the reference writes out three times inline
    (MCsimlib.py:2016-2031, 2084-2106), including its two-phase ``b2``
    quirk: the phase-boundary exposure (x == b2p - 1) accumulates the
    phase-1 term but tests against the phase-2 scale factor.
    """
    if b2 is not None:
        b2r, b2p = b2
    accumulator = 0.0
    for x in range(num_exposures):
        if b2 is None or x < b2p:
            accumulator += math.e ** (-b * x)
        else:
            accumulator += math.e ** (-b2r * x)
        scale_b = b if (b2 is None or (x < b2p and x != b2p - 1)) else b2r
        if accumulator * (1.0 - math.e ** -scale_b) >= random_point:
            return x + 1
    return None


def _edman_delay(d, p, num_cycles, random_point):
    """Sample an Edman delay for a fluor d residues past its predecessor
    (inverse CDF over the _dp Bernoulli-delay pmf, MCsimlib.py:2043-2064;
    degenerate p handled like the reference: p ~ 0 pushes the fluor past
    the horizon, p ~ 1 never delays)."""
    if p < 0.0001:
        return 10 * num_cycles
    if p > 0.9999:
        return 0
    e, accumulator, prior = 0, 0.0, -1.0
    while accumulator - prior > 0.0:
        prior = accumulator
        accumulator += _dp(d, e, p)
        if accumulator >= random_point:
            break
        e += 1
    return e


class PolyfluorSignal:
    """Simulated fluorosequence with error annotations
    (MCsimlib.py:1929-2178)."""

    def __init__(self, peptide, signal=None):
        self.peptide = peptide
        if signal is None:
            self.signal = ()

    def default_simulation(self, num_cycles, p=1.0, b=0.0, u=0.0,
                           random_seed=None, num_mocks=0,
                           adjust_by_mocks=False, p2=None, b2=None):
        random.seed(random_seed)  # None reseeds from entropy, as ref does
        p, b, u = float(p), float(b), float(u)
        if p2 is not None:
            raise NotImplementedError
        signal = tuple((aa[0], aa[1], []) for aa in self.peptide.peptide)
        # Dud removal (position -1).
        modified = [(s[0], -1, [("u", True)]) if random.random() <= u else s
                    for s in signal]
        modified = sorted(modified, key=lambda x: x[1])
        # Mock-phase photobleaching (position -2 placeholder; the true mock
        # exposure is restored from the ("mb", x) annotation at the end).
        updated = list(modified)
        for index, (aa, pos, err) in enumerate(modified):
            if pos == -1:
                continue
            hit = _bleach_exposure(b, b2, num_mocks, random.random())
            if hit is not None:
                updated[index] = (aa, -2, err + [("mb", hit)])
        modified = sorted(updated, key=lambda x: x[1])
        # Edman delays: each surviving fluor delays relative to its
        # predecessor; delays accumulate down the chain.
        updated = list(modified)
        cumulative_e = 0
        for index, (aa, pos, err) in enumerate(modified):
            if pos in (-1, -2):
                continue
            d = (modified[index][1] - modified[index - 1][1] if index > 0
                 else modified[index][1])
            cumulative_e += _edman_delay(d, p, num_cycles, random.random())
            updated[index] = (aa, pos + cumulative_e + num_mocks,
                              err + [("p", cumulative_e)])
        modified = updated
        # Edman-phase photobleaching: a fluor can bleach on any exposure
        # before its (delayed) cleavage position.
        updated = list(modified)
        for index, (aa, pos, err) in enumerate(modified):
            if pos in (-1, -2):
                continue
            exposures = min(num_cycles + 1, pos - num_mocks)
            hit = _bleach_exposure(b, b2, exposures, random.random())
            if hit is not None:
                updated[index] = (aa, hit + num_mocks, err + [("b", hit)])
        modified = updated
        # Restore mock-bleached fluors to their mock positions.
        updated = list(modified)
        for index, (aa, pos, err) in enumerate(modified):
            if pos == -2:
                fp = next((ep for et, ep in err if et == "mb"), None)
                assert fp is not None
                updated[index] = (aa, fp, err)
        modified = sorted(updated, key=lambda x: x[1])
        modified = [(aa, pos, err) for (aa, pos, err) in modified
                    if pos <= num_cycles + num_mocks]
        if adjust_by_mocks:
            raise NotImplementedError
        return tuple((aa, pos, frozenset(err)) for aa, pos, err in modified)

    @staticmethod
    def strip_errors(signal):
        return (tuple((aa, pos) for aa, pos, err in signal),
                tuple(err for err in signal))

    def simulation_v2(self, num_cycles, p, b, u, random_seed=None,
                      num_mocks=0):
        """Unimplemented in the reference (MCsimlib.py:2162-2178)."""
        raise NotImplementedError()


class PolyfluorPeptide:
    """Multiply-labeled peptide as ((aa, position), ...)
    (MCsimlib.py:2312-2397)."""

    @staticmethod
    def sequence_to_peptide(sequence, acids=None):
        return tuple((acid, index + 1)
                     for index, acid in enumerate(sequence)
                     if acid in acids)

    @staticmethod
    def proteome_to_peptides(proteome, acids=None):
        return {protein: PolyfluorPeptide.sequence_to_peptide(
            sequence=sequence, acids=acids)
            for protein, sequence in proteome.items()}

    def __init__(self, parent_protein=None, sequence=None, acids=None,
                 peptide=None):
        self.parent_protein = parent_protein if parent_protein else ""
        if sequence is None:
            self.peptide = peptide if peptide is not None else ()
        else:
            self.peptide = PolyfluorPeptide.sequence_to_peptide(sequence,
                                                                acids)

    def default_simulation(self, num_cycles, p=1.0, b=0.0, u=0.0, num_sims=1,
                           num_mocks=0, adjust_by_mocks=False, p2=None,
                           b2=None):
        signal = PolyfluorSignal(peptide=self, signal=None)
        return tuple(signal.default_simulation(
            num_cycles=num_cycles, p=p, b=b, u=u, random_seed=None,
            num_mocks=num_mocks, adjust_by_mocks=adjust_by_mocks, p2=p2,
            b2=b2) for _ in range(num_sims))

    def default_simulation_as_trie(self, num_cycles, p=1.0, b=0.0, u=0.0,
                                   num_sims=1, p2=None, b2=None):
        signal = PolyfluorSignal(peptide=self, signal=None)
        result = PolyfluorSignalTrie((None, None, None))
        for _ in range(num_sims):
            s = signal.default_simulation(num_cycles=num_cycles, p=p, b=b,
                                          u=u, random_seed=None, p2=p2, b2=b2)
            result.add_descendant(s, self.parent_protein)
        return result

    def default_simulation_as_dict(self, num_cycles, p=1.0, b=0.0, u=0.0,
                                   num_sims=1, num_mocks=0,
                                   adjust_by_mocks=False, p2=None, b2=None):
        signal = PolyfluorSignal(peptide=self, signal=None)
        d = {}
        for _ in range(num_sims):
            seq = signal.default_simulation(
                num_cycles=num_cycles, p=p, b=b, u=u, random_seed=None,
                num_mocks=num_mocks, adjust_by_mocks=adjust_by_mocks, p2=p2,
                b2=b2)
            stripped_seq, stripped_err = PolyfluorSignal.strip_errors(seq)
            d.setdefault(stripped_seq, {}).setdefault(stripped_err, 0)
            d[stripped_seq][stripped_err] += 1
        return d


class PolyfluorPeptide_v2:
    """State-tracking simulation variant (MCsimlib.py:2400-2532)."""

    FluorEvent = namedtuple("FluorEvent", ["original_position",
                                           "original_amino_acid", "event",
                                           "cycle_number"])

    @staticmethod
    def _define_reserved_character(sequence, labels):
        characters_used = set(labels) | set(sequence)
        possible = set(string.ascii_letters) | set(string.digits)
        available = possible - characters_used
        if not available:
            raise ValueError("sequence and labels use all possible letters "
                             "and digits. At least one must remain available "
                             "as a reserved letter for this class.")
        return available.pop()

    def __init__(self, sequence, labels, parent_protein=None):
        self.molecule = tuple(enumerate(sequence, start=1))
        self.labels = labels
        self.parent_protein = parent_protein if parent_protein else ""
        self.reserved_character = self._define_reserved_character(sequence,
                                                                  labels)

    def _destroy_live(self, molecule, buffer, cycle_number, event, fire):
        """Walk the still-live entries (v2 molecules hold BARE reserved
        chars for destroyed slots, unlike the tuple-keeping newer
        module); each one for which ``fire()`` is true emits an event
        into ``buffer`` and is replaced in place. One uniform draw per
        live entry — the stream order of MCsimlib.py:2455-2478."""
        for i, entry in enumerate(molecule):
            if entry != self.reserved_character and fire():
                buffer.append(self.FluorEvent(entry[0], entry[1], event,
                                              cycle_number))
                molecule[i] = self.reserved_character

    def _mock(self, molecule, signal, history, removal_buffer, cycle_number,
              **experimental_parameters):
        pass

    def _edman(self, molecule, signal, history, removal_buffer, cycle_number,
               **experimental_parameters):
        if not molecule:
            return
        if molecule[0] == self.reserved_character:
            # Destroyed-dye placeholder: removable, never emits.
            # (The reference would crash unpacking it — MCsimlib.py:2442
            # — a latent bug its newer peptide_simulator module fixed by
            # keeping (char, pos) tuples; we guard instead.)
            if random.random() < experimental_parameters["p"]:
                molecule.pop(0)
            return
        position, amino_acid = molecule[0]
        if random.random() < experimental_parameters["p"]:
            if amino_acid in self.labels:
                removal_buffer.append(self.FluorEvent(
                    position, amino_acid, "edman", cycle_number))
            molecule.pop(0)
        else:
            history.append(self.FluorEvent(
                position, amino_acid, "edman error", cycle_number))

    def _tirf(self, molecule, signal, history, removal_buffer, cycle_number,
              **experimental_parameters):
        per_cycle_b = experimental_parameters.get(
            "per_cycle_b", math.e ** -experimental_parameters["b"])
        self._destroy_live(molecule, removal_buffer, cycle_number,
                           "dye destruction",
                           lambda: random.random() > per_cycle_b)
        # Drain LIFO into both records (MCsimlib.py:2470-2474).
        while removal_buffer:
            event = removal_buffer.pop()
            history.append(event)
            signal.append(event)

    def _dud(self, molecule, signal, history, removal_buffer, cycle_number,
             **experimental_parameters):
        self._destroy_live(
            molecule, history, cycle_number, "dye dud",
            lambda: random.random() < experimental_parameters["u"])

    def simulate_type1(self, num_mocks, num_edmans, random_seed=None,
                       **experimental_parameters):
        """Assumes C-term anchoring."""
        random.seed(random_seed)  # None reseeds from entropy, as ref does
        molecule = list(self.molecule)
        signal, history, removal_buffer = [], [], []
        state = (molecule, signal, history, removal_buffer)
        cycle_number = 0
        self._dud(*state, cycle_number, **experimental_parameters)
        schedule = [self._mock] * num_mocks + [self._edman] * num_edmans
        for action in schedule:
            self._tirf(*state, cycle_number, **experimental_parameters)
            action(*state, cycle_number, **experimental_parameters)
            cycle_number += 1
        self._tirf(*state, cycle_number, **experimental_parameters)
        return molecule, signal, history, removal_buffer, cycle_number
