"""ctypes binding of the native randsiggen batch signal sampler
(csrc/randsiggen.cpp).

Counterpart of fluorosequencingimageanalysis_tpu/native/randsiggen.py; the
C++ source is that package's, line for line (one comment names the
reference without a machine path). The reference calls a C generator,
``randsiggen.random_signal(peptide, protein, p, b, u, rsg_windows,
batch_size, seed, trie)`` (MCsimlib.py:1823-1830), whose source is absent
from its tree; here the native sampler returns flat arrays and the trie is
filled in Python. ``_build`` compiles the source with g++ at first use; a
failed build raises with the compiler's output. There is no Python
fallback: ``sim/signals.py::monte_carlo_trie`` draws from another stream,
so a quiet switch would change a seeded result.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


def _prototypes(lib):
    fn = lib.rsg_random_signal_batch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,           # head, tail
        ctypes.c_double, ctypes.c_double, ctypes.c_double,  # p, b, u
        ctypes.c_char_p,                             # window_acids
        np.ctypeslib.ndpointer(np.int32, flags="C"),  # positions
        np.ctypeslib.ndpointer(np.int32, flags="C"),  # offsets
        ctypes.c_int32, ctypes.c_int32,              # n_acids, batch
        ctypes.c_uint64, ctypes.c_int32,             # seed, max_len
        np.ctypeslib.ndpointer(np.int32, flags="C"),  # out_positions
        np.ctypeslib.ndpointer(np.int8, flags="C"),   # out_acids
        np.ctypeslib.ndpointer(np.int32, flags="C"),  # out_lengths
    ]


def _load():
    lib = _build.load("randsiggen")
    _prototypes(lib)
    return lib


def _pack_windows(windows):
    acids = list(windows)
    offsets = [0]
    flat = []
    for a in acids:
        flat.extend(int(x) for x in windows[a])
        offsets.append(len(flat))
    return ("".join(acids).encode("ascii"),
            np.asarray(flat, dtype=np.int32),
            np.asarray(offsets, dtype=np.int32),
            len(acids))


def random_signal_batch(peptide, p, b, u, windows, batch_size, seed,
                        max_len=None):
    """Generate ``batch_size`` signals for one (head, tail) peptide.

    Returns a list of signal tuples ``((pos, acid), ...)`` with the
    distribution of sim/signals.py::random_signal (MCsimlib.py:863-1074).
    """
    lib = _load()
    head, tail = peptide
    if max_len is None:
        n_fluors = sum(head.count(a) + tail.count(a) for a in windows)
        max_len = max(4, n_fluors + 1)
    acids_b, positions, offsets, n_acids = _pack_windows(windows)
    out_pos = np.empty(batch_size * max_len, dtype=np.int32)
    out_acid = np.empty(batch_size * max_len, dtype=np.int8)
    out_len = np.empty(batch_size, dtype=np.int32)
    rc = lib.rsg_random_signal_batch(
        head.encode("ascii"), tail.encode("ascii"),
        float(p), float(b), float(u), acids_b, positions, offsets,
        np.int32(n_acids), np.int32(batch_size), np.uint64(seed),
        np.int32(max_len), out_pos, out_acid, out_len)
    if rc != 0:  # max_len covers every fluor, so this cannot happen
        raise RuntimeError("randsiggen signal overflowed max_len")
    # Bulk conversion once; per-element numpy scalar access is slower.
    pos_l = out_pos.reshape(batch_size, max_len).tolist()
    acid_l = out_acid.reshape(batch_size, max_len).tolist()
    len_l = out_len.tolist()
    return [tuple(zip(pos_l[i][:len_l[i]],
                      map(chr, acid_l[i][:len_l[i]])))
            for i in range(batch_size)]


def monte_carlo_trie_native(peptides, p, b, u, windows, sample_size=100,
                            random_seed=None, silent=True):
    """monte_carlo_trie (MCsimlib.py:1787-1849) over the native sampler:
    signals generated in C++ in batches, accumulated into a SignalTrie in
    Python (the reference's intended split, MCsimlib.py:1823-1834)."""
    from ..sim.trie import SignalTrie
    rng = np.random.default_rng(random_seed)
    return_trie = SignalTrie((None, None))
    for protein in peptides:
        for peptide in peptides[protein]:
            remaining = sample_size
            while remaining > 0:
                batch = min(10 ** 4, remaining)
                seed = int(rng.integers(0, 2 ** 63 - 1))
                for signal in random_signal_batch(peptide, p, b, u, windows,
                                                  batch, seed):
                    if signal:
                        return_trie.add_descendant(
                            sorted(signal, key=lambda x: x[0]), protein)
                remaining -= batch
    return return_trie
