"""Batched lognormal fluor-count sequence scoring (the "v8" fitter core).

Counterpart of fluorosequencingimageanalysis_tpu/ops/lognormal.py. The
reference scores every monotone (non-increasing) fluor-count sequence
against a trace's per-cycle log-intensities with a product of normal pdfs,
one spot at a time in a Pool worker (MCsimlib.py:5387-5493,
_intensities_to_signal_lognormal_v8; enumeration cost
C(n_cycles + max_fluors, n_cycles) per trace).

The sequence set depends only on (n_cycles, max_fluors), so it is
enumerated once into a static table. Per chunk of traces, plain torch ops
compute

  contrib[t, f, v]  per-trace/frame/fluor-value log-pdf contributions
  invalid[t, f, v]  category inconsistency or a deviation above the limit

and ops/fused_lognormal.py::v8_score_fused walks the table for every trace:
the hand-written kernel on a CUDA device, its plain twin on the CPU.
Nothing of size (traces, sequences) exists on the device path. Scoring is
done in log space: the argmax is unchanged, and ties resolve to the first
enumerated sequence exactly like the reference's strict ``>`` update.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .._device import data_devices, resolve_device, shares
from .fused_lognormal import pack_table, v8_score_fused

_TABLE_CACHE = {}
_DEVICE_TABLE_CACHE = {}

# Traces per scoring call. On a CUDA device a chunk costs its (T, F, nv)
# contributions and masks (25 MB at 65,536 traces of 12 frames and 6
# values); the CPU twin builds (chunk, sequences) float32 arrays (101 MB at
# 4,096 traces and 6,188 sequences). Results do not depend on the chunk.
CUDA_CHUNK = 65536
CPU_CHUNK = 4096


def sequence_table(n_frames: int, max_value: int,
                   allow_upsteps: bool = False) -> np.ndarray:
    """(S, n_frames) int32 table of candidate fluor-count sequences, in the
    reference's enumeration order (MCsimlib.py:5426-5431)."""
    key = (n_frames, max_value, allow_upsteps)
    if key not in _TABLE_CACHE:
        values = list(reversed(range(max_value + 1)))
        if allow_upsteps:
            n_seqs = (max_value + 1) ** n_frames
            if n_seqs > 2_000_000:
                raise ValueError(
                    f"allow_upsteps with {n_seqs} sequences is intractable "
                    "(the reference would enumerate the same count).")
            seqs = itertools.product(values, repeat=n_frames)
        else:
            seqs = itertools.combinations_with_replacement(values, n_frames)
        _TABLE_CACHE[key] = np.array(list(seqs), dtype=np.int32)
    return _TABLE_CACHE[key]


def device_table(n_frames, max_value, allow_upsteps, allow_multidrop,
                 device):
    """``sequence_table`` packed for the scorer on ``device``: (tab_t,
    seq_ok) of fused_lognormal.pack_table, converted and uploaded once per
    (shape, options, device)."""
    if max_value > 255:
        raise ValueError(f"max_possible={max_value} does not fit the "
                         "scorer's byte table (at most 255)")
    device = resolve_device(device)
    key = (n_frames, max_value, bool(allow_upsteps), bool(allow_multidrop),
           device)
    if key not in _DEVICE_TABLE_CACHE:
        _DEVICE_TABLE_CACHE[key] = pack_table(
            sequence_table(n_frames, max_value, allow_upsteps),
            allow_multidrop, device)
    return _DEVICE_TABLE_CACHE[key]


def _contrib_invalid(log_intensities, categories, log_fluor_means,
                     beta_sigma, max_deviation):
    """contrib (T, F, nv) float32 and invalid (T, F, nv) bool of a chunk.

    contrib[t, f, 0] = log(1.0) = 0 and, for v > 0, the normal log-pdf of
    the log-intensity around log_fluor_means[v - 1] (MCsimlib.py:5455-5459).
    invalid marks category inconsistency (value 0 where the category is ON,
    value > 0 where it is OFF, MCsimlib.py:5436-5439) and, for v > 0, a
    deviation above ``max_deviation`` sigmas (MCsimlib.py:5444-5451).
    """
    T, F = log_intensities.shape
    x = log_intensities[:, :, None]                       # (T, F, 1)
    mu = log_fluor_means[None, None, :]                   # (1, 1, K)
    dev = (x - mu).abs() / beta_sigma                     # (T, F, K)
    log_norm = -float(np.log(np.float32(beta_sigma) *
                             np.sqrt(np.float32(2.0 * math.pi))))
    logpdf = log_norm - 0.5 * ((x - mu) / beta_sigma) ** 2
    contrib = torch.cat([logpdf.new_zeros((T, F, 1)), logpdf], dim=-1)

    cat = categories[:, :, None]
    on = cat.expand(T, F, log_fluor_means.shape[0])
    # value 0 is consistent where the category is OFF, v > 0 where it is ON.
    invalid = torch.cat([cat, ~(on & (dev <= float(max_deviation)))], dim=-1)
    return contrib.contiguous(), invalid.contiguous()


def _score_batch(log_intensities, categories, table, log_fluor_means,
                 beta_sigma, max_deviation):
    """Score all sequences for a batch of traces.

    log_intensities: (T, F) float32 tensor (log of adjusted intensities;
        <=0 intensities encoded as -10000 like the reference,
        MCsimlib.py:5423).
    categories: (T, F) bool tensor.
    table: ``device_table``'s (tab_t, seq_ok) on the same device; the
        multidrop mask (MCsimlib.py:5440-5443) is part of it.
    log_fluor_means: (K,) float32 tensor, entry v-1 is the mean for value v.

    Returns (best_idx (T,) int32, found (T,) bool, best_logscore (T,)
    float32): the first index of the greatest key, where valid sequences
    floor at a huge-but-finite key so they always beat invalid ones, and
    the raw score at that index.
    """
    contrib, invalid = _contrib_invalid(log_intensities, categories,
                                        log_fluor_means, beta_sigma,
                                        max_deviation)
    tab_t, seq_ok = table
    return v8_score_fused(contrib, invalid, tab_t, seq_ok)


def score_chunk_device(intensities, counts, table, log_fluor_means,
                       beta_sigma, max_deviation):
    """Device-resident chunk scoring for a chained simulate->fit closure:
    the log prep (intensity > 0 -> log, else -10000; MCsimlib.py:5423) and
    the category derivation (count != 0) run on the tensors' device and
    nothing is read back: the per-trace winners stay there. Same
    ``_score_batch`` math as ``score_traces``.

    Precision boundary: ``score_traces`` logs in float64 on the host and
    casts to float32; this path logs in float32 on the device. The two can
    differ by an ulp, so a trace whose two best sequence hypotheses score
    within about an ulp could flip winners between the two paths; for
    lognormal data (beta_sigma >= 0.1 separates hypotheses by many ulps)
    that does not happen in practice."""
    cats = counts != 0
    log_int = torch.where(intensities > 0, torch.log(intensities),
                          -10000.0).to(torch.float32)
    return _score_batch(log_int, cats, table, log_fluor_means, beta_sigma,
                        max_deviation)


def score_traces(intensities, categories, log_fluor_means, beta_sigma,
                 max_possible=5, allow_multidrop=True, allow_upsteps=False,
                 max_deviation=3, chunk=None, device="cuda"):
    """Batched v8 scoring for T traces of F cycles each.

    intensities: (T, F) raw adjusted intensities (host array).
    categories: (T, F) bool.
    chunk: traces per scoring call; None takes ``CUDA_CHUNK`` or
        ``CPU_CHUNK`` by the device. Results are chunk-invariant.
    device: where the scoring runs; a CUDA device launches the hand-written
        kernel, "cpu" runs its plain twin. A device list or a
        ``_device.Mesh`` splits each chunk's rows over its data
        devices (the JAX package's ``mesh=``), one scoring call a chunk
        and device; each trace's score is its own, so the result is the
        one-device result.
    Returns (best_seqs (T, F) int array, found (T,) bool,
             best_logscore (T,) float).

    Every chunk is uploaded and queued before any result is fetched, so the
    device works through them without waiting on the host.
    """
    devs = data_devices(device)
    if chunk is None:
        chunk = CUDA_CHUNK if devs[0].type == "cuda" else CPU_CHUNK
    if len(log_fluor_means) < max_possible:
        # Sequence values above len(log_fluor_means) would have no score
        # entry. The reference dies with IndexError on the same input
        # (MCsimlib.py:5452-5462); be loud and clear instead.
        raise ValueError(
            f"log_fluor_means has {len(log_fluor_means)} entries but "
            f"max_possible={max_possible} needs at least that many")
    intensities = np.asarray(intensities, dtype=np.float64)
    T, F = intensities.shape
    lmii = max_possible
    tab = sequence_table(F, lmii, allow_upsteps)
    tables = {d: device_table(F, lmii, allow_upsteps, allow_multidrop, d)
              for d in devs}
    log_int = np.where(intensities > 0,
                       np.log(np.maximum(intensities, 1e-300)),
                       -10000.0).astype(np.float32)
    cats = np.ascontiguousarray(categories, dtype=bool)
    lfm = torch.from_numpy(np.asarray(log_fluor_means[:lmii],
                                      dtype=np.float32))
    lfms = {d: lfm.to(d) for d in devs}

    pending = []
    for lo in range(0, T, chunk):
        for a, b, d in shares(min(chunk, T - lo), devs):
            a, b = lo + a, lo + b
            pending.append((a, b, _score_batch(
                torch.from_numpy(log_int[a:b]).to(d),
                torch.from_numpy(cats[a:b]).to(d), tables[d], lfms[d],
                float(beta_sigma), float(max_deviation))))
    best_idx = np.zeros((T,), np.int64)
    found = np.zeros((T,), bool)
    best_ls = np.zeros((T,), np.float64)
    for lo, hi, (bi, fo, bl) in pending:
        best_idx[lo:hi] = bi.cpu().numpy()
        found[lo:hi] = fo.cpu().numpy()
        best_ls[lo:hi] = bl.cpu().numpy()
    return tab[best_idx], found, best_ls


def seq_to_signal(best_seq):
    """Convert a fluor-count sequence to the signal tuple convention.

    Parity: MCsimlib.py:5467-5493 — drops of size d at cycle i+1 emit
    ``('A', i+1)`` d times; an empty drop list becomes ``(('A', 0),)``;
    is_zero marks sequences ending at 0 fluors.
    """
    best_seq = [int(v) for v in best_seq]
    starting_intensity = best_seq[0]
    signal = []
    for i, nxt in enumerate(best_seq[1:]):
        tf = best_seq[i] - nxt
        if tf > 0:
            signal += [("A", i + 1)] * tf
        elif tf < 0:
            return None, None, starting_intensity
    signal = tuple(signal) if signal else (("A", 0),)
    is_zero = best_seq[-1] == 0
    return signal, is_zero, starting_intensity
