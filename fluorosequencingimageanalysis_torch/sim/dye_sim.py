"""Batched Monte-Carlo dye simulation on one device (the batched randsiggen).

Counterpart of fluorosequencingimageanalysis_tpu/sim/dye_sim.py. The
reference simulates one molecule at a time in a Python event loop
(peptide_simulator.py:190-319; ``sim/events.py`` here). This module moves
the whole population in lockstep: the state is a [num_sims, seq_len] bool
dye-aliveness matrix, a [num_sims] int32 cleaved-prefix counter and a
[num_sims, seq_len] int32 loss-cycle matrix, and each cycle is a few masked
updates (a Python loop over cycles with no host read).

Each simulation is split in two:

- a draw step (``draw_simulation``, ``draw_normals``) that makes every
  random number at once with a ``torch.Generator`` on the device, seeded
  from the caller's seed, in the JAX package's layout: per-dye dud and
  initial-bleach uniforms, then per cycle one Edman and one strip uniform
  per molecule and one bleach uniform per dye;
- a core (``simulate_from_draws``, ``photometries_from_normals``) that
  takes the draws and does the arithmetic. The JAX package draws from
  ``jax.random``, whose streams torch cannot reproduce, so the tests put
  the JAX package's own draws in place of the draw step and hold the
  outputs equal.

Multi-colour sampling is joint: every label colour shares the molecule's
Edman and strip draws, while dud and bleach are per dye. Per-dye loss
cycles are kept so the reference's ``dye_decrements`` tuples can be rebuilt
exactly (dud and initial-bleach losses at cycle 0, in-cycle losses at their
1-based cycle number). The event order matches the reference's action list
(peptide_simulator.py:251-277): dud, initial bleach, count; then per cycle
Edman (or mock), strip, bleach, count.

Left out: the JAX package's int8/int16 and uint16 fixed-point packs and its
power-of-two chunk padding, which serve its device link and compiler.
Counts come back as int32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .._transfer import fetch, wait


class SimDraws(NamedTuple):
    """The uniforms one simulation consumes (any float dtype; comparisons
    are made in it)."""
    dud: torch.Tensor     # (N, L) per-dye dud draws
    tirf0: torch.Tensor   # (N, L) per-dye initial-bleach draws
    edman: torch.Tensor   # (C, N) per-cycle Edman draws (mock cycles too)
    strip: torch.Tensor   # (C, N) per-cycle strip draws
    tirf: torch.Tensor    # (C, N, L) per-cycle per-dye bleach draws


def _generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def draw_simulation(num_sims, seq_len, num_cycles, seed, device):
    """Every uniform of one simulation, float32 on ``device``, from a
    generator seeded with ``seed``."""
    gen = _generator(seed, device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    return SimDraws(uniform(num_sims, seq_len), uniform(num_sims, seq_len),
                    uniform(num_cycles, num_sims),
                    uniform(num_cycles, num_sims),
                    uniform(num_cycles, num_sims, seq_len))


def draw_normals(shape, seed, device):
    """Standard-normal float32 draws of one photometry matrix."""
    return torch.randn(shape, generator=_generator(seed, device),
                       device=device)


def _count_colors(alive, color_ids, n_colors):
    return torch.stack([(alive & (color_ids == k)).sum(dim=1,
                                                       dtype=torch.int32)
                        for k in range(n_colors)], dim=-1)


def simulate_from_draws(draws, color_ids, num_mocks, n_colors, p,
                        per_cycle_b, u, s, sc, s2):
    """The lockstep simulation of the JAX package's ``_simulate_batch`` on
    given draws.

    color_ids: (L,) label colour per position, -1 where unlabelled.
    Returns:
      counts: (N, C + 1, n_colors) int32; counts[:, 0] is the count after
          the dud and initial-bleach losses.
      loss: (N, L) int32, the cycle at which each labelled dye stopped
          counting (0 = dud or initial exposure, c >= 1 = during cycle c,
          -1 = counting at the end, and for unlabelled positions).
      dud: (N, L) bool, where the cycle-0 loss was a dud (the host event
          loop emits every dud before the initial bleaches, which fixes the
          order of the cycle-0 ``dye_decrements``).
    """
    N, L = draws.dud.shape
    num_cycles = draws.edman.shape[0]
    dev = draws.dud.device
    color_ids = torch.as_tensor(np.asarray(color_ids, np.int64), device=dev)
    labeled = color_ids >= 0
    loss = torch.full((N, L), -1, dtype=torch.int32, device=dev)
    # alive: currently counting (labelled, not dud, bleached, stripped or
    # Edman-cleaved).
    alive = labeled[None, :].expand(N, L)
    # Dud removal (peptide_simulator.py:102-120), then the initial exposure.
    dud = alive & (draws.dud < u)
    loss.masked_fill_(dud, 0)
    alive = alive & ~dud
    bleach0 = alive & (draws.tirf0 > per_cycle_b)
    loss.masked_fill_(bleach0, 0)
    alive = alive & ~bleach0
    removed = torch.zeros((N,), dtype=torch.int32, device=dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    counts = [_count_colors(alive, color_ids, n_colors)]
    for c in range(num_cycles):
        cycle_number = c + 1
        if c >= num_mocks:
            # Edman: success w.p. p pops the current N-terminal residue; a
            # dye still counting there is lost at this cycle.
            success = (draws.edman[c] < p) & (removed < L)
            popped = success[:, None] & (pos == removed[:, None])
            loss.masked_fill_(popped & alive, cycle_number)
            alive = alive & ~popped
            removed = removed + success.to(torch.int32)
        # Strip: whole-molecule dye loss w.p. s, s2 after cycle sc (the
        # reference compares the 1-based cycle number, peptide_simulator.py
        # :148-169).
        using_s = s if cycle_number <= sc else s2
        stripped = (draws.strip[c] < using_s)[:, None] & alive
        loss.masked_fill_(stripped, cycle_number)
        alive = alive & ~stripped
        # Bleach: per-dye survival of each exposure.
        bleach = alive & (draws.tirf[c] > per_cycle_b)
        loss.masked_fill_(bleach, cycle_number)
        alive = alive & ~bleach
        counts.append(_count_colors(alive, color_ids, n_colors))
    return torch.stack(counts, dim=1), loss, dud


def _model(sequence, labels, params):
    """(sorted labels, colour id per position, p, per_cycle_b, u, s, sc,
    s2) of a simulation's arguments, as the JAX package reads them."""
    labels_sorted = tuple(sorted(set(labels)))
    color_of = {a: k for k, a in enumerate(labels_sorted)}
    color_ids = np.array([color_of.get(aa, -1) for aa in sequence],
                         dtype=np.int32)
    per_cycle_b = float(params.get("per_cycle_b", math.e ** -params["b"]))
    return (labels_sorted, color_ids, float(params["p"]), per_cycle_b,
            float(params["u"]), float(params.get("s", 0.0)),
            int(params.get("sc", 0)), float(params.get("s2", 0.0)))


def _simulate(sequence, labels, num_mocks, num_edmans, num_simulations,
              seed, device, params):
    labels_sorted, color_ids, p, per_cycle_b, u, s, sc, s2 = _model(
        sequence, labels, params)
    draws = draw_simulation(int(num_simulations), len(sequence),
                            int(num_mocks) + int(num_edmans), seed,
                            resolve_device(device))
    with torch.no_grad():
        counts, loss, dud = simulate_from_draws(
            draws, color_ids, int(num_mocks), len(labels_sorted), p,
            per_cycle_b, u, s, sc, s2)
    return labels_sorted, counts, loss, dud


def simulate_dye_counts_batched(sequence, labels, num_mocks, num_edmans,
                                num_simulations, seed=0,
                                return_loss_cycles=False, device_out=False,
                                device="cuda", **params):
    """Batched equivalent of sim.events.simulate_dye_counts.

    One colour (``len(set(labels)) == 1``): returns ``(counts
    (num_simulations, num_cycles + 1) int32, label)``. Several colours:
    ``(counts (num_simulations, num_cycles + 1, n_colors), labels_tuple)``
    with colours in ``sorted(labels)`` order and exact joint statistics
    (shared per-molecule Edman and strip draws).

    ``return_loss_cycles=True`` appends the (num_simulations, seq_len)
    loss-cycle matrix and the bool dud matrix (see ``simulate_from_draws``)
    for rebuilding dye_decrements. ``device_out=True`` returns the tensors
    on the device (for chaining into photometries and scoring) instead of
    numpy arrays. ``device``: where the draws and the simulation run.
    """
    labels_sorted, counts, loss, dud = _simulate(
        sequence, labels, num_mocks, num_edmans, num_simulations, seed,
        device, params)
    if not device_out:
        counts, loss, dud = (t.cpu().numpy() for t in (counts, loss, dud))
    if len(labels_sorted) == 1:
        out = (counts[:, :, 0], labels_sorted[0])
    else:
        out = (counts, labels_sorted)
    if return_loss_cycles:
        out = out + (loss, dud)
    return out


def decrements_from_loss_cycles(sequence, loss_row, dud_row=None):
    """One molecule's reference-format dye_decrements tuple from its
    loss-cycle row: ((amino_acid, cycle), ...) sorted by cycle, including
    the cycle-0 dud/initial-bleach entries (simulate_dye_counts'
    bookkeeping, sim/events.py:203-219).

    dud_row (from _simulate_batch) restores the host event-buffer order
    WITHIN cycle 0: all dud losses precede all initial-tirf losses
    (each group in position order) — without it, cycle-0 entries come
    out purely position-ordered, which can disagree on multi-label
    peptides where a later-position dye duds while an earlier one
    bleaches."""
    decs = []
    for i, c in enumerate(loss_row):
        if c < 0:
            continue
        tirf0 = int(c == 0 and dud_row is not None and not dud_row[i])
        decs.append((int(c), tirf0, sequence[i]))
    decs.sort(key=lambda x: (x[0], x[1]))  # stable: position order kept
    return tuple((aa, c) for c, _, aa in decs)


def photometries_from_normals(z, counts, log_beta, beta_sigma, ddif):
    """Lognormal intensities of a dye-count matrix on given standard
    normals ``z`` (the JAX package's ``_photometries_kernel``): float32
    ``exp(log_beta + log(n) - ddif[n - 1] + beta_sigma * z)`` where the
    count n > 0, exactly 0 where it is 0. ``ddif``: (D,) float32 tensor on
    the device of ``counts``; counts above D use its last entry."""
    safe = counts.clamp_min(1)
    idx = (safe - 1).clamp_max(ddif.shape[0] - 1).long()
    mean = (float(np.float32(log_beta)) + torch.log(safe.to(torch.float32))
            - ddif[idx])
    out = torch.exp(mean + float(np.float32(beta_sigma)) * z)
    return torch.where(counts == 0, torch.zeros((), dtype=out.dtype,
                                                device=out.device), out)


def _ddif_tensor(ddif, device):
    arr = (np.zeros((1,), np.float32) if ddif is None
           else np.asarray(ddif, dtype=np.float32))
    return torch.from_numpy(arr).to(device)


def simulate_photometries_batched(counts, beta, beta_sigma, seed=0,
                                  ddif=None, device_out=False, device=None):
    """Lognormal intensities for an (N, C) dye-count matrix in one pass,
    float32 on the device (the equivalent of sim.events.
    simulate_photometries with number=1 for each molecule; no superdyes or
    distance DDIF, which take the host path).

    ``counts``: a tensor (used where it lies unless ``device`` is given) or
    an array (uploaded to ``device``, default "cuda"). ``device_out=True``
    returns the tensor for chaining into the scorer; the default returns a
    float64 numpy array. The normals come from a generator seeded with
    ``seed``.
    """
    if isinstance(counts, torch.Tensor):
        counts_t = counts if device is None else counts.to(
            resolve_device(device))
    else:
        counts_t = torch.from_numpy(np.asarray(counts, np.int32)).to(
            resolve_device("cuda" if device is None else device))
    dev = counts_t.device
    z = draw_normals(tuple(counts_t.shape), seed, dev)
    with torch.no_grad():
        out = photometries_from_normals(z, counts_t, math.log(beta),
                                        beta_sigma, _ddif_tensor(ddif, dev))
    if device_out:
        return out
    return out.cpu().numpy().astype(np.float64)


def _color_intensities(counts, labels_sorted, beta, beta_sigma, seed, ddif):
    """Per-colour (N, F) float32 intensities on the device of ``counts``
    (N, F, n_colors): colour k draws from seed + 7919 * (k + 1), as in the
    JAX package."""
    return [simulate_photometries_batched(
                counts[:, :, k], beta, beta_sigma,
                seed=seed + 7919 * (k + 1), ddif=ddif, device_out=True)
            for k in range(len(labels_sorted))]


def peptide_simulation_batched(sequence, labels, num_mocks, num_edmans,
                               num_simulations, seed=0, beta=None,
                               beta_sigma=None, ddif=None, device="cuda",
                               **params):
    """Device-scale peptide_simulation (sim/events.py:306-343) for the
    models the batched path covers (no superdyes or distance DDIF).

    Returns a list of (dye_decrements, dye_counts, event_buffer=None,
    categories_and_intensities) tuples in the host event loop's format, ready
    for convert_to_oldstyle. Event buffers are not materialised (the host
    path keeps them only as an opaque passthrough).
    """
    labels_sorted, counts_d, loss_d, dud_d = _simulate(
        sequence, labels, num_mocks, num_edmans, num_simulations, seed,
        device, params)
    # Photometries chain from the device counts; everything is fetched in
    # one round of copies.
    intens_d = _color_intensities(counts_d, labels_sorted, beta, beta_sigma,
                                  seed, ddif)
    counts, loss, dud, *intens = wait(fetch([counts_d, loss_d, dud_d]
                                              + intens_d))
    n = counts.shape[0]
    intens = {label: intens[k].astype(np.float64)
              for k, label in enumerate(labels_sorted)}
    out = []
    for i in range(n):
        dye_counts = {label: tuple(int(x) for x in counts[i, :, k])
                      for k, label in enumerate(labels_sorted)}
        ci = {}
        for k, label in enumerate(labels_sorted):
            category = tuple(c != 0 for c in dye_counts[label])
            row = tuple(float(x) for x in intens[label][i])
            ci[label] = (category, (row,))
        out.append((decrements_from_loss_cycles(sequence, loss[i],
                                                dud[i]),
                    dye_counts, None, ci))
    return out


def simulate_and_fit_batched(sequence, labels, num_mocks, num_edmans,
                             num_simulations, beta, beta_sigma, seed=0,
                             ddif=None, max_possible=5, allow_multidrop=True,
                             allow_upsteps=False, max_deviation=3,
                             chunk=None, error_signals=True,
                             fetch_intensities=False, device="cuda",
                             **params):
    """Device-chained closure: simulate -> per-colour photometries -> v8
    fit, with one fetch round of small per-trace results.

    Reproduces simulate_peptide.py's simulate -> fit flow
    (simulate_peptide.py:271-285) without taking the (N, F) intensities
    through the host: the simulation, the photometries and the scorer
    (ops/lognormal.py::score_chunk_device, kernel C on a card) run on the
    device in chunks of ``chunk`` traces (None: the scorer's CUDA or CPU
    chunk); what returns is each trace's winner and found flag plus the
    counts and loss cycles. Signals are aggregated per unique winning
    sequence (aggregation is order-insensitive and the key depends only on
    the winning sequence), so the host decodes at most |table| sequences.

    Returns a dict: signals, total_count, none_count,
    molecular_error_signals (single-label only, else None; None when
    error_signals=False), counts (N, F, n_colors) int32, labels (sorted
    tuple), intensities ({label: (N, F) float32} when
    fetch_intensities=True).
    """
    from ..ops.lognormal import (CPU_CHUNK, CUDA_CHUNK, device_table,
                                 score_chunk_device, seq_to_signal,
                                 sequence_table)

    if ddif is None or len(ddif) != max_possible + 2:
        # The fit wrapper's gate (photometries_lognormal_fit_v8 / MCsimlib's
        # v8): the quench array must cover counts 1..K+2.
        raise ValueError("quench factors (ddif) required for v8+: need "
                         f"max_possible + 2 = {max_possible + 2} entries")
    labels_sorted, counts_d, loss_d, dud_d = _simulate(
        sequence, labels, num_mocks, num_edmans, num_simulations, seed,
        device, params)
    dev = counts_d.device
    if chunk is None:
        chunk = CUDA_CHUNK if dev.type == "cuda" else CPU_CHUNK
    n_colors = len(labels_sorted)
    N, F = counts_d.shape[:2]
    log_fluor_means = np.asarray(
        [math.log(beta) + math.log(i + 1.0) - ddif[i]
         for i in range(max_possible + 2)], np.float32)
    tab = sequence_table(F, max_possible, allow_upsteps)
    table = device_table(F, max_possible, allow_upsteps, allow_multidrop,
                         dev)
    lfm = torch.from_numpy(log_fluor_means[:max_possible]).to(dev)

    intens_d = _color_intensities(counts_d, labels_sorted, beta, beta_sigma,
                                  seed, ddif)
    pending = []
    with torch.no_grad():
        for k, label in enumerate(labels_sorted):
            counts_k = counts_d[:, :, k]
            for lo in range(0, N, chunk):
                hi = min(lo + chunk, N)
                bi, fo, _ = score_chunk_device(
                    intens_d[k][lo:hi], counts_k[lo:hi], table, lfm,
                    float(beta_sigma), float(max_deviation))
                pending.append((bi, fo))
    fetched = wait(fetch([t for pair in pending for t in pair]
                         + [counts_d, loss_d, dud_d]
                         + (intens_d if fetch_intensities else [])))
    results = fetched[:2 * len(pending)]
    counts, loss, dud = fetched[2 * len(pending):2 * len(pending) + 3]

    signals = {}
    none_count = 0
    decode_cache = {}
    for j in range(len(pending)):
        bi, fo = results[2 * j], results[2 * j + 1]
        none_count += int((~fo).sum())
        uniq, cnts = np.unique(bi[fo], return_counts=True)
        for u, c in zip(uniq, cnts):
            u = int(u)
            if u not in decode_cache:
                seq = tuple(int(v) for v in tab[u])
                signal, is_zero, starting = seq_to_signal(seq)
                decode_cache[u] = (signal, is_zero, starting)
            signal, is_zero, starting = decode_cache[u]
            if signal is None:
                # seq_to_signal rejects upstep winners (only reachable with
                # allow_upsteps tables); the two-step path counts them as
                # unfit (inference/lognormal._decode_and_aggregate).
                none_count += int(c)
            else:
                key = (signal, is_zero, starting)
                signals[key] = signals.get(key, 0) + int(c)

    mes = None
    if error_signals and n_colors == 1:
        # Group identical (loss, dud) molecules and decode each unique row
        # once: key = (dye_decrements, last_count == 0, first_count), as
        # simulate_peptide.py's per-molecule loop (:157-168).
        combo = np.concatenate(
            [loss, dud.astype(np.int32),
             counts[:, :1, 0], counts[:, -1:, 0]], axis=1)
        uniq_rows, inverse, cnts = np.unique(
            combo, axis=0, return_inverse=True, return_counts=True)
        mes = {}
        L = loss.shape[1]
        for r in range(uniq_rows.shape[0]):
            row = uniq_rows[r]
            decs = decrements_from_loss_cycles(
                sequence, row[:L], row[L:2 * L].astype(bool))
            key = (decs, bool(row[2 * L + 1] == 0), int(row[2 * L]))
            mes[key] = mes.get(key, 0) + int(cnts[r])

    out = {
        "signals": signals,
        "total_count": N * n_colors,
        "none_count": none_count,
        "molecular_error_signals": mes,
        "counts": counts,
        "labels": labels_sorted,
    }
    if fetch_intensities:
        out["intensities"] = {
            label: fetched[2 * len(pending) + 3 + k]
            for k, label in enumerate(labels_sorted)}
    return out
