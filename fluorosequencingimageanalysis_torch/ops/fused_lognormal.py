"""Kernel C: the fused v8 sequence walk with a running argmax, and its twin.

``v8_score_fused`` launches csrc/v8_score.cu (one warp per trace) on CUDA
tensors and runs ``v8_score_plain`` on CPU tensors. Both compute, for every
trace t and every candidate sequence s of a packed table,

    score[t, s] = ((c[t, 0, tab[s, 0]] + c[t, 1, tab[s, 1]]) + ...)
                  + c[t, F-1, tab[s, F-1]]          (float32, frame order)
    valid[t, s] = no invalid[t, f, tab[s, f]] set, score not NaN, seq_ok[s]
    key[t, s]   = max(score, -1e30) where valid, else -inf

and return the first index of the greatest key, whether any sequence was
valid, and the raw score at that index (index 0 and its raw score when none
was). This is the masked argmax of the JAX package's
ops/lognormal.py::_score_batch, whose two one-hot matrix products it
replaces with a table walk: the sum of F terms is taken in frame order on
both sides here, so kernel and twin agree bit for bit.

``pack_table`` lays a (S, F) sequence table out as both sides read it:
frame-major bytes, rows padded to a multiple of 4 with sequences that are
never valid.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_PAD = 4  # sequences per 32-bit table word (csrc/v8_score.cuh::PACK)
_MAX_SMEM = 48 * 1024  # static limit of dynamic shared memory per block


def pack_table(seq_tab, allow_multidrop, device):
    """(tab_t (F, S_pad) uint8, seq_ok (S_pad,) uint8) on ``device`` from a
    host (S, F) integer table.

    ``seq_ok`` is 0 for a sequence with a drop above 1 when
    ``allow_multidrop`` is false, and for the padding."""
    tab = np.asarray(seq_tab)
    if tab.ndim != 2 or tab.shape[1] < 1:
        raise ValueError(f"pack_table: an (S, F) table with F >= 1 "
                         f"required, got shape {tab.shape}")
    if tab.size and (tab.min() < 0 or tab.max() > 255):
        raise ValueError("pack_table: fluor counts must lie in 0..255 to "
                         f"pack into bytes (got up to {int(tab.max())})")
    S, F = tab.shape
    ok = np.ones(S, bool)
    if not allow_multidrop and F > 1:
        ok = (tab[:, :-1] - tab[:, 1:]).max(axis=-1) <= 1
    S_pad = -(-S // _PAD) * _PAD
    tab_t = np.zeros((F, S_pad), np.uint8)
    tab_t[:, :S] = tab.T
    seq_ok = np.zeros(S_pad, np.uint8)
    seq_ok[:S] = ok
    return (torch.from_numpy(tab_t).to(device),
            torch.from_numpy(seq_ok).to(device))


def v8_score_plain(contrib, invalid, tab_t, seq_ok):
    """(best_idx (T,) int32, found (T,) bool, best_logscore (T,) float32)
    in torch ops; builds (T, S_pad) arrays, so callers chunk T."""
    T, F, nv = contrib.shape
    idx = tab_t.long()
    acc = contrib[:, 0, idx[0]]
    viol = invalid[:, 0, idx[0]]
    for f in range(1, F):
        acc = acc + contrib[:, f, idx[f]]
        viol = viol | invalid[:, f, idx[f]]
    valid = ~viol.bool() & ~acc.isnan() & seq_ok.bool()[None, :]
    key = torch.where(valid, acc.clamp_min(-1e30),
                      acc.new_full((), float("-inf")))
    best_idx = torch.argmax(key, dim=-1)  # the first of equal maxima
    found = valid.any(dim=-1)
    best_logscore = acc.gather(1, best_idx[:, None])[:, 0]
    return best_idx.to(torch.int32), found, best_logscore


def _launch(contrib, invalid, tab_t, seq_ok):
    from .. import _build
    lib = _build.load("v8_score")
    fn = lib.v8_score_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 +
                   [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    lib.v8_score_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.v8_score_smem_bytes.restype = ctypes.c_int
    T, F, nv = contrib.shape
    smem = lib.v8_score_smem_bytes(F, nv)
    if smem > _MAX_SMEM:
        raise ValueError(f"v8_score_fused: {F} frames x {nv} values need "
                         f"{smem} bytes of shared memory per block, above "
                         f"the {_MAX_SMEM} a launch may ask for")
    dev = contrib.device
    best_idx = torch.empty((T,), dtype=torch.int32, device=dev)
    found = torch.empty((T,), dtype=torch.bool, device=dev)
    best_logscore = torch.empty((T,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(contrib.data_ptr(), invalid.data_ptr(), tab_t.data_ptr(),
                 seq_ok.data_ptr(), T, F, nv, tab_t.shape[1],
                 best_idx.data_ptr(), found.data_ptr(),
                 best_logscore.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"v8_score kernel launch failed: CUDA error {err}")
    v8_score_fused.launches += 1
    return best_idx, found, best_logscore


def v8_score_fused(contrib, invalid, tab_t, seq_ok):
    """The winner of every trace over a packed sequence table.

    contrib: (T, F, nv) float32 log-pdf contributions; invalid: (T, F, nv)
    bool (or uint8 0/1); tab_t, seq_ok: ``pack_table``'s layout, values
    below nv. Returns (best_idx (T,) int32, found (T,) bool, best_logscore
    (T,) float32). CUDA tensors (contiguous, on one device) go through the
    hand-written kernel; CPU tensors through ``v8_score_plain``.
    """
    if contrib.ndim != 3 or invalid.shape != contrib.shape:
        raise ValueError(f"v8_score_fused: contrib and invalid (T, F, nv) "
                         f"required, got {tuple(contrib.shape)} and "
                         f"{tuple(invalid.shape)}")
    if tab_t.ndim != 2 or tab_t.shape[0] != contrib.shape[1] or \
            seq_ok.shape != (tab_t.shape[1],) or tab_t.shape[1] % _PAD:
        raise ValueError(f"v8_score_fused: tab_t (F, S_pad) and seq_ok "
                         f"(S_pad,) from pack_table required, got "
                         f"{tuple(tab_t.shape)} and {tuple(seq_ok.shape)}")
    if contrib.dtype != torch.float32:
        raise TypeError(f"v8_score_fused: float32 contrib required, got "
                        f"{contrib.dtype}")
    if invalid.dtype not in (torch.bool, torch.uint8) or \
            tab_t.dtype != torch.uint8 or seq_ok.dtype != torch.uint8:
        raise TypeError("v8_score_fused: bool/uint8 invalid and uint8 "
                        "tab_t/seq_ok required")
    if contrib.device.type == "cpu":
        return v8_score_plain(contrib, invalid, tab_t, seq_ok)
    if contrib.device.type != "cuda":
        raise ValueError(f"v8_score_fused: unsupported device "
                         f"{contrib.device}")
    if any(t.device != contrib.device for t in (invalid, tab_t, seq_ok)):
        raise ValueError("v8_score_fused: all inputs must share a device")
    if not all(t.is_contiguous() for t in (contrib, invalid, tab_t, seq_ok)):
        raise ValueError("v8_score_fused: contiguous inputs required")
    return _launch(contrib, invalid, tab_t, seq_ok)


v8_score_fused.launches = 0
