"""Kernel E: every round of the batched 1D mixture EM in one launch, and
the switch to its twin.

``gmm_em`` launches csrc/gmm_em.cu on CUDA tensors and runs
``ops/gmm_batch.py::_em_plain`` on CPU tensors. Both return, for (G, B, K)
starts over (G, N) standardised data whose first ``counts[g]`` points of
row g are valid, the parameters after ``n_iter`` EM rounds and each
model's total log-likelihood under them, in the order of the starts. A
failed build or launch raises; a CUDA tensor never takes the twin.

What bounds the kernel is the special-function unit: k exp2 and one log2
a point, model and round (chip_smoke.py::bound_e). Its arithmetic takes
that count and one reciprocal a point (csrc/gmm_em.cuh), and its layout
(csrc/gmm_em.cu) splits each group's points over the blocks of a thread
block cluster, each block staging its slice through shared memory and
running a balanced subset of the group's models over it; the
kernel picks its grid and subsets itself (``geometry`` reports them). At
config 5's mixtures (12 x 100,000 points, 50 models, K = 6, 100 rounds)
it takes 17.3 ms on an NVIDIA H100 80GB HBM3 at 700 W, 42% of its bound,
against 89.5 ms for its first form (tools/ab_gmm_em.py, in turns).
Up to ``KREG`` components the kernel keeps a model's constants and
statistics in registers; above it, up to ``KMAX``, its shared-memory
form keeps them in shared memory and computes each point's terms twice.
A group of more than ``BMAX`` models is split by
``ops/gmm_batch.py::em_in_slices``.
"""

from __future__ import annotations

import ctypes

import torch

from .gmm_batch import _em_plain

KREG = 8  # gmm::KREG in csrc/gmm_em.cuh: the register form's largest K
KMAX = 256  # gmm::KMAX in csrc/gmm_em.cuh
BMAX = 4096  # BMAX in csrc/gmm_em.cu: models a group
GEOMETRY_KEYS = ("subsets", "cluster", "warps", "tile", "smem_bytes",
                 "active_clusters", "blocks_per_sm", "models_per_block_max",
                 "blocks")


def geometry(G, N, B, K):
    """The launch geometry kernel E picks for G groups of N points and
    (G, B, K) models on the current card: a dict of ``GEOMETRY_KEYS``
    (subsets a group, blocks a cluster, warps a block, points a staged
    tile, dynamic shared memory, clusters and blocks an SM the card holds
    at once, models a block at most, blocks in the grid)."""
    from .. import _build
    fn = _build.load("gmm_em").gmm_em_geometry
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    err = fn(G, N, B, K, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"gmm_em geometry failed: CUDA error {err}")
    return dict(zip(GEOMETRY_KEYS, out))


def _launch(z, counts, w0, mu0, var0, comp_mask, n_iter, reg):
    from .. import _build
    fn = _build.load("gmm_em").gmm_em_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 +
                   [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float] +
                   [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    G, B, K = w0.shape
    dev = z.device
    w = torch.empty_like(w0)
    mu = torch.empty_like(w0)
    var = torch.empty_like(w0)
    ll = torch.empty((G, B), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(z.data_ptr(), counts.data_ptr(), G, z.shape[1], B, K,
                 w0.data_ptr(), mu0.data_ptr(), var0.data_ptr(),
                 comp_mask.data_ptr(), n_iter, reg, w.data_ptr(),
                 mu.data_ptr(), var.data_ptr(), ll.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gmm_em kernel launch failed: CUDA error {err}")
    gmm_em.launches += 1
    return w, mu, var, ll


def gmm_em(z, counts, w0, mu0, var0, comp_mask, n_iter, reg, chunk=2048):
    """(w, mu, var (G, B, K), loglik (G, B)) float32 after ``n_iter`` EM
    rounds from the starts ``w0``, ``mu0``, ``var0`` (G, B, K) float32 with
    active components ``comp_mask`` (G, B, K) bool, over ``z`` (G, N)
    float32 of which row g's first ``counts[g]`` (int32) points are valid;
    ``reg`` floors the variances. The hand-written kernel for contiguous
    CUDA tensors (K <= 256, B <= 4096), ``_em_plain`` (chunks of ``chunk``
    points, N a multiple of it) for CPU tensors."""
    if z.ndim != 2:
        raise ValueError(f"gmm_em: (G, N) data required, got "
                         f"{tuple(z.shape)}")
    G, N = z.shape
    if w0.ndim != 3 or w0.shape[0] != G:
        raise ValueError(f"gmm_em: (G, B, K) starts required for G = {G}, "
                         f"got {tuple(w0.shape)}")
    if any(t.shape != w0.shape for t in (mu0, var0, comp_mask)):
        raise ValueError("gmm_em: w0, mu0, var0 and comp_mask must share "
                         "their (G, B, K) shape")
    if counts.shape != (G,):
        raise ValueError(f"gmm_em: (G,) counts required, got "
                         f"{tuple(counts.shape)}")
    if z.device.type == "cpu":
        valid = (torch.arange(N)[None, :] < counts[:, None]).to(z.dtype)
        return _em_plain(z, valid, w0, mu0, var0, comp_mask, n_iter, reg,
                         chunk=chunk)
    if z.device.type != "cuda":
        raise ValueError(f"gmm_em: unsupported device {z.device}")
    tensors = (z, counts, w0, mu0, var0, comp_mask)
    if any(t.device != z.device for t in tensors):
        raise ValueError("gmm_em: every input must lie on one device")
    if any(t.dtype != torch.float32 for t in (z, w0, mu0, var0)) or \
            counts.dtype != torch.int32 or comp_mask.dtype != torch.bool:
        raise TypeError("gmm_em: float32 data and starts, int32 counts and "
                        "a bool mask required on the card")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gmm_em: contiguous inputs required")
    if not 1 <= w0.shape[2] <= KMAX:
        raise ValueError(f"gmm_em: the kernel takes 1 to {KMAX} components, "
                         f"got K = {w0.shape[2]}")
    if w0.shape[1] > BMAX:
        raise ValueError(f"gmm_em: the kernel takes at most {BMAX} models "
                         f"a group, got B = {w0.shape[1]}")
    return _launch(z, counts, w0, mu0, var0, comp_mask, int(n_iter),
                   float(reg))


gmm_em.launches = 0
