"""Kernel F's spatial bins and decision (csrc/consolidate.cuh), built with
g++, against the plain twin of the NMS (ops/consolidate.py), and the
wrapper's routing of CPU tensors.

The harness does per image what csrc/consolidate.cu does per block, one
step after another: the bounding box of the binned centers, the grid, the
counting sort into cells (filled in descending fit order: the kernel's
atomics fill a cell in any order, and the result must not depend on it),
then Jacobi rounds of ``nms::decide`` until no fit is undecided. Built
with -ffp-contract=off, as the kernel with -fmad=false, it must give the
twin's keep mask and each image's round count exactly, on every case of
``nms_cases`` (skipped where there is no g++). The card tests hold the
kernel itself to the same twin.
"""

import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import nms_cases
from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch.ops import consolidate as cons
from fluorosequencingimageanalysis_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <stdint.h>
#include <vector>
#include "consolidate.cuh"

template <class T>
static std::vector<T> take(size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, stdin) != n) v.clear();
  return v;
}

int main() {
  int32_t head[3];
  double radius;
  if (fread(head, sizeof head, 1, stdin) != 1 ||
      fread(&radius, sizeof radius, 1, stdin) != 1)
    return 2;
  const int B = head[0], n = head[1];
  const bool gated = head[2] != 0;
  const size_t bn = static_cast<size_t>(B) * n;
  std::vector<float> ch = take<float>(bn), cw = take<float>(bn),
                     r2 = take<float>(bn);
  std::vector<uint8_t> valid = take<uint8_t>(bn);
  std::vector<float> gh, gw;
  if (gated) {
    gh = take<float>(bn);
    gw = take<float>(bn);
  }
  const float rad = static_cast<float>(radius);
  const float rad2 = rad * rad;
  const float gate = static_cast<float>(radius + 2.0);
  const bool every_pair = isinf(rad2);
  std::vector<uint8_t> keep(bn);
  std::vector<int32_t> rounds(B);
  for (int b = 0; b < B; ++b) {
    const size_t at = static_cast<size_t>(b) * n;
    float lo_h = INFINITY, hi_h = -INFINITY, lo_w = INFINITY, hi_w = -INFINITY;
    bool any_valid = false;
    std::vector<char> in_cell(n);
    for (int i = 0; i < n; ++i) {
      const bool v = valid[at + i] != 0;
      const float h = ch[at + i], w = cw[at + i];
      in_cell[i] = v && nms::binned(h, w, every_pair);
      keep[at + i] = v && !in_cell[i];
      any_valid |= v;
      if (in_cell[i] && !every_pair) {
        lo_h = fminf(lo_h, h);
        hi_h = fmaxf(hi_h, h);
        lo_w = fminf(lo_w, w);
        hi_w = fmaxf(hi_w, w);
      }
    }
    const nms::Grid g =
        nms::make_grid(lo_h, hi_h, lo_w, hi_w, radius, every_pair);
    std::vector<int> cell_end(g.gh * g.gw, 0);
    for (int i = 0; i < n; ++i)
      if (in_cell[i]) ++cell_end[nms::cell_of(g, ch[at + i], cw[at + i])];
    int m = 0;
    for (int& c : cell_end) {
      const int k = c;
      c = m;
      m += k;
    }
    std::vector<float> sh(m), sw(m), score(m), sgh(m), sgw(m);
    std::vector<int> idx(m);
    std::vector<uint8_t> cur(m, nms::kUndecided), nxt(m);
    for (int i = n - 1; i >= 0; --i) {
      if (!in_cell[i]) continue;
      const int p = cell_end[nms::cell_of(g, ch[at + i], cw[at + i])]++;
      sh[p] = ch[at + i];
      sw[p] = cw[at + i];
      score[p] = isnan(r2[at + i]) ? -INFINITY : r2[at + i];
      idx[p] = i;
      if (gated) {
        sgh[p] = gh[at + i];
        sgw[p] = gw[at + i];
      }
    }
    const nms::Sorted s{sh.data(), sw.data(), score.data(), idx.data(),
                        gated ? sgh.data() : nullptr,
                        gated ? sgw.data() : nullptr, cell_end.data()};
    int r = 0;
    bool more = any_valid;
    while (more) {
      ++r;
      more = false;
      for (int p = 0; p < m; ++p) {
        uint8_t st = cur[p];
        if (st == nms::kUndecided)
          st = nms::decide(s, g, cur.data(), p, rad2, gate);
        nxt[p] = st;
        more |= st == nms::kUndecided;
      }
      cur.swap(nxt);
    }
    for (int p = 0; p < m; ++p) keep[at + idx[p]] = cur[p] == nms::kKept;
    rounds[b] = r;
  }
  fwrite(keep.data(), 1, bn, stdout);
  fwrite(rounds.data(), sizeof(int32_t), B, stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the consolidate.cuh harness")
    d = tmp_path_factory.mktemp("consolidate")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I", _build.CSRC,
         "-o", str(exe), str(src)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    return str(exe)


def _run_harness(exe, ch, cw, r2, valid, radius, cand):
    B, n = ch.shape
    parts = [struct.pack("<3i", B, n, cand is not None),
             struct.pack("<d", radius)]
    arrays = [ch, cw, r2, valid.astype(np.uint8)] + list(cand or ())
    parts += [np.ascontiguousarray(a).tobytes() for a in arrays]
    proc = subprocess.run([exe], input=b"".join(parts), capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    keep = np.frombuffer(proc.stdout[:B * n], np.uint8).reshape(B, n)
    rounds = np.frombuffer(proc.stdout[B * n:], np.int32)
    return keep.astype(bool), rounds


def _plain_per_image(ch, cw, r2, valid, radius, cand):
    """The twin's keep mask and each image's rounds (one image a group)."""
    keep, rounds = [], []
    for b in range(ch.shape[0]):
        args = [torch.from_numpy(a[b:b + 1]) for a in (ch, cw, r2, valid)]
        extra = [torch.from_numpy(a[b:b + 1]) for a in (cand or ())]
        k, r = cons._consolidate_group(*args, radius, *extra)
        keep.append(k[0].numpy())
        rounds.append(r)
    return np.stack(keep), np.array(rounds, np.int32)


@pytest.mark.parametrize("name", nms_cases.NAMES)
def test_header_equals_the_plain_twin(harness, name):
    ch, cw, r2, valid, radius, cand = nms_cases.case(name)
    want_keep, want_rounds = _plain_per_image(ch, cw, r2, valid, radius,
                                              cand)
    keep, rounds = _run_harness(harness, ch, cw, r2, valid, radius, cand)
    np.testing.assert_array_equal(keep, want_keep)
    np.testing.assert_array_equal(rounds, want_rounds)
    # Every case but "no valid fit" keeps something and decides in rounds.
    assert (want_rounds > 0).any() == bool(valid.any())


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    ch, cw, r2, valid, radius, cand = nms_cases.case("gate")
    args = [torch.from_numpy(a) for a in (ch, cw, r2, valid)]
    cands = [torch.from_numpy(a) for a in cand]
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"a CPU call loaded {name}"))
    before = cons.consolidate.launches
    profiling.reset_counters()
    got = cons.consolidate(*args, radius, *cands)
    assert cons.consolidate.launches == before
    c = profiling.counters()
    profiling.reset_counters()
    assert set(c) == {"detect/consolidate_rounds"}
    np.testing.assert_array_equal(
        got.numpy(), cons.consolidate_plain(*args, radius, *cands).numpy())
    with pytest.raises(ValueError, match="both cand_h and cand_w"):
        cons.consolidate(*args, radius, cands[0])


def test_no_fit_slot_gives_an_empty_mask():
    """N == 0: an empty (B, 0) keep mask, no launch, no rounds."""
    ch, cw, r2, valid, radius, _ = nms_cases.case("no_fits")
    args = [torch.from_numpy(a) for a in (ch, cw, r2, valid)]
    before = cons.consolidate.launches
    profiling.reset_counters()
    got = cons.consolidate(*args, radius)
    c = profiling.counters()
    profiling.reset_counters()
    assert got.shape == (3, 0) and got.dtype == torch.bool
    assert cons.consolidate.launches == before
    assert c == {"detect/consolidate_rounds": 0}
