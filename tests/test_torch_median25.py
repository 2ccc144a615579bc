"""The median-of-25 selection network (csrc/median25.cuh), built with g++.

Both CUDA kernels take their 5x5 medians from this header. Here g++
compiles it into a small harness (skipped where there is no g++), which
proves the network over all 2^25 zero-one inputs, 64 at a time with AND for
min and OR for max (by the 0-1 principle it then selects the median of any
input), and takes the median of seeded float vectors, ties included, for a
comparison with ``np.median``.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

HEADER = os.path.join(os.path.dirname(__file__), os.pardir,
                      "fluorosequencingimageanalysis_torch", "csrc",
                      "median25.cuh")

HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include "median25.cuh"

struct BitMinMax {  // 64 zero-one inputs, one per bit
  static uint64_t lo(uint64_t a, uint64_t b) { return a & b; }
  static uint64_t hi(uint64_t a, uint64_t b) { return a | b; }
};

// Input x (25 bits) sits in bit x % 64 of block x / 64: bits 0-5 of x vary
// within a word, bits 6-24 select the block. Its median is 1 iff at least
// 13 of its 25 bits are set.
static int all_zero_one_inputs(void) {
  uint64_t lane[6];
  for (int b = 0; b < 6; ++b) {
    lane[b] = 0;
    for (int i = 0; i < 64; ++i) lane[b] |= (uint64_t)((i >> b) & 1) << i;
  }
  long bad = 0;
  for (uint64_t blk = 0; blk < (1u << 19); ++blk) {
    uint64_t v[25];
    for (int b = 0; b < 6; ++b) v[b] = lane[b];
    for (int b = 6; b < 25; ++b) v[b] = ((blk >> (b - 6)) & 1) ? ~0ull : 0ull;
    const uint64_t got = median25::select<BitMinMax>(v);
    uint64_t want = 0;
    const int high = __builtin_popcountll(blk);
    for (int i = 0; i < 64; ++i)
      if (__builtin_popcount(i) + high >= 13) want |= 1ull << i;
    bad += got != want;
  }
  printf("%ld\n", bad);
  return 0;
}

// Medians of the float32 vectors of 25 on stdin, as float32 on stdout.
static int floats(void) {
  float v[25];
  while (fread(v, sizeof v, 1, stdin) == 1) {
    const float m = median25::select<median25::FloatMinMax>(v);
    fwrite(&m, sizeof m, 1, stdout);
  }
  return 0;
}

int main(int argc, char** argv) {
  return argc > 1 && !strcmp(argv[1], "01") ? all_zero_one_inputs()
                                            : floats();
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the median25.cuh harness")
    d = tmp_path_factory.mktemp("median25")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-I", os.path.dirname(HEADER),
         "-o", str(exe), str(src)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    return str(exe)


def test_network_selects_the_median_of_every_zero_one_input(harness):
    proc = subprocess.run([harness, "01"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == 0  # blocks of 64 inputs with a wrong median


@pytest.mark.parametrize("draw", ["continuous", "few_levels", "one_level",
                                  "pixels"])
def test_network_matches_np_median(harness, draw):
    rng = np.random.default_rng(["continuous", "few_levels", "one_level",
                                 "pixels"].index(draw))
    n = 10_000
    if draw == "continuous":
        x = rng.normal(0, 1e3, (n, 25))
    elif draw == "few_levels":  # many ties, signed values
        x = rng.integers(-2, 3, (n, 25)) * 0.5
    elif draw == "one_level":  # all 25 equal but one or two
        x = np.full((n, 25), 7.0)
        x[np.arange(n), rng.integers(0, 25, n)] = rng.normal(0, 10, n)
        x[np.arange(n), rng.integers(0, 25, n)] = -3.0
    else:  # 16-bit camera counts
        x = rng.integers(380, 4000, (n, 25))
    x = x.astype(np.float32)
    proc = subprocess.run([harness], input=x.tobytes(), capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = np.frombuffer(proc.stdout, dtype=np.float32)
    np.testing.assert_array_equal(got, np.median(x, axis=1))


def test_network_size():
    """75 full exchanges and 12 each that keep only the min or the max:
    174 min/max in all (the figure chip_smoke.py counts in kernel A's
    bound), against 600 for a full odd-even transposition sort."""
    text = open(HEADER).read()
    body = text[text.index("// Sort triples"):text.index("#undef CS")]
    calls = re.findall(r"\b(CS|LO|HI)\((\d+), (\d+)\)", body)
    kinds = [k for k, _, _ in calls]
    assert (kinds.count("CS"), kinds.count("LO"), kinds.count("HI")) == \
        (75, 12, 12)
    assert 2 * kinds.count("CS") + kinds.count("LO") + kinds.count("HI") \
        == 174
    assert all(int(i) < int(j) < 25 for _, i, j in calls)
