"""The correctly rounded quotient from a known reciprocal (csrc/exact_div.cuh).

Kernel B divides every per-pixel value by a sigma in [0.75, 2] as
``div_rn(a, sigma, 1 / sigma)``, and its plain twin divides. The two agree
bit for bit only if ``div_rn`` returns the IEEE quotient. Here g++ builds
the header into a harness (skipped where there is no g++) that compares it
with ``a / b`` for every float b in [0.5, 4), each against seeded a over the
magnitudes the kernel sees and beyond.
"""

import os
import shutil
import subprocess

import pytest

CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "fluorosequencingimageanalysis_torch", "csrc")

HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include "exact_div.cuh"

static uint32_t bits(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
static float from_bits(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }

int main(void) {
  uint64_t s = 0x9E3779B97F4A7C15ull, n = 0, bad = 0, zero_sign = 0;
  // Every float b in [0.5, 4): exponents -1, 0 and 1, every mantissa.
  for (uint32_t ub = 126u << 23; ub < 129u << 23; ++ub) {
    const float b = from_bits(ub);
    const float inv_b = 1.0f / b;
    for (int j = 0; j < 8; ++j) {
      s ^= s << 13; s ^= s >> 7; s ^= s << 17;
      // a: random sign and mantissa, magnitude 2^-30 .. 2^11.
      const uint32_t e = 127 - 30 + (uint32_t)(s % 42);
      const float a = from_bits(((uint32_t)(s >> 63) << 31) | (e << 23) |
                                ((uint32_t)(s >> 20) & 0x7fffffu));
      const volatile float want = a / b;
      const float got = exact_div::div_rn(a, b, inv_b);
      ++n;
      bad += bits(got) != bits(want);
    }
    const float z = exact_div::div_rn(0.0f, b, inv_b);
    zero_sign += bits(z) != bits(0.0f / b);
  }
  printf("%llu %llu %llu\n", (unsigned long long)n, (unsigned long long)bad,
         (unsigned long long)zero_sign);
  return 0;
}
"""


def test_div_rn_is_the_ieee_quotient(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the exact_div.cuh harness")
    src, exe = tmp_path / "harness.cpp", tmp_path / "harness"
    src.write_text(HARNESS)
    # No contraction: each product and sum rounds on its own, as in the
    # kernel (built with -fmad=false); fmaf is the one fused operation.
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I", CSRC,
         "-o", str(exe), str(src), "-lm"], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    proc = subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad, zero_sign = map(int, proc.stdout.split())
    assert n == 3 * 2 ** 23 * 8
    assert bad == 0 and zero_sign == 0
