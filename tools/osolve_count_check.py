#!/usr/bin/env python3
"""Kernel 1's O solve on the running maximum of den against the linear
count it replaced, on the CPU, with g++ (no card, no nvcc).

    git show 629b100:pyrayhf_tpu_torch/csrc/ionogram.cu \\
        > build/ionogram_present.cu
    python3 tools/osolve_count_check.py build/ionogram_present.cu

The argument is an earlier ``csrc/ionogram.cu`` whose ``osolve`` counts
dmax[j] < f^2/cp^2 over every node, then tests whether the ray escapes.
The script extracts ``Solve``, ``crossing``, ``count_below`` and
``osolve_table`` from the current source and ``osolve`` from the earlier
one, and compiles them with g++ through a header that defines the CUDA
keywords away (``-ffp-contract=off``, so each expression rounds as on the
card). The current search runs as a whole warp: a ballot evaluates its
predicate for each of the 32 lanes. The earlier count runs as a warp of
one lane (its 32-node stride becomes one node, the warp sum the lane's
own count).

On random running-maximum rows (Chapman layers with an E layer above a
valley, random walks, plateaus, repeated nodes, zeros, negative values
and a NaN from some node on; N from 2 to 1,500, most at 620), f32 and
f64, it holds ``count_below`` to the linear count for every (row, f), and
``osolve_table`` to the earlier ``osolve``: the same verdict on escape
and, on valid pairs, the same span, slope, emax and first-node flag bit
for bit. Frequencies: 60% at a node's cutoff cp * sqrt(dmax_j) times (1
+- n ulp), n = 0..4; the rest uniform in 0.1-20 MHz, with 0, NaN and
+inf among them. It checks the logic of the source, not what only nvcc
or the card can show. Prints the pairs and the differences per dtype;
exits 1 on any difference.
"""

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "pyrayhf_tpu_torch" / "csrc"

STUB = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>
#define __device__
#define __forceinline__ inline
using std::min;
using std::max;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kCP = 8.97866275;
constexpr double kDH = 1e-6;
// a warp of 32 lanes for the ballot: the predicate once per lane
template <typename P>
unsigned ballot_lanes(P pred) {
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= pred(l) ? 1u << l : 0u;
  return m;
}
#define __ballot_sync(mask, pred) \
  ballot_lanes([&](int lane) -> bool { return (pred); })
inline int __popc(unsigned m) { return __builtin_popcount(m); }
inline int __reduce_add_sync(unsigned, int v) { return v; }
template <typename T> T clip01(T x) {
  x = x < T(0) ? T(0) : x;
  return x > T(1) ? T(1) : x;
}
"""

MAIN_CPP = r"""
struct Rng {  // splitmix64
  uint64_t s;
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  double u() { return (next() >> 11) * 0x1.0p-53; }
  double in(double a, double b) { return a + (b - a) * u(); }
};

template <typename T>
bool same(T a, T b) { return std::memcmp(&a, &b, sizeof(T)) == 0; }

template <typename T>
T step_ulps(T x, int n) {
  const T to = n > 0 ? T(INFINITY) : T(-INFINITY);
  for (int i = 0; i < (n > 0 ? n : -n); ++i) x = std::nextafter(x, to);
  return x;
}

template <typename T>
void run(long long want, uint64_t seed) {
  Rng r{seed};
  std::vector<T> alt(1500), den(1500), dmax(1500);
  long long pairs = 0, count_diffs = 0, solve_diffs = 0, valid = 0;
  long long razor = 0, nan_rows = 0;
  while (pairs < want) {
    const int kind = (int)(r.next() % 6);
    const int N = r.u() < 0.7 ? 620 : 2 + (int)(r.next() % 1499);
    const double nm = std::pow(10.0, r.in(10.0, 12.6));
    const double hm = r.in(200.0, 420.0), H = r.in(30.0, 80.0);
    const double nme = r.in(0.05, 0.4) * nm, hme = r.in(100.0, 125.0);
    const int nan_at = r.u() < 0.2 ? (int)(r.next() % N) : N;
    double walk = nm * r.u();
    for (int j = 0; j < N; ++j) {
      const double a = 80.0 + 619.0 * j / (N - 1);
      const double z = (a - hm) / H, ze = (a - hme) / 8.0;
      double d = nm * std::exp(0.5 * (1.0 - z - std::exp(-z)));
      if (kind == 1)  // an E layer above a valley: shadowed nodes
        d += nme * std::exp(0.5 * (1.0 - ze - std::exp(-ze)));
      if (kind == 2) {  // random walk, any shape
        walk = std::max(0.0, walk + nm * r.in(-0.05, 0.05));
        d = walk;
      }
      if (kind == 3)  // plateaus: runs of tied values
        d = nm * std::floor(8.0 * std::exp(-z * z)) / 8.0;
      if (kind == 4 && j > 0 && r.u() < 0.3)  // repeated nodes
        d = double(den[j - 1]);
      if (kind == 5) {  // zeros and negatives sprinkled in
        const double v = r.u();
        if (v < 0.05) d = 0.0;
        else if (v < 0.08) d = -d;
      }
      alt[j] = T(a - 80.0);
      den[j] = j == nan_at ? T(NAN) : T(d);
    }
    // the running maximum as torch.cummax keeps it: a NaN stays, an
    // element equal to the maximum replaces it
    T acc = den[0];
    for (int j = 0; j < N; ++j) {
      const T x = den[j];
      if (std::isnan(x) || (!std::isnan(acc) && x >= acc)) acc = x;
      dmax[j] = acc;
    }
    nan_rows += nan_at < N;
    const T cp = T(kCP);
    for (int i = 0; i < 100; ++i) {
      T f;
      const double v = r.u();
      if (v < 0.6) {  // a node's cutoff, +- n ulp
        const int j = (int)(r.next() % N);
        T base = cp * std::sqrt(dmax[j]);
        if (!(std::isfinite(base) && base > T(0))) base = T(5e6);
        f = step_ulps(base, (int)(r.next() % 9) - 4);
        ++razor;
      } else if (v < 0.61) {
        f = T(0);
      } else if (v < 0.62) {
        f = T(NAN);
      } else if (v < 0.63) {
        f = T(INFINITY);
      } else {
        f = T(r.in(0.1e6, 20e6));
      }
      const T thr = (f * f) / T(kCP * kCP);
      int linear = 0;
      for (int j = 0; j < N; ++j) linear += dmax[j] < thr ? 1 : 0;
      const int found = count_below(dmax.data(), N, thr, 0);
      if (found != linear && count_diffs < 5)
        std::printf("  count differs: kind %d N %d f %.17g: %d, linear "
                    "%d\n", kind, N, (double)f, found, linear);
      count_diffs += found != linear;
      const Solve<T> a = osolve_table(alt.data(), den.data(), dmax.data(),
                                      N, f, 0, T(80));
      const Solve<T> b = osolve(alt.data(), den.data(), dmax.data(), N, f,
                                0, T(80));
      const bool ok = a.valid == b.valid &&
                      (!a.valid || (same(a.span, b.span) &&
                                    same(a.slope, b.slope) &&
                                    same(a.emax, b.emax) &&
                                    a.first == b.first));
      if (!ok && solve_diffs < 5)
        std::printf("  solve differs: kind %d N %d f %.17g valid %d/%d "
                    "span %.17g/%.17g\n", kind, N, (double)f, a.valid,
                    b.valid, (double)a.span, (double)b.span);
      solve_diffs += !ok;
      valid += b.valid;
      ++pairs;
    }
  }
  std::printf("%s: %lld pairs (%lld at a cutoff +- n ulp, %lld valid; "
              "%lld rows with a NaN), %lld count differences, %lld solve "
              "differences\n", sizeof(T) == 4 ? "f32" : "f64", pairs, razor,
              valid, nan_rows, count_diffs, solve_diffs);
  std::fflush(stdout);
  if (count_diffs || solve_diffs) std::exit(1);
}

int main(int argc, char** argv) {
  const long long want = argc > 1 ? std::atoll(argv[1]) : 10000000;
  run<float>(want, 20261018);
  run<double>(want, 20261019);
  return 0;
}
"""


def region(text, start, end):
    """``text`` from ``start`` up to ``end``."""
    i = text.find(start)
    j = text.find(end, i)
    if i < 0 or j < 0:
        raise ValueError(f"markers {start!r} .. {end!r} not found")
    return text[i:j]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/ionogram.cu (the "
                                    "linear count)")
    ap.add_argument("--pairs", type=int, default=10_000_000,
                    help="(row, frequency) pairs per dtype")
    args = ap.parse_args()
    cur_src = (SRC / "ionogram.cu").read_text()
    cur = region(cur_src, "template <typename T>\nstruct Solve",
                 "template <typename T>\n__device__ __forceinline__ T "
                 "cutoff_x")
    old = region(Path(args.earlier).read_text(), "// O mode (_osolve_tile)",
                 "template <typename T>\n__device__ __forceinline__ T "
                 "cutoff_x")
    if "osolve_table" not in cur or "Solve<T> osolve(" not in old:
        raise ValueError("the sources do not hold the two solves")
    # a warp of one lane for the earlier count: every 32-node stride
    # becomes one node
    old = old.replace("+= 32", "+= 1")
    src = STUB + "namespace {\n" + cur + old + "}\n" + MAIN_CPP
    with tempfile.TemporaryDirectory() as d:
        cpp, exe = Path(d) / "osolve_check.cpp", Path(d) / "osolve_check"
        cpp.write_text(src)
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-fno-fast-math", "-o", str(exe), str(cpp)],
                       check=True)
        return subprocess.run([str(exe), str(args.pairs)]).returncode


if __name__ == "__main__":
    sys.exit(main())
