#!/usr/bin/env python3
"""Kernel 2's X solve on the cutoff-frequency table against the two-scan
solve it replaced, on the CPU, with g++ (no card, no nvcc).

    git show eb1db86:pyrayhf_tpu_torch/csrc/ionogram.cu \\
        > build/ionogram_earlier.cu
    python3 tools/xsolve_table_check.py build/ionogram_earlier.cu

The argument is an earlier ``csrc/ionogram.cu`` whose ``xsolve`` scans
every node twice (the exhaustive first exceedance). The script extracts
the device functions of the X solve from it and from the current source
(``warp_max``, ``Solve``, ``crossing``, ``cutoff_x``, ``Margin``,
``cutoff_table``, ``xsolve_table``), compiles them with g++ through a
header that defines the CUDA keywords away and makes a warp of one lane
(the 32-node strides become 1, a ballot is the lane's own bit, a shuffle
returns the lane's own value; ``-ffp-contract=off``, so each expression
rounds as on the card), and holds the new solve's (valid, span, slope,
emax) against the old one's, bit for bit, on random profiles and
frequencies in f32 and f64: Chapman layers, an E layer above a valley,
two-peak pairs, constant |B|, the host's flat extension above the peak,
random walks, and nodes at zero, negative or NaN; frequencies uniform in
0.1-20 MHz and at each node's computed cutoff fx_j and prefix maximum
cfx_j times (1 +- n ulp), n = 0..4. It checks the logic of the source,
not what only nvcc or the card can show. Prints the pairs and the
differences per dtype; exits 1 on any difference.
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
#include <cstring>
#include <algorithm>
#define __device__
#define __forceinline__ inline
using std::min;
using std::max;
using std::sqrt;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kCP = 8.97866275;
constexpr double kGP = 2.799249247e10;
constexpr double kDH = 1e-6;
struct Dim { unsigned x; };
static Dim threadIdx{0}, blockDim{1};
inline void __syncthreads() {}
template <typename T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <typename T> T __shfl_up_sync(unsigned, T v, int) { return v; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __reduce_min_sync(unsigned, int v) { return v; }
inline int __reduce_add_sync(unsigned, int v) { return v; }
inline int __ffs(unsigned m) { return __builtin_ffs((int)m); }
inline int __popc(unsigned m) { return __builtin_popcount(m); }
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
  std::vector<T> alt(1024), den(1024), bm(1024), cfx(1024);
  T part[8];
  long long pairs = 0, diffs = 0, valid = 0, razor = 0;
  while (pairs < want) {
    const int kind = (int)(r.next() % 7);
    const int N = r.u() < 0.7 ? 620 : 2 + (int)(r.next() % 1000);
    const double nm = std::pow(10.0, r.in(10.0, 12.6));
    const double hm = r.in(200.0, 420.0), H = r.in(30.0, 80.0);
    const double nme = r.in(0.05, 0.4) * nm, hme = r.in(100.0, 125.0);
    const double b0 = r.in(2.0e-5, 6.5e-5);
    const bool flat_b = kind == 3;
    double walk = nm * r.u();
    int peak = 0;
    for (int j = 0; j < N; ++j) {
      const double a = 80.0 + 619.0 * j / (N - 1);
      const double z = (a - hm) / H, ze = (a - hme) / 8.0;
      double d = nm * std::exp(0.5 * (1.0 - z - std::exp(-z)));
      if (kind == 1 || kind == 2)
        d += nme * std::exp(0.5 * (1.0 - ze - std::exp(-ze)));
      if (kind == 2)   // the two-peak pair of tests/test_pallas.py
        d = 2.5e12 * std::exp(-(a - 300.0) * (a - 300.0) / 6050.0) +
            9e11 * std::exp(-(a - 110.0) * (a - 110.0) / 200.0);
      if (kind == 5) {  // random walk, any shape
        walk = std::max(0.0, walk + nm * r.in(-0.05, 0.05));
        d = walk;
      }
      if (kind == 6) {  // zeros, negatives, NaN sprinkled in
        const double v = r.u();
        if (v < 0.02) d = 0.0;
        else if (v < 0.03) d = -d;
        else if (v < 0.035) d = NAN;
      }
      alt[j] = T(a - 80.0);
      den[j] = T(d);
      bm[j] = T(flat_b ? b0 : b0 * std::pow(6451.0 / (6371.0 + a), 3));
      if (kind == 6 && r.u() < 0.01) bm[j] = T(r.u() < 0.5 ? -b0 : NAN);
      if (den[j] > den[peak]) peak = j;
    }
    if (kind == 4)  // the host's flat extension above the peak
      for (int j = std::max(peak, 1); j < N; ++j) {
        den[j] = den[peak - (peak > 0)];
        bm[j] = bm[peak - (peak > 0)];
        alt[j] = alt[peak - (peak > 0)];
      }
    cutoff_table(den.data(), bm.data(), N, cfx.data(), part);
    for (int i = 0; i < 200; ++i) {
      T f;
      const double v = r.u();
      if (v < 0.4) {
        f = T(r.in(0.1e6, 20e6));
      } else {
        const int j = (int)(r.next() % N);
        const int n = (int)(r.next() % 9) - 4;
        T base = cfx[j];
        if (v < 0.7) {  // the node's own fx, as the table computes it
          const T fh = bm[j] * T(kGP);
          base = (fh + sqrt(fh * fh + T(4) * (den[j] * T(kCP * kCP)))) *
                 T(0.5);
        }
        if (!(std::isfinite(base) && base > T(0))) base = T(5e6);
        f = step_ulps(base, n);
        ++razor;
      }
      const Solve<T> a = xsolve_table(alt.data(), den.data(), bm.data(),
                                      cfx.data(), N, f, 0, T(80));
      const Solve<T> b = xsolve_old(alt.data(), den.data(), bm.data(), N, f,
                                    0);
      const bool ok = a.valid == b.valid &&
                      (!a.valid || (same(a.span, b.span) &&
                                    same(a.slope, b.slope) &&
                                    same(a.emax, b.emax)));
      if (!ok && diffs < 5)
        std::printf("  differs: kind %d N %d f %.17g valid %d/%d span "
                    "%.17g/%.17g\n", kind, N, (double)f, a.valid, b.valid,
                    (double)a.span, (double)b.span);
      diffs += !ok;
      valid += b.valid;
      ++pairs;
    }
  }
  std::printf("%s: %lld pairs (%lld at a cutoff +- n ulp, %lld valid), "
              "%lld differences\n", sizeof(T) == 4 ? "f32" : "f64", pairs,
              razor, valid, diffs);
  std::fflush(stdout);
  if (diffs) std::exit(1);
}

int main(int argc, char** argv) {
  const long long want = argc > 1 ? std::atoll(argv[1]) : 10000000;
  run<float>(want, 20250901);
  run<double>(want, 20250902);
  return 0;
}
"""


def region(text, start, end):
    """``text`` from the line that starts with ``start`` up to ``end``."""
    i, j = text.find(start), text.find(end)
    if i < 0 or j < 0 or j < i:
        raise ValueError(f"markers {start!r} .. {end!r} not found")
    return text[i:j]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/ionogram.cu (two scans)")
    ap.add_argument("--pairs", type=int, default=10_000_000,
                    help="(profile, frequency) pairs per dtype")
    args = ap.parse_args()
    end = "// The lane's place in the altitude table"
    cur = region((SRC / "ionogram.cu").read_text(),
                 "template <typename T>\n__device__ __forceinline__ T "
                 "warp_max", end)
    old = region(Path(args.earlier).read_text(), "// X mode (_xsolve_tile)",
                 end)
    if "xsolve_table" not in cur or "Solve<T> xsolve(" not in old:
        raise ValueError("the sources do not hold the two solves")
    old = old.replace("Solve<T> xsolve(", "Solve<T> xsolve_old(")
    # both solves end in the current crossing, on a grid whose first node
    # lies at 80 km (the profiles' altitudes are relative to it)
    call = "first_exceeds, valid);"
    if old.count(call) != 1:
        raise ValueError(f"the earlier solve's {call!r} not found")
    old = old.replace(call, "first_exceeds, valid, T(80));")
    # a warp of one lane: every 32-node stride becomes one node
    cur, old = (t.replace("+= 32", "+= 1") for t in (cur, old))
    src = STUB + "#include <vector>\n#include <cstdlib>\nnamespace {\n" + \
        cur + old + "}\n" + MAIN_CPP
    with tempfile.TemporaryDirectory() as d:
        cpp, exe = Path(d) / "xsolve_check.cpp", Path(d) / "xsolve_check"
        cpp.write_text(src)
        subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-fno-fast-math", "-o", str(exe), str(cpp)],
                       check=True)
        return subprocess.run([str(exe), str(args.pairs)]).returncode


if __name__ == "__main__":
    sys.exit(main())
