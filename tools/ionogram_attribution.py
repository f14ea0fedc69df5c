#!/usr/bin/env python3
"""Where the ionogram kernels' time goes (``csrc/ionogram.cu``), on one
CUDA card, by variants timed in turns.

    git show eb1db86:pyrayhf_tpu_torch/csrc/ionogram.cu \\
        > build/ionogram_earlier.cu
    git show eb1db86:pyrayhf_tpu_torch/csrc/ionogram_common.cuh \\
        > build/ionogram_common_earlier.cuh
    git show 629b100:pyrayhf_tpu_torch/csrc/ionogram.cu \\
        > build/ionogram_present.cu
    python3 tools/ionogram_attribution.py build/ionogram_earlier.cu \\
        build/ionogram_common_earlier.cuh build/ionogram_present.cu

The first two arguments are an earlier ``csrc/ionogram.cu`` and its
``ionogram_common.cuh`` with the launch signature of that revision (no
row stride, no persistent grid: ``tab, C, B, N, mult, ..., n_groups,
warps, per_block, span, ...``), whose kernels 2 and 3 run in the
template of kernels 1 and 4: the X solve scans every node twice, the
block loads all 8 channels with a loop of loads, and mult, 1 - mult and
dmult come from device memory. The third is the ``csrc/ionogram.cu``
before kernel 1 moved into ``gather_kernel`` (built with the current
header, current signature): kernel 1 there is ``ionogram_kernel<T, 1,
true, true>``, which counts cummax(den) < f^2/cp^2 over every node
before it tests whether the ray escapes, loads its table with a loop of
loads and leaves its f64 registers uncapped. The script writes variants
of it and of the current source into ``build/ionogram_attribution/``
(git ignores ``build/``), each with its header inlined, builds them with
``nvcc`` (the package's flags, all at once) and launches each through
its own library. Kernels 2 and 3 (``gather_kernel``) by variant, each
but ``earlier`` an exact text edit of the current source that fails
loudly when its line is missing, or a layout:

* ``earlier``: the earlier kernel;
* ``no_table``: the current source with the X solve's two scans over
  every node (the earlier ``xsolve``) in place of the cutoff-frequency
  table (kernel 2 only; against ``earlier``, the bulk copy of the table);
* ``trim``: only the channels the kernel reads copied (6 of 8; 7 with the
  solve's altitudes) (not kept);
* ``stage``: mult, 1 - mult and dmult staged in shared memory at P <=
  512 (not kept);
* ``uncapped``: f64 registers not capped (80-97 a thread: 2-3 blocks an
  SM in place of 4);
* ``cap_f32``: f32 registers capped too, for 6 blocks an SM (40 a thread;
  not kept);
* ``full``: the current source.

Each in the layout ``launch_shape`` gives it on its own blocks per SM
(its library's occupancy entry), as ``kernel_layout`` does for the
package's kernel.

Kernel 1 (``gather_osolve``, now ``gather_kernel<T, 1, true>``) by
variant:

* ``present``: the kernel before the move (the third argument);
* ``count``: the current source with the count over every node in place
  of the search of the cummax row (the escape test still first);
* ``loads``: the table by a loop of loads by every thread in place of the
  TMA bulk copy;
* ``uncapped``: as above;
* ``cap5``: f64 registers capped for 5 blocks an SM (48 a thread);
* ``full``: the current source.

Kernel 4 (``ionogram_kernel``, the sweep) is timed as ``earlier`` and
``full`` only: its code did not change.

Step 0, before anything runs: the SASS of each library (``cuobjdump
-sass``, :func:`tools.cuda_sass.sass_loops`): for the f32 and
f64 instantiations of kernels 1 to 4 in ``earlier``, ``present`` and the
current source, each loop with its instruction count and the fewest
instructions one iteration can issue (``path``), its MUFU (division,
root, sin/cos) and VOTE (ballot) instructions; then, for kernels 2 to 4,
whether the current source's loops are ``present``'s, count for count.
The tail loop is the largest loop with a MUFU.RSQ; the X solve's node
loops are the others with a MUFU.RCP (the division by f).

Checks, before anything is timed, on ``chip_smoke.py``'s profiles (f32
and f64, O and X, each kernel kind, the uniform grid and the 620-node
non-uniform ``alt_nu``; 26 cases) and on its razor cases (kernel 2 at
frequencies on each razor profile's node cutoffs fx_j and prefix maxima
cfx_j times (1 +- n ulp), n <= 4, at P = 200 and 2,000; 4 cases): every
variant in a warp-per-pair layout equals ``earlier`` bit for bit
(NaN-aware; for kernel 2 off the pairs whose cutoff is already exceeded
at the first node, which the earlier kernel gave NaN or alt_min + ~1e-6
km), kernel 1's equal ``present`` (on every pair; 2,048 profiles of the
benchmark's global grid besides); every variant in the block layout
equals ``full`` bit for
bit, and ``full`` is held to the plain version (f64 identical NaN masks
and <= 1e-6 km, f32 <= 1e-3 km of plain f32 and <= 0.1 km of plain f64).
A failed check stops the run.

Timing: X-20k (B=32, F=175, P=20,000, X mode) through the sweep on the
uniform grid and on ``alt_nu``; O-200 (B=1024, P=200) through
``gather_osolve`` and ``gather`` (O); the benchmark's global shape
(``vh_o200.global``: B=10,512 profiles of ``hfbench/inputs.py`` on the
73x144 grid, F=174 from 0.1 MHz, P=200, N=620) through
``gather_osolve``; X-200 through ``gather_xsolve`` and ``gather``. f32
and f64, median of 10 launches after 3 warm-ups (CUDA events), every
variant timed twice in turns (forward, then backward), with the card's
SM clock read under load. Prints one line per variant with its layout.
Then the current kernel alone over a grid of layouts, and the crossover
of the layouts: on the shapes of ``chip_smoke.py``'s P = 2,000 checks
and on wider batches (B up to 1,024), the current kernel a warp per pair
(``launch_shape``'s warp layout) and a block per pair, at P from 512 to
20,000, and the mean and worst regret (time over the faster layout's) of
``launch_shape``'s choice and of simpler rules over those points. Then
the card; the whole goes as JSON to
``build/ionogram_attribution/attribution.json``. """

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT_DIR = REPO / "build" / "ionogram_attribution"
INCLUDE = '#include "ionogram_common.cuh"\n'
GATHER = ("gather", "gather_xsolve")


# the crossover of the two layouts: the shapes of the checks at P = 2,000
# (chip_smoke.py) and wider batches, over P
CROSSOVER = [("sweep X uniform", "sweep", -1.0, "uniform", 32),
             ("sweep X alt_nu", "sweep", -1.0, "alt_nu", 64),
             ("gather_osolve O", "gather_osolve", 1.0, "uniform", 32),
             ("gather_xsolve X", "gather_xsolve", -1.0, "uniform", 32),
             ("gather O", "gather", 1.0, "uniform", 64),
             ("sweep X uniform", "sweep", -1.0, "uniform", 128),
             ("gather_xsolve X", "gather_xsolve", -1.0, "uniform", 256),
             ("gather X", "gather", -1.0, "uniform", 256),
             ("gather_osolve O", "gather_osolve", 1.0, "uniform", 256),
             ("gather_xsolve X", "gather_xsolve", -1.0, "uniform", 1024)]
CROSSOVER_P = (512, 1024, 2048, 4096, 8192, 20000)

# the two-scan X solve of the earlier kernel, for ``no_table``
_XSOLVE_SCANS = """// X mode (_xsolve_tile): first exceedance of the raw s = X + Y; f0 and f1
// are prefix maxima of the same s values, r0 is the raw s at k-1.
template <typename T>
__device__ Solve<T> xsolve(const T* alt, const T* den, const T* bm, int N,
                           T f, int lane, T alt0) {
  const T cp2 = T(kCP * kCP);
  const T gp = T(kGP);
  const T inv_f2 = T(1) / (f * f);
  int kf = N;
  for (int j = lane; j < N; j += 32) {
    if (cutoff_x(den, bm, j, cp2, inv_f2, gp, f) >= T(1)) {
      kf = j;
      break;
    }
  }
  kf = __reduce_min_sync(kFull, kf);
  const bool valid = kf < N;
  const int k = min(max(kf, 1), N - 1);
  T f0 = -INFINITY;
  for (int j = lane; j <= k - 1; j += 32) {
    const T v = cutoff_x(den, bm, j, cp2, inv_f2, gp, f);
    f0 = v > f0 ? v : f0;
  }
  f0 = warp_max(f0);
  const T s_k = cutoff_x(den, bm, k, cp2, inv_f2, gp, f);
  const T f1 = s_k > f0 ? s_k : f0;
  const T r0 = cutoff_x(den, bm, k - 1, cp2, inv_f2, gp, f);
  const bool first_exceeds = cutoff_x(den, bm, 0, cp2, inv_f2, gp, f) >= T(1);
  return crossing(f0, f1, alt[k - 1], alt[k], r0, first_exceeds, valid,
                  alt0);
}

"""


def kernel_of(fn):
    """(kernel 1 to 4, dtype, mode) of a demangled instantiation of
    ``csrc/ionogram.cu``, this revision's or an earlier one's (where
    kernels 1 to 4 all ran ``ionogram_kernel<T, MODE, SOLVE, UNIFORM>``);
    None for any other function."""
    for name in ("gather_kernel<", "ionogram_kernel<"):
        if name in fn:
            args = fn.split(name)[1].split(">")[0].split(", ")
            break
    else:
        return None
    t, mode = args[:2]
    if name == "gather_kernel<":        # <T, MODE, SOLVE>
        solve, uniform = args[2], "(bool)1"
    else:                               # <T, MODE(, SOLVE, UNIFORM)>
        solve, uniform = args[2:] if len(args) == 4 else ("(bool)0",) * 2
    if solve == "(bool)1":
        return (1 if mode == "(int)1" else 2, t, mode)
    return (3 if uniform == "(bool)1" else 4, t, mode)


def rep(s, a, b, n=1):
    """``s`` with ``a`` replaced by ``b``; ``a`` must occur ``n`` times."""
    if s.count(a) != n:
        raise ValueError(f"variant edit expected {n} of {a!r}, found "
                         f"{s.count(a)}")
    return s.replace(a, b)


def inline(cu, cuh):
    """One translation unit: ``cu`` with its header's text in place."""
    return rep(cu, INCLUDE, cuh.replace("#pragma once\n", "") + "\n")


def no_table(cu):
    """Kernel 2's solve by two scans over every node (the earlier way)."""
    cu = rep(cu, "// The lane's place in the altitude table",
             _XSOLVE_SCANS + "// The lane's place in the altitude table")
    cu = rep(cu, "  if constexpr (SOLVE && MODE < 0) cutoff_table(den, bmg, "
                 "N, cfx, part);\n", "")
    return rep(cu, "xsolve_table(alt, den, bm, row8, N, f, lane, alt0)",
               "xsolve(alt, den, bm, N, f, lane, alt0)")


_HEAD = "// bytes ahead of the table: the mbarrier, the valid-pair flag, 8 warp"


def trim(cu):
    """Only the channels the kernel reads into shared memory: den, d den,
    |B|, d|B|, psi, d psi (2-7), and alt (0) for kernel 2's solve."""
    cu = rep(cu, _HEAD, """// the channels kernels 2 and 3 read, in the order shared memory holds them
template <bool SOLVE>
struct Channels {
  static constexpr int first = SOLVE ? 0 : 2;  // first channel copied
  static constexpr bool skip_inv = SOLVE;      // channel 1 left out
  static constexpr int count = 8 - first - (skip_inv ? 1 : 0);
  static __device__ int row(int c) {           // row of channel c
    return c - first - (skip_inv && c > 1 ? 1 : 0);
  }
};
""" + _HEAD)
    cu = rep(cu, "  T* cfx = tb + kRows * ld;",
             "  T* cfx = tb + Channels<SOLVE>::count * ld;")
    cu = rep(cu, """        const unsigned bytes = (unsigned)(rows * ld * sizeof(T));
        mbar_expect(bar, bytes);
        bulk_copy(tb, p.tab + (size_t)b * p.C * ld, bytes, bar);""",
             """        using Ch = Channels<SOLVE>;
        const T* src = p.tab + (size_t)b * p.C * ld;
        const unsigned row = (unsigned)(ld * sizeof(T));
        mbar_expect(bar, Ch::count * row);
        if (Ch::skip_inv) {
          bulk_copy(tb, src, row, bar);
          bulk_copy(tb + ld, src + 2 * ld, (Ch::count - 1) * row, bar);
        } else {
          bulk_copy(tb, src + Ch::first * ld, Ch::count * row, bar);
        }""")
    cu = rep(cu, """  const T* alt = tb;
  const T* den = tb + 2 * ld;
  const T* dden = tb + 3 * ld;
  const T* bmg = tb + 4 * ld;
  const T* dbm = tb + 5 * ld;
  const T* bps = tb + 6 * ld;
  const T* dbp = tb + 7 * ld;""", """  using Ch = Channels<SOLVE>;
  const T* alt = SOLVE ? tb + Ch::row(0) * ld : nullptr;
  const T* den = tb + Ch::row(2) * ld;
  const T* dden = tb + Ch::row(3) * ld;
  const T* bmg = tb + Ch::row(4) * ld;
  const T* dbm = tb + Ch::row(5) * ld;
  const T* bps = tb + Ch::row(6) * ld;
  const T* dbp = tb + Ch::row(7) * ld;""")
    return rep(cu, "  size_t n = (size_t)kRows * ld;",
               "  size_t n = (size_t)Channels<SOLVE>::count * ld;")


def stage(cu):
    """mult, 1 - mult and dmult staged in shared memory (P <= 512)."""
    cu = rep(cu, _HEAD, "constexpr int kStageP = 512;\n" + _HEAD)
    cu = rep(cu, "  const int b = blockIdx.x, g = blockIdx.y;\n",
             "  T* staged = cfx + (SOLVE ? ld : 0);\n"
             "  const int b = blockIdx.x, g = blockIdx.y;\n")
    cu = rep(cu, "  __syncthreads();\n  if (!*has) {", """  const T* mult = p.mult;
  const T* omm = p.omm;
  const T* dmult = p.dmult;
  if (P <= kStageP) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      staged[i] = p.mult[i];
      staged[P + i] = p.omm[i];
      staged[2 * P + i] = p.dmult[i];
    }
    mult = staged;
    omm = staged + P;
    dmult = staged + 2 * P;
  }
  __syncthreads();
  if (!*has) {""")
    cu = rep(cu, "const int i0 = uniform_index(span * (p.mult[q] * p.inv_dalt)",
             "const int i0 = uniform_index(span * (mult[q] * p.inv_dalt)")
    cu = rep(cu, "                                p.dmult[q], p.omm[q], q, P);",
             "                                dmult[q], omm[q], q, P);")
    return rep(cu, "  const size_t smem = K::smem(p.C, p.N, p.ld);",
               "  const size_t smem = K::smem(p.C, p.N, p.ld) +\n"
               "      (K::gather && p.P <= kStageP ? 3 * sizeof(T) * p.P : 0);")


_BOUNDS = "__launch_bounds__(kMaxThreads, sizeof(T) == 8 ? 4 : 1)"


def uncapped(cu):
    """gather_kernel's registers left to the compiler in f64 too."""
    return rep(cu, _BOUNDS, "__launch_bounds__(kMaxThreads)")


def cap_f32(cu):
    """gather_kernel's f32 registers capped too, for 6 blocks an SM."""
    return rep(cu, _BOUNDS,
               "__launch_bounds__(kMaxThreads, sizeof(T) == 8 ? 4 : 6)")


# kernel 1's search of the cummax row, and the count over every node it
# replaced
_SEARCH = """  int lo = 0, hi = N;  // row[j] < thr for j < lo, not for j >= hi
  while (lo < hi) {
    const int s = (hi - lo + 31) >> 5;
    const unsigned m =
        __ballot_sync(kFull, lo + lane * s < hi && row[lo + lane * s] < thr);
    if (m == 0) break;
    const int c = __popc(m);
    hi = min(lo + c * s, hi);
    lo += (c - 1) * s + 1;
  }
  return lo;
"""
_LINEAR_COUNT = """  int cnt = 0;
  for (int j = lane; j < N; j += 32) cnt += row[j] < thr ? 1 : 0;
  return __reduce_add_sync(kFull, cnt);
"""


def count(cu):
    """Kernel 1 counts cummax(den) < f^2/cp^2 over every node (after its
    escape test) in place of the search."""
    return rep(cu, _SEARCH, _LINEAR_COUNT)


def loads(cu):
    """gather_kernel's table by a loop of loads by every thread in place
    of the TMA bulk copy."""
    cu = rep(cu, """        mbar_expect(bar, bytes);
        bulk_copy(tb, p.tab + (size_t)b * p.C * ld, bytes, bar);
""", """        (void)bytes;
""")
    return rep(cu, "  mbar_wait(bar, 0);\n", """  for (int i = threadIdx.x; i < rows * ld; i += blockDim.x)
    tb[i] = p.tab[(size_t)b * p.C * ld + i];
  __syncthreads();
""")


def cap5(cu):
    """gather_kernel's f64 registers capped for 5 blocks an SM."""
    return rep(cu, _BOUNDS,
               "__launch_bounds__(kMaxThreads, sizeof(T) == 8 ? 5 : 1)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/ionogram.cu")
    ap.add_argument("earlier_header", help="its ionogram_common.cuh")
    ap.add_argument("present", help="csrc/ionogram.cu before kernel 1 "
                                    "moved into gather_kernel")
    ap.add_argument("--quick", action="store_true",
                    help="stop after the variants' timing (no layout grid, "
                         "no crossover)")
    ap.add_argument("--kinds", default="sweep,gather_osolve,gather_xsolve,"
                                       "gather",
                    help="the kernels to check and time (comma-separated "
                         "kinds)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyrayhf_tpu_torch import cuda_ext, profiling
    from pyrayhf_tpu_torch import pallas_vh as pv
    from tools.cuda_sass import sass_loops

    card = cs.card_line()
    cu = (cuda_ext.SRC_DIR / "ionogram.cu").read_text()
    cuh = (cuda_ext.SRC_DIR / "ionogram_common.cuh").read_text()
    srcs = {"earlier": inline(Path(args.earlier).read_text(),
                              Path(args.earlier_header).read_text()),
            "no_table": inline(no_table(cu), cuh),
            "trim": inline(trim(cu), cuh),
            "stage": inline(stage(cu), cuh),
            "uncapped": inline(uncapped(cu), cuh),
            "cap_f32": inline(cap_f32(cu), cuh),
            "present": inline(Path(args.present).read_text(), cuh),
            "count": inline(count(cu), cuh),
            "loads": inline(loads(cu), cuh),
            "cap5": inline(cap5(cu), cuh),
            "cur": inline(cu, cuh)}
    kinds = args.kinds.split(",")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(cuda_ext.find_nvcc())
    procs = {}
    for name, src in srcs.items():
        path = OUT_DIR / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_ext.NVCC_FLAGS, "-shared", "-o",
             str(OUT_DIR / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log[-4000:]}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "registers" in ln]
        print(f"built {name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        lib.pyrayhf_ionogram.restype = ctypes.c_int
        libs[name] = lib
    cuda_ext.load()                     # the package's own library
    res = {"card": card}

    # ---- step 0: the SASS of kernels 1 to 4 --------------------------------
    print("SASS loops of kernels 1 to 4 (cuobjdump -sass): [instructions, "
          "fewest and most an iteration issues, MUFU, ballots] per loop; "
          "tail = the loop with a MUFU.RSQ of the most fewest", flush=True)
    res["sass"] = {}
    by_kernel = {}
    for name in ("earlier", "present", "cur"):
        for fn, loops in sass_loops(OUT_DIR / f"{name}.so").items():
            key = kernel_of(fn)
            if key is None:
                continue
            res["sass"][f"{name} {fn}"] = loops
            by_kernel[name, key] = [
                (lp["instructions"], lp["path"], lp["longest"],
                 tuple(lp["mufu"]), lp["vote"]) for lp in loops]
            print(f"  {name} kernel {key[0]} {fn}:", flush=True)
            for lp in loops:
                print(f"    [{lp['start']:#x}, {lp['end']:#x}] "
                      f"{lp['instructions']} instr, path {lp['path']}, "
                      f"longest {lp['longest']}, "
                      f"{' '.join(lp['mufu']) or 'no MUFU'}, "
                      f"{lp['vote']} VOTE", flush=True)
    for name, key in sorted(k for k in by_kernel if k[0] == "cur"):
        if key[0] == 1:
            continue
        same = by_kernel.get(("present", key)) == by_kernel[name, key]
        res["sass"][f"kernel {key} loops as present"] = same
        print(f"  kernel {key[0]} {key[1]} mode {key[2]}: loops "
              f"{'the same as' if same else 'DIFFER from'} present's",
              flush=True)

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(cs.SEED)
    alt = np.linspace(80.0, 699.0, cs.N_ALT)
    freqs = np.round(np.arange(1, cs.F_MAIN + 1) * 0.1, 10)
    main_prof = cs.profiles(rng, cs.B_MAIN, alt)
    cs.profiles(rng, cs.GLOBAL_GRID[0] * cs.GLOBAL_GRID[1], alt)
    alt_nu = np.concatenate([np.linspace(80.0, 200.0, 241)[:-1],
                             np.linspace(200.0, 699.0, 380)])
    nu_prof = cs.profiles(rng, 256, alt_nu)
    # the benchmark's global grid (vh_o200.global), one UT step
    from hfbench import inputs
    glob = inputs.profiles({"profiles_per_call": 73 * 144, "pool_calls": 1,
                            "sites": "global", "grid": [73, 144],
                            "e_layer_share": 0.25}, 2 ** 33 + 19, alt, dev)
    glob = [x.cpu().numpy() for x in glob]
    grids = {"uniform": (alt, main_prof), "alt_nu": (alt_nu, nu_prof),
             "global": (alt, glob)}
    razor_prof = cs.razor_profiles(alt, *main_prof)

    # (variant, source)
    variants = [("earlier", "earlier"), ("present", "present"),
                ("no_table", "no_table"), ("trim", "trim"),
                ("stage", "stage"),
                ("count", "count"), ("loads", "loads"),
                ("uncapped", "uncapped"), ("cap_f32", "cap_f32"),
                ("cap5", "cap5"), ("full", "cur")]

    def prep(kind, mm, grid, B, P, dtype):
        g, prof = grids[grid]
        fr = freqs[:174] if grid == "global" else freqs
        t = [torch.as_tensor(np.asarray(x)[:B] if np.ndim(x) == 2 else x,
                             dtype=dtype, device=dev)
             for x in (fr, *prof, g)]
        inv = None if kind == "sweep" else pv.uniform_inv_dalt(t[-1])
        return t, pv.prepare_kernel_args(kind, *t, mm, P, inv)

    def blocks(src, a):
        """Blocks an SM holds of variant source ``src``'s kernel for args
        ``a`` (its library's occupancy entry; the earlier one has no row
        stride)."""
        lib = libs[src]
        stride = [] if src == "earlier" else [a.tab.shape[2]]
        argv = [int(a.tab.dtype == torch.float64),
                1 if a.mode_mult > 0 else -1,
                int(a.kind in ("gather_osolve", "gather_xsolve")),
                int(a.inv_dalt is not None), a.tab.shape[1], a.n_alt,
                *stride, pv._WARPS]
        lib.pyrayhf_ionogram_blocks_per_sm.argtypes = [ctypes.c_int] * len(
            argv)
        n = lib.pyrayhf_ionogram_blocks_per_sm(*argv)
        if n < 0:
            raise RuntimeError(f"{src} occupancy: error {-n}")
        return n

    def launcher(variant, a, layout=None):
        src = dict(variants)[variant]
        lib = libs[src]
        B, C, ld = a.tab.shape
        N = a.n_alt
        F, P = a.freq_hz.shape[0], a.mult.shape[0]
        dt = int(a.tab.dtype == torch.float64)
        mode = 1 if a.mode_mult > 0 else -1
        solve = a.kind in ("gather_osolve", "gather_xsolve")
        uniform = a.inv_dalt is not None
        out = torch.empty((B, F), dtype=a.tab.dtype, device=dev)
        tab = a.tab
        if layout is None:   # launch_shape on the variant's own occupancy
            s = pv.launch_shape(B, F, P, n_sm, blocks(src, a))
            layout = (s.n_groups, s.warps, int(s.per_block))
        # rows of N: the earlier kernels', present's kernel 1
        if (src == "earlier" or (src == "present" and a.kind ==
                                 "gather_osolve")) and ld != N:
            tab = tab[:, :, :N].contiguous()
            ld = N

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())

        argv = [dt, mode, int(solve), int(uniform), ptr(tab), C, B, N,
                *([] if src == "earlier" else [ld]), ptr(a.mult),
                ptr(a.omm), ptr(a.dmult), P, ptr(a.freq_hz), F, *layout]
        argv += [ptr(a.span), ptr(a.slope), ptr(a.emax), ptr(a.valid),
                 ptr(a.alt_min), ctypes.c_double(a.inv_dalt or 0.0)]

        def go():
            err = lib.pyrayhf_ionogram(
                *argv, ptr(out),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            if err:
                raise RuntimeError(f"{variant}: launch error {err}")
            return out
        go.layout = tuple(layout)
        return go

    def names_for(kind):
        if kind == "gather_osolve":
            return ["present", "count", "loads", "uncapped", "cap5", "full"]
        if kind not in GATHER:
            return ["earlier", "full"]
        return [v for v, _ in variants
                if v not in ("present", "count", "loads", "cap5")
                and (v != "no_table" or kind == "gather_xsolve")]

    def diff(o, ref, skip=None):
        """Elements of ``o`` that differ from ``ref`` (NaN-aware), outside
        the [B, F] mask ``skip``."""
        keep = torch.ones_like(ref, dtype=torch.bool) if skip is None \
            else ~skip
        nan = torch.isnan(ref)
        return int(((torch.isnan(o) != nan) & keep).sum()
                   + (o[~nan & keep] != ref[~nan & keep]).sum())

    def first_node(a):
        """[B, F] bool: the pairs of prepared args ``a`` whose cutoff is
        already exceeded at the first node, where the in-kernel solves
        differ from the earlier kernel's (``crossing`` in
        csrc/ionogram.cu)."""
        tab, f = pv._table(a), a.freq_hz[None, :]
        s = tab[:, 2, :1] * (cs.CP * cs.CP) * (1.0 / (f * f))
        if a.mode_mult < 0:
            s = s + tab[:, 4, :1] * cs.G_P / f
        return s >= 1.0

    def plain(kind, mm, t, a, P):
        if kind == "sweep":
            return pv.ionogram_fast_xla(*t, mode_mult=mm, n_points=P)
        return pv.plain_ionogram(a)

    def within(o, ref, tol):
        """(NaN-mask differences, max |diff| on values finite in both,
        values over tol)."""
        o, ref = o.double(), ref.double()
        m = ~torch.isnan(ref) & ~torch.isnan(o)
        d = (o[m] - ref[m]).abs()
        tol = torch.as_tensor(tol, dtype=torch.float64, device=o.device)
        tol = tol.expand_as(ref)[m] if tol.ndim else tol
        return (int((torch.isnan(o) != torch.isnan(ref)).sum()),
                float(d.max()) if d.numel() else 0.0, int((d > tol).sum()))

    checks = []
    print("checks: warp layouts bit for bit the earlier kernel, block "
          "layouts bit for bit full; full vs plain f64 (f64: identical NaN "
          "masks, <= 1e-6 km) and vs plain f32 (f32: identical NaN masks, "
          "<= 1e-3 km); f32 vs plain f64 reported beside plain f32 vs "
          "plain f64 (0.1 km)", flush=True)
    cases = [("sweep", 1.0, "uniform", 64, 200),
             ("sweep", -1.0, "uniform", 64, 200),
             ("sweep", 1.0, "alt_nu", 64, 200),
             ("sweep", -1.0, "alt_nu", 64, 2000),
             ("sweep", -1.0, "uniform", 32, 20000),
             ("sweep", -1.0, "alt_nu", 32, 20000),
             ("gather_osolve", 1.0, "uniform", 1024, 200),
             ("gather_osolve", 1.0, "uniform", 32, 2000),
             ("gather_osolve", 1.0, "global", 2048, 200),
             ("gather_xsolve", -1.0, "uniform", 1024, 200),
             ("gather_xsolve", -1.0, "uniform", 32, 20000),
             ("gather", 1.0, "uniform", 64, 2000),
             ("gather", 1.0, "uniform", 1024, 200),
             ("gather", -1.0, "uniform", 1024, 200),
             ("razor", -1.0, "uniform", 12, 200),
             ("razor", -1.0, "uniform", 12, 2000)]
    failed = []
    cases = [c for c in cases
             if (c[0] if c[0] != "razor" else "gather_xsolve") in kinds]
    for kind, mm, grid, B, P in cases:
        plains = {}
        for dtype in (torch.float64, torch.float32):
            if kind == "razor":
                a = cs.razor_args(torch, pv, razor_prof, alt, P, dtype, dev)
                t = None
            else:
                t, a = prep(kind, mm, grid, B, P, dtype)
            vs = names_for(a.kind)
            gos = {v: launcher(v, a) for v in vs}
            outs = {v: go().clone() for v, go in gos.items()}
            # a warp per pair sums in one order whatever the groups: bit
            # for bit the earlier kernel in a warp layout; a block per pair
            # in another: bit for bit full in the block layout
            bitwise, refs = {}, {0: vs[0], 1: "full"}
            for v in vs[1:]:
                ref = refs[gos[v].layout[2]]
                if gos[ref].layout[2] != gos[v].layout[2]:
                    raise RuntimeError(f"{v}: no reference in its layout "
                                       f"{gos[v].layout}")
                skip = (first_node(a) if ref == "earlier" and a.kind ==
                        "gather_xsolve" else None)
                bitwise[v] = diff(outs[v], outs[ref], skip)
            plains[dtype] = plain(a.kind, mm, t, a, P)
            name = (f"{kind} {'O' if mm > 0 else 'X'} {grid} B={B} P={P} "
                    f"F={a.freq_hz.shape[0]} {str(dtype)[6:]}")
            if dtype == torch.float64:
                tol = {"plain f64": within(outs["full"], plains[dtype],
                                           1e-6)}
                ok = tol["plain f64"][0] == 0 and tol["plain f64"][2] == 0
            else:
                tol = {"plain f32": within(outs["full"], plains[dtype],
                                           cs.razor_tol_f32(plains[dtype])
                                           if kind == "razor" else 1e-3)}
                if kind != "razor":    # razor f32 and f64 f differ
                    tol["plain f64"] = within(outs["full"],
                                              plains[torch.float64], 0.1)
                    tol["plain f32 vs plain f64"] = within(
                        plains[dtype], plains[torch.float64], 0.1)
                ok = tol["plain f32"][0] == 0 and tol["plain f32"][2] == 0
            ok = ok and not any(bitwise.values())
            print(f"  {name}: elements differing {bitwise}; full vs "
                  + ", ".join(f"{n}: {m} NaN-mask differences, max "
                              f"{e:.3e} km, {c} over tol"
                              for n, (m, e, c) in tol.items())
                  + f"; layouts { {v: g.layout for v, g in gos.items()} }"
                  + ("" if ok else "  <-- FAILED"), flush=True)
            if not ok:     # the values over tol, for the record
                ref = plains[dtype].double()
                o = outs["full"].double()
                m = ~torch.isnan(ref) & ~torch.isnan(o)
                d = torch.where(m, (o - ref).abs(), 0.0)
                for bi, fi in torch.nonzero(d > (1e-6 if dtype ==
                                                 torch.float64 else 1e-3)
                                            )[:10].tolist():
                    print(f"    b={bi} f={float(a.freq_hz[fi])!r} Hz: "
                          f"kernel {float(o[bi, fi])!r}, plain "
                          f"{float(ref[bi, fi])!r}", flush=True)
            checks.append(dict(case=name, bitwise=bitwise, vs_plain=tol,
                               ok=ok))
            if not ok:
                failed.append(name)
    res["checks"] = checks
    if failed:
        raise RuntimeError(f"checks failed: {failed}")

    timings = [("sweep X-20k uniform", "sweep", -1.0, "uniform", 32, 20000),
               ("sweep X-20k alt_nu", "sweep", -1.0, "alt_nu", 32, 20000),
               ("gather_osolve O-200", "gather_osolve", 1.0, "uniform", 1024,
                200),
               ("gather_osolve global", "gather_osolve", 1.0, "global", 10512,
                200),
               ("gather_xsolve X-200", "gather_xsolve", -1.0, "uniform", 1024,
                200),
               ("gather X-200", "gather", -1.0, "uniform", 1024, 200),
               ("gather O-200", "gather", 1.0, "uniform", 1024, 200)]
    print(f"timing: median of 10 after 3 warm-ups, two turns; {card}",
          flush=True)
    timings = [t for t in timings if t[1] in kinds]
    for label, kind, mm, grid, B, P in timings:
        for dtype in (torch.float32, torch.float64):
            _, a = prep(kind, mm, grid, B, P, dtype)
            names = names_for(kind)
            gos = {v: launcher(v, a) for v in names}
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                ms[v].append(profiling.time_launch(gos[v], iters=10)[0])
            clock = cs.sm_clock_under(torch, gos["full"])
            key = f"{label} {str(dtype)[6:]}"
            res[key] = {"sm_clock_mhz": clock}
            for v in names:
                med = statistics.median(ms[v])
                res[key][v] = dict(ms=ms[v], median_ms=med,
                                   layout=list(gos[v].layout))
                print(f"  {key} {v}: {ms[v][0]:.4f} / {ms[v][1]:.4f} ms, "
                      f"median {med:.4f}, layout {gos[v].layout}",
                      flush=True)
            print(f"  {key}: SM clock under load {clock} MHz", flush=True)
    if args.quick:
        (OUT_DIR / "attribution.json").write_text(json.dumps(res, indent=1))
        print(f"card: {card}")
        return 0
    print("layouts of the current kernel (warps, groups; w: a warp per "
          "pair, b: a block per pair), median of 10 after 3 warm-ups, two "
          "turns", flush=True)
    for label, kind, mm, grid, B, P in timings:
        for dtype in (torch.float32, torch.float64):
            _, a = prep(kind, mm, grid, B, P, dtype)
            F = a.freq_hz.shape[0]
            lays = ([(F, w, 1) for w in range(4, 9)] if P > 2000 else
                    [(g, w, 0) for w in range(4, 9) for g in (1, 2, 3, 4, 6)])
            gos = [launcher("full", a, lay) for lay in lays]
            ms = [[] for _ in lays]
            order = list(range(len(lays)))
            for i in order + order[::-1]:
                ms[i].append(profiling.time_launch(gos[i], iters=10)[0])
            key = f"{label} {str(dtype)[6:]}"
            res[f"layouts {key}"] = {str(lay): m for lay, m in zip(lays, ms)}
            chosen = launcher("full", a).layout
            print(f"  {key} (kernel_layout: {chosen}): " + ", ".join(
                f"{lay[1]}{'b' if lay[2] else 'w'}{lay[0]} "
                f"{statistics.median(m):.4f}" for lay, m in zip(lays, ms)),
                flush=True)
    print("crossover: the current kernel a warp per pair (launch_shape's "
          "warp layout) vs a block per pair, by P; median of 10 after 3 "
          "warm-ups, two turns", flush=True)
    for label, kind, mm, grid, B in CROSSOVER:
        for dtype in (torch.float32, torch.float64):
            for P in CROSSOVER_P:
                _, a = prep(kind, mm, grid, B, P, dtype)
                F = a.freq_hz.shape[0]
                bps = pv.blocks_per_sm(
                    dev.index, int(dtype == torch.float64), int(mm),
                    kind in ("gather_osolve", "gather_xsolve"),
                    a.inv_dalt is not None, a.tab.shape[1], a.n_alt,
                    a.tab.shape[2])
                warp = pv.launch_shape(B, F, 1, n_sm, bps)
                lays = [(warp.n_groups, warp.warps, 0), (F, pv._WARPS, 1)]
                gos = [launcher("full", a, lay) for lay in lays]
                ms = [[], []]
                for i in (0, 1, 1, 0):
                    ms[i].append(profiling.time_launch(gos[i], iters=10)[0])
                med = [statistics.median(m) for m in ms]
                key = f"crossover {label} B={B} P={P} {str(dtype)[6:]}"
                res[key] = {"P": P, "warp": ms[0], "block": ms[1],
                            "warp_layout": list(lays[0]),
                            "chosen": list(launcher("full", a).layout)}
                print(f"  {key}: warp {med[0]:.4f} ms, block {med[1]:.4f} "
                      f"ms (block/warp {med[1] / med[0]:.3f}); kernel_layout "
                      f"{res[key]['chosen']}", flush=True)
    # each rule's time over the faster layout's, over the crossover points
    rules = {"launch_shape": lambda r: r["chosen"][2] == 1,
             "P >= 1,024 for any B": lambda r: r["P"] >= 1024,
             "always a warp per pair": lambda r: False,
             "always a block per pair": lambda r: True}
    for name, block in rules.items():
        ratios = []
        for key, r in res.items():
            if key.startswith("crossover "):
                w = statistics.median(r["warp"])
                b = statistics.median(r["block"])
                ratios.append((b if block(r) else w) / min(w, b))
        res[f"regret {name}"] = ratios
        print(f"  {name}: mean regret {statistics.mean(ratios) - 1:.4f}, "
              f"worst {max(ratios):.4f} (time over the faster layout's, "
              f"{len(ratios)} points)", flush=True)
    (OUT_DIR / "attribution.json").write_text(json.dumps(res, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
