#!/usr/bin/env python3
"""Where the ionogram kernels' time goes (``csrc/ionogram.cu``), on one
CUDA card, by variants timed in turns.

    git show 5cdf81b:pyrayhf_tpu_torch/csrc/ionogram.cu \\
        > build/ionogram_earlier.cu
    git show 5cdf81b:pyrayhf_tpu_torch/csrc/ionogram_common.cuh \\
        > build/ionogram_common_earlier.cuh
    python3 tools/ionogram_attribution.py build/ionogram_earlier.cu \\
        build/ionogram_common_earlier.cuh

The arguments are an earlier ``csrc/ionogram.cu`` and its
``ionogram_common.cuh``: the kernel that runs the mu' tail on every
(profile, frequency), finds the sweep's segment by a binary search per
point and puts one warp on each pair (the form it had before the
escaped-pair skip). The script writes variants of it and of the current
source into ``build/ionogram_attribution/`` (git ignores ``build/``), each
with its header inlined, builds them with ``nvcc`` (the package's flags,
all at once) and launches each through its own library. Variants, each
an exact text edit of the current source that fails loudly when its line
is missing:

* ``earlier``: the earlier kernel, in its own layout (8 warps, contiguous
  frequency groups);
* ``skip``: the current source with the sweep's cursor replaced by the
  binary search and psi's sin and cos as two calls, in the earlier layout
  (8 warps, as many groups, interleaved): the escaped-pair skip alone;
* ``skip_walk``: with the cursor as well, in the earlier layout;
* ``skip_walk_groups``: the same, a warp per pair, with the groups
  ``launch_shape`` gives the warp layout (from the waves of resident
  blocks);
* ``skip_walk_block``: the same in ``launch_shape``'s layout (a block
  per pair on long grids);
* ``full``: the current source (one ``sincos`` for psi) in that layout;
* ``psi_node``: ``full`` with psi's sin and cos taken once per altitude
  node, and used where the segment's delta psi is 0.

The variants of the current source all launch in the layout that
``launch_shape`` gives the current kernel (its registers), so that a
block-per-pair variant sums in the same order as ``full``. Then the
current kernel alone is timed over a grid of layouts: a warp per pair
at 4-8 warps a block and 1-6 frequency groups on the P = 200 cases, a
block per pair at 4-8 warps on X-20k.

Checks, before anything is timed, on ``chip_smoke.py``'s profiles (f32
and f64, O and X, each kernel kind, the uniform grid and the 620-node
non-uniform ``alt_nu``): every variant in a warp-per-pair layout equals
``earlier`` bit for bit (NaN-aware); every variant in the block layout equals
``full`` bit for bit, and ``full`` is held to the plain version (f64
identical NaN masks and <= 1e-6 km, f32 <= 1e-3 km of plain f32 and <=
0.1 km of plain f64). A failed check stops the run.

Timing: X-20k (B=32, F=175, P=20,000, X mode) through the sweep on the
uniform grid and on ``alt_nu``; O-200 (B=1024, P=200) through
``gather_osolve``; X-200 through ``gather_xsolve`` and ``gather``. f32 and
f64, median of 10 launches after 3 warm-ups (CUDA events), every variant
timed twice in turns (forward, then backward). Prints one line per
variant with its layout. Last, the crossover of the layouts: on the
shapes of ``chip_smoke.py``'s P = 2,000 checks and on wider batches (B
up to 1,024), the current kernel a warp per pair (``launch_shape``'s warp
layout) and a block per pair, at P from 512 to 20,000, and the mean and
worst regret (time over the faster layout's) of ``launch_shape``'s
choice and of simpler rules over those points. Then the card; the whole
goes as JSON to ``build/ionogram_attribution/attribution.json``.
"""

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


# the crossover of the two layouts: the shapes of the checks at P = 2,000
# (chip_smoke.py) and wider batches, over P
CROSSOVER = [("sweep X uniform", "sweep", -1.0, "uniform", 32),
             ("sweep X alt_nu", "sweep", -1.0, "alt_nu", 64),
             ("gather_osolve O", "gather_osolve", 1.0, "uniform", 32),
             ("gather_xsolve X", "gather_xsolve", -1.0, "uniform", 32),
             ("gather O", "gather", 1.0, "uniform", 64),
             ("sweep X uniform", "sweep", -1.0, "uniform", 128),
             ("sweep X uniform", "sweep", -1.0, "uniform", 256),
             ("gather_osolve O", "gather_osolve", 1.0, "uniform", 128),
             ("gather_osolve O", "gather_osolve", 1.0, "uniform", 256),
             ("gather_osolve O", "gather_osolve", 1.0, "uniform", 1024)]
CROSSOVER_P = (512, 1024, 2048, 4096, 8192, 20000)


def rep(s, a, b, n=1):
    """``s`` with ``a`` replaced by ``b``; ``a`` must occur ``n`` times."""
    if s.count(a) != n:
        raise ValueError(f"variant edit expected {n} of {a!r}, found "
                         f"{s.count(a)}")
    return s.replace(a, b)


def inline(cu, cuh):
    """One translation unit: ``cu`` with its header's text in place."""
    return rep(cu, INCLUDE, cuh.replace("#pragma once\n", "") + "\n")


def binary_search(cu):
    """The sweep's segment by a binary search per point (the earlier way)."""
    return rep(cu, """        seek(alt, N, x, cur);
        i0 = min(max(cur.lo - 1, 0), N - 2);""", """        int lo = 0, hi = N;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (alt[mid] <= x) lo = mid + 1; else hi = mid;
        }
        i0 = min(max(lo - 1, 0), N - 2);""")


_SINCOS = """  T sinp, cosp;  // one call, the same values as sin and cos
  if constexpr (sizeof(T) == 4) {
    sincosf(psi, &sinp, &cosp);
  } else {
    sincos(psi, &sinp, &cosp);
  }"""


def sin_and_cos(cuh):
    """``sin`` and ``cos`` of psi as two calls (the earlier way)."""
    return rep(cuh, _SINCOS, """  const T sinp = sin(psi);
  const T cosp = cos(psi);""")


def psi_node(cu, cuh):
    """psi's sin and cos once per node, where the segment's dpsi is 0."""
    cuh = rep(cuh, """T mup_stable(T X, T Y, T psi_deg, T eps_crit,
                                        T eps_max, bool& ok_out) {""",
              """T mup_stable(T X, T Y, T psi_deg, T eps_crit,
                                        T eps_max, bool& ok_out,
                                        bool node = false, T sin_node = 0,
                                        T cos_node = 0) {""")
    cuh = rep(cuh, _SINCOS, """  T sinp = sin_node, cosp = cos_node;
  if (!node) {
    if constexpr (sizeof(T) == 4) {
      sincosf(psi, &sinp, &cosp);
    } else {
      sincos(psi, &sinp, &cosp);
    }
  }""")
    cuh = rep(cuh, """                                       int q, int P) {""",
              """                                       int q, int P,
                                       bool node = false, T sin_node = 0,
                                       T cos_node = 0) {""")
    cuh = rep(cuh, "mup_stable<T, MODE>(X, Y, bpv, eps, emax, ok);",
              "mup_stable<T, MODE>(X, Y, bpv, eps, emax, ok, node, sin_node, "
              "cos_node);")
    cu = rep(cu, "sizeof(T) * ((size_t)C * N + kMaxThreads / 32)",
             "sizeof(T) * ((size_t)(C + 2) * N + kMaxThreads / 32)")
    cu = rep(cu, "  T* part = s + tab_len;     // the warps' sums (block layout)\n",
             """  T* sps = s + tab_len;
  T* cps = sps + N;
  T* part = cps + N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const T psi = bps[i] * T(kPI / 180.0);
    sps[i] = sin(psi);
    cps[i] = cos(psi);
  }
  __syncthreads();
""")
    cu = rep(cu, """                                p.dmult[q], p.omm[q], q, p.P);""",
             """                                p.dmult[q], p.omm[q], q, p.P,
                                dbp[i0] == T(0), sps[i0], cps[i0]);""")
    return cu, cuh


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/ionogram.cu")
    ap.add_argument("earlier_header", help="its ionogram_common.cuh")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyrayhf_tpu_torch import cuda_ext, profiling
    from pyrayhf_tpu_torch import pallas_vh as pv

    card = cs.card_line()
    cu = (cuda_ext.SRC_DIR / "ionogram.cu").read_text()
    cuh = (cuda_ext.SRC_DIR / "ionogram_common.cuh").read_text()
    pn_cu, pn_cuh = psi_node(cu, cuh)
    srcs = {"earlier": inline(Path(args.earlier).read_text(),
                          Path(args.earlier_header).read_text()),
            "skip": inline(binary_search(cu), sin_and_cos(cuh)),
            "skip_walk": inline(cu, sin_and_cos(cuh)),
            "cur": inline(cu, cuh),
            "psi_node": inline(pn_cu, pn_cuh)}
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
    grids = {"uniform": (alt, main_prof), "alt_nu": (alt_nu, nu_prof)}

    # (variant, source, layout): "earlier" the earlier kernel's own,
    # "earlier_shape" its warps and group count (interleaved), "groups"
    # launch_shape's warp layout, "shape" launch_shape's choice
    variants = [("earlier", "earlier", "earlier"),
                ("skip", "skip", "earlier_shape"),
                ("skip_walk", "skip_walk", "earlier_shape"),
                ("skip_walk_groups", "skip_walk", "groups"),
                ("skip_walk_block", "skip_walk", "shape"),
                ("full", "cur", "shape"), ("psi_node", "psi_node", "shape")]

    def prep(kind, mm, grid, B, P, dtype):
        g, prof = grids[grid]
        t = [torch.as_tensor(np.asarray(x)[:B] if np.ndim(x) == 2 else x,
                             dtype=dtype, device=dev)
             for x in (freqs, *prof, g)]
        inv = None if kind == "sweep" else pv.uniform_inv_dalt(t[-1])
        return t, pv.prepare_kernel_args(kind, *t, mm, P, inv)

    def blocks(a):
        """Blocks an SM holds of the current kernel for args ``a``."""
        return pv.blocks_per_sm(
            dev.index, int(a.tab.dtype == torch.float64),
            1 if a.mode_mult > 0 else -1,
            a.kind in ("gather_osolve", "gather_xsolve"),
            a.inv_dalt is not None, *a.tab.shape[1:])

    def launcher(variant, a, layout=None):
        _, src, lay = next(v for v in variants if v[0] == variant)
        lib = libs[src]
        B, C, N = a.tab.shape
        F, P = a.freq_hz.shape[0], a.mult.shape[0]
        dt = int(a.tab.dtype == torch.float64)
        mode = 1 if a.mode_mult > 0 else -1
        solve = a.kind in ("gather_osolve", "gather_xsolve")
        uniform = a.inv_dalt is not None
        out = torch.empty((B, F), dtype=a.tab.dtype, device=dev)
        f_group, w8 = pv.mxu_launch_shape(B, F, n_sm)
        if layout is None and lay.startswith("earlier"):
            layout = ((f_group, w8) if lay == "earlier"
                      else (-(-F // f_group), w8, 0))
        elif layout is None:   # the current kernel's, whatever the variant
            shape = pv.launch_shape(B, F, 1 if lay == "groups" else P, n_sm,
                                    blocks(a))
            layout = (shape.n_groups, shape.warps, int(shape.per_block))

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())

        argv = [dt, mode, int(solve), int(uniform), ptr(a.tab), C, B, N,
                ptr(a.mult), ptr(a.omm), ptr(a.dmult), P, ptr(a.freq_hz), F,
                *layout, ptr(a.span), ptr(a.slope), ptr(a.emax),
                ptr(a.valid), ptr(a.alt_min),
                ctypes.c_double(a.inv_dalt or 0.0)]

        def go():
            err = lib.pyrayhf_ionogram(
                *argv, ptr(out),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            if err:
                raise RuntimeError(f"{variant}: launch error {err}")
            return out
        go.layout = layout
        return go

    def diff(o, ref):
        nan = torch.isnan(ref)
        return int((torch.isnan(o) != nan).sum()
                   + (o[~nan] != ref[~nan]).sum())

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
        return (int((torch.isnan(o) != torch.isnan(ref)).sum()),
                float(d.max()) if d.numel() else 0.0, int((d > tol).sum()))

    checks = []
    print("checks: warp layouts bit for bit the earlier kernel, block "
          "layouts bit for bit full; full vs plain f64 (f64: identical NaN masks, <= 1e-6 km) "
          "and vs plain f32 (f32: identical NaN masks, <= 1e-3 km); f32 vs "
          "plain f64 reported beside plain f32 vs plain f64 (0.1 km)",
          flush=True)
    cases = [("sweep", 1.0, "uniform", 64, 200),
             ("sweep", -1.0, "uniform", 64, 200),
             ("sweep", 1.0, "alt_nu", 64, 200),
             ("sweep", -1.0, "alt_nu", 64, 2000),
             ("sweep", -1.0, "uniform", 32, 20000),
             ("sweep", -1.0, "alt_nu", 32, 20000),
             ("gather_osolve", 1.0, "uniform", 1024, 200),
             ("gather_osolve", 1.0, "uniform", 32, 2000),
             ("gather_xsolve", -1.0, "uniform", 1024, 200),
             ("gather_xsolve", -1.0, "uniform", 32, 20000),
             ("gather", 1.0, "uniform", 64, 2000),
             ("gather", -1.0, "uniform", 1024, 200)]
    failed = []
    for kind, mm, grid, B, P in cases:
        plains = {}
        for dtype in (torch.float64, torch.float32):
            t, a = prep(kind, mm, grid, B, P, dtype)
            gos = {v: launcher(v, a) for v, _, _ in variants}
            outs = {v: go().clone() for v, go in gos.items()}
            bitwise = {}
            for v, _, _ in variants[1:]:
                lay = gos[v].layout
                block = len(lay) == 3 and lay[2] == 1
                bitwise[v] = diff(outs[v],
                                  outs["full" if block else "earlier"])
            plains[dtype] = plain(kind, mm, t, a, P)
            name = (f"{kind} {'O' if mm > 0 else 'X'} {grid} B={B} P={P} "
                    f"{str(dtype)[6:]}")
            if dtype == torch.float64:
                tol = {"plain f64": within(outs["full"], plains[dtype],
                                           1e-6)}
                ok = tol["plain f64"][0] == 0 and tol["plain f64"][2] == 0
            else:
                tol = {"plain f32": within(outs["full"], plains[dtype],
                                           1e-3),
                       "plain f64": within(outs["full"],
                                           plains[torch.float64], 0.1),
                       "plain f32 vs plain f64": within(
                           plains[dtype], plains[torch.float64], 0.1)}
                ok = tol["plain f32"][0] == 0 and tol["plain f32"][2] == 0
            ok = ok and not any(bitwise.values())
            print(f"  {name}: elements differing {bitwise}; full vs "
                  + ", ".join(f"{n}: {m} NaN-mask differences, max "
                              f"{e:.3e} km, {c} over tol"
                              for n, (m, e, c) in tol.items())
                  + f"; layouts { {v: g.layout for v, g in gos.items()} }"
                  + ("" if ok else "  <-- FAILED"), flush=True)
            checks.append(dict(case=name, bitwise=bitwise, vs_plain=tol,
                               ok=ok))
            if not ok:
                failed.append(name)
    if failed:
        raise RuntimeError(f"checks failed: {failed}")

    timings = [("sweep X-20k uniform", "sweep", -1.0, "uniform", 32, 20000),
               ("sweep X-20k alt_nu", "sweep", -1.0, "alt_nu", 32, 20000),
               ("gather_osolve O-200", "gather_osolve", 1.0, "uniform", 1024,
                200),
               ("gather_xsolve X-200", "gather_xsolve", -1.0, "uniform", 1024,
                200),
               ("gather X-200", "gather", -1.0, "uniform", 1024, 200)]
    print(f"timing: median of 10 after 3 warm-ups, two turns; {card}",
          flush=True)
    res = {"card": card, "checks": checks}
    for label, kind, mm, grid, B, P in timings:
        for dtype in (torch.float32, torch.float64):
            _, a = prep(kind, mm, grid, B, P, dtype)
            names = [v for v, _, _ in variants]
            gos = {v: launcher(v, a) for v in names}
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                ms[v].append(profiling.time_launch(gos[v], iters=10)[0])
            key = f"{label} {str(dtype)[6:]}"
            res[key] = {}
            for v in names:
                med = statistics.median(ms[v])
                res[key][v] = dict(ms=ms[v], median_ms=med,
                                   layout=list(gos[v].layout))
                print(f"  {key} {v}: {ms[v][0]:.4f} / {ms[v][1]:.4f} ms, "
                      f"median {med:.4f}, layout {gos[v].layout}",
                      flush=True)
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
            print(f"  {key} (launch_shape: {chosen}): " + ", ".join(
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
                warp = pv.launch_shape(B, F, 1, n_sm, blocks(a))
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
                      f"ms (block/warp {med[1] / med[0]:.3f}); launch_shape "
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
