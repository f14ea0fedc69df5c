#!/usr/bin/env python3
"""Where the tensor-core one-hot ionogram kernel's time goes, on one CUDA
card, by variants timed in turns.

    git show 2763364:pyrayhf_tpu_torch/csrc/ionogram_mxu.cu > build/mxu_pr3.cu
    python3 tools/mxu_attribution.py build/mxu_pr3.cu

The argument is an earlier ``csrc/ionogram_mxu.cu`` whose one-hot
products run over the whole table: all 16 N-tiles and all K-steps for
every 32 grid points (the form it had before the banded design). The
script writes variants of it and of the current kernel into
``build/mxu_attribution/`` (git ignores ``build/``), builds each with
``nvcc`` (the package's flags), and times them on ``chip_smoke.py``'s
O-200 inputs (B=1024 Chapman profiles, F=175, P=200, N=620), O mode, f32
and f64: median of 10 launches after 3 warm-ups (CUDA events), every
variant timed twice in turns (forward, then backward). Variants:

* the earlier kernel as it is;
* the current kernel with its products over the K-steps of each tile's
  band only (every N-tile, invalid frequencies resampled);
* with the K-band and the N-tiles of the offsets the tile selects;
* the full current kernel (invalid frequencies skipped as well), with
  bands over tiles of 16 and of 32 points;
* the current kernel without its products and bands (results wrong: it
  separates them from the index, the tail and the table staging);
* the current kernel with one f32 table plane in shared memory, split into
  its three TF32 parts at each load (a third of the shared memory, so more
  blocks on an SM);
* kernel 3 (``csrc/ionogram.cu`` with the host solve), which computes the
  same function by a direct shared-memory load.

Every variant but the one without products is checked bit for bit
against kernel 3 (NaN-aware), O and X, f32 and f64, before anything is
timed; a difference fails the run.
Prints one line per variant (both turns, the median of the two, the
(N-tile, K-step) pairs it multiplies over and their tensor-core time at
the card's peak); then the card, and writes the whole as JSON to
``build/mxu_attribution/attribution.json``.
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
OUT_DIR = REPO / "build" / "mxu_attribution"


def rep(s, a, b, n=1):
    """``s`` with ``a`` replaced by ``b``; ``a`` must occur ``n`` times."""
    if s.count(a) != n:
        raise ValueError(f"variant edit expected {n} of {a!r}, found "
                         f"{s.count(a)}")
    return s.replace(a, b)


_TILE = "constexpr int kTile = "
_NMASK = "b.nmask = __reduce_or_sync(kFull, mine ? 1u << (i0 % kK2) : 0u);"
_SKIP = "    if (!valid) {  // the ray escapes"


def _line(s, start):
    """The line of ``s`` that begins with ``start``."""
    return start + s[s.index(start) + len(start):].split("\n", 1)[0]


def tile(s, n):
    """The current kernel with bands over tiles of ``n`` points."""
    return rep(s, _line(s, _TILE), f"{_TILE}{n};  // points per band")


def every_n_tile(s):
    """Products over every N-tile of the band's K-steps."""
    return rep(s, _NMASK, "b.nmask = 0xffffu;")


def no_skip(s):
    """Invalid frequencies resampled like the others (vh NaN all the same)."""
    return rep(s, _line(s, _SKIP), "    if (false) {")


def no_products(s):
    """The one-hot products and bands left out (results wrong)."""
    return rep(s, "      onehot_chunk(st, S, i0, scr, lane);\n", "")


def split_on_load(s):
    """f32: one shared plane, the three TF32 parts formed at each load."""
    s = rep(s, "constexpr int n_parts() { return sizeof(T) == 4 ? 3 : 1; }",
            "constexpr int n_parts() { return 1; }")
    s = rep(s, """  const float hi = tf32_trunc(v);
  const float r = v - hi;
  const float mid = tf32_trunc(r);
  s[idx] = hi;
  s[idx + plane] = mid;
  s[idx + 2 * plane] = r - mid;""", """  (void)plane;
  s[idx] = v;""")
    return rep(s, """#pragma unroll
        for (int part = 0; part < 3; ++part) {
          b[part][0] = __float_as_uint(st[part * plane + row + k0]);
          b[part][1] = __float_as_uint(st[part * plane + row + k0 + 4]);
        }""", """        (void)plane;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = st[row + k0 + 4 * h];
          const float hi = tf32_trunc(v);
          const float r = v - hi;
          const float mid = tf32_trunc(r);
          b[0][h] = __float_as_uint(hi);
          b[1][h] = __float_as_uint(mid);
          b[2][h] = __float_as_uint(r - mid);
        }""")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/ionogram_mxu.cu (products "
                    "over the whole table)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyrayhf_tpu_torch import cuda_ext, profiling
    from pyrayhf_tpu_torch import pallas_vh as pv

    card = cs.card_line()
    current = (cuda_ext.SRC_DIR / "ionogram_mxu.cu").read_text()
    tiles = {16: tile(current, 16), 32: tile(current, 32)}
    cur_tile = cs.MXU_TILE
    srcs = {"pr3": Path(args.earlier).read_text(),
            "kband": no_skip(every_n_tile(tiles[cur_tile])),
            "kband_nmask": no_skip(tiles[cur_tile]),
            "full_16": tiles[16], "full_32": tiles[32],
            "no_products": no_products(tiles[cur_tile]),
            "split_on_load": split_on_load(tiles[cur_tile])}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(cuda_ext.find_nvcc())
    procs = {}
    for name, src in srcs.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_ext.NVCC_FLAGS, "-I", str(cuda_ext.SRC_DIR),
             "-shared", "-o", str(OUT_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_ext.build()
    k3_lib = cuda_ext.load()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log[-4000:]}")
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in log.splitlines() if "registers" in ln})
        spill = max(int(ln.split(" bytes spill stores")[0].split()[-1])
                    for ln in log.splitlines() if "spill stores" in ln)
        print(f"built {name}: {', '.join(regs)}; at most {spill} bytes of "
              f"spill stores", flush=True)
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        lib.pyrayhf_ionogram_mxu.argtypes = \
            k3_lib.pyrayhf_ionogram_mxu.argtypes
        lib.pyrayhf_ionogram_mxu.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    alt = np.linspace(80.0, 699.0, cs.N_ALT)
    freqs = np.round(np.arange(1, cs.F_MAIN + 1) * 0.1, 10)
    prof = cs.profiles(rng, cs.B_MAIN, alt)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    prepared = {}

    def prep(mm, dtype):
        if (mm, dtype) not in prepared:
            t = [torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in (freqs, *prof, alt)]
            inv = pv.uniform_inv_dalt(t[-1])
            prepared[mm, dtype] = (
                pv.prepare_kernel_args("mxu", *t, mm, cs.P_MAIN, inv),
                pv.prepare_kernel_args("gather", *t, mm, cs.P_MAIN, inv))
        return prepared[mm, dtype]

    def launcher(variant, mm, dtype):
        a, a3 = prep(mm, dtype)
        B, F = a.span.shape
        out = torch.empty((B, F), dtype=dtype, device=dev)
        f_group, warps = pv.mxu_launch_shape(B, F, n_sm)
        stream = torch.cuda.current_stream(dev).cuda_stream
        dt, mode = int(dtype == torch.float64), 1 if mm > 0 else -1
        if variant == "kernel3":
            k3 = pv.kernel_layout(a3)
            fn, argv = k3_lib.pyrayhf_ionogram, [
                dt, mode, 0, 1, a3.tab.data_ptr(), a3.tab.shape[1], B,
                a.n_alt, a3.tab.shape[2], a.mult.data_ptr(),
                a.omm.data_ptr(), a.dmult.data_ptr(), a.mult.shape[0],
                a.freq_hz.data_ptr(), F, k3.n_groups, k3.warps,
                int(k3.per_block), a.span.data_ptr(), a.slope.data_ptr(),
                a.emax.data_ptr(), a.valid.data_ptr(), a.alt_min.data_ptr(),
                float(a.inv_dalt), out.data_ptr(), stream]
        else:
            fn, argv = libs[variant].pyrayhf_ionogram_mxu, [
                dt, mode, a.tab.data_ptr(), B, a.n_alt, a.tab.shape[2],
                a.mult.data_ptr(), a.omm.data_ptr(), a.dmult.data_ptr(),
                a.mult.shape[0], a.freq_hz.data_ptr(), F, f_group, warps,
                a.span.data_ptr(), a.slope.data_ptr(), a.emax.data_ptr(),
                a.valid.data_ptr(), a.alt_min.data_ptr(), float(a.inv_dalt),
                out.data_ptr(), stream]

        def go():
            err = fn(*argv)
            if err:
                raise RuntimeError(f"{variant}: launch error {err}")
            return out
        return go

    variants = ["pr3", "kband", "kband_nmask", "full_16", "full_32",
                "split_on_load", "no_products", "kernel3"]
    print("bit for bit against kernel 3 (elements differing, NaN-aware):")
    for dtype in (torch.float32, torch.float64):
        for mm in (1.0, -1.0):
            ref = launcher("kernel3", mm, dtype)().clone()
            nan = torch.isnan(ref)
            diffs = {}
            for v in variants[:-2]:
                o = launcher(v, mm, dtype)()
                diffs[v] = int((torch.isnan(o) != nan).sum()
                               + (o[~nan] != ref[~nan]).sum())
            print(f"  {'O' if mm > 0 else 'X'} {str(dtype)[6:]}: {diffs}",
                  flush=True)
            if any(diffs.values()):
                raise RuntimeError("a variant differs from kernel 3")

    print(f"timing, O-200 B={cs.B_MAIN}, median of 10 after 3 warm-ups, "
          f"two turns; {card}")
    res = {"card": card, "tile": cur_tile}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        a = prep(1.0, dtype)[0]
        gos = {v: launcher(v, 1.0, dtype) for v in variants}
        ms = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            ms[v].append(profiling.time_launch(gos[v], iters=10)[0])
        rows = {}
        for v in variants:
            med = statistics.median(ms[v])
            row = dict(ms=ms[v], median_ms=med)
            if v == "pr3":
                K1P = -(-a.tab.shape[2] // 8) * 8
                kst = 8 if dtype == torch.float32 else 4
                n = cs.B_MAIN * cs.F_MAIN * (-(-cs.P_MAIN // 32))
                row["pairs"] = n * 16 * (K1P // kst)
                row["tensor_flops"] = n * (16 * (K1P // 8) * 2 * 3 * 2048
                                           if dtype == torch.float32
                                           else 16 * (K1P // 4) * 4 * 512)
            elif v.startswith("full"):
                row["pairs"], row["tensor_flops"] = cs.mxu_products(
                    torch, a, int(v[-2:]))
            if "tensor_flops" in row:
                row["tensor_core_ms"] = (1e3 * row["tensor_flops"]
                                         / cs.PEAK_TENSOR[dname])
            rows[v] = row
            extra = (f"; {row['pairs']} (N-tile, K-step) pairs, "
                     f"{row['tensor_flops']:.4e} tensor-core flops, "
                     f"{row['tensor_core_ms']:.4f} ms at the peak"
                     if "pairs" in row else "")
            print(f"  {dname} {v}: {ms[v][0]:.4f} / {ms[v][1]:.4f} ms, "
                  f"median {med:.4f}{extra}", flush=True)
        res[dname] = rows
    (OUT_DIR / "attribution.json").write_text(json.dumps(res, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
