#!/usr/bin/env python3
"""Where the fan kernel's time goes, on one CUDA card, by variants timed in
turns.

    git show bf49157:pyrayhf_tpu_torch/csrc/fan2d.cu > build/fan2d_pr3.cu
    python3 tools/fan_attribution.py build/fan2d_pr3.cu

The argument is an earlier ``csrc/fan2d.cu`` with the channel-major
[F, 5, nz, nx] tables and 128-ray blocks (the form it had before the
node-major redesign). The script writes variants of it and of the current
kernel into ``build/fan_attribution/`` (git ignores ``build/``), builds
each with ``nvcc`` (the package's flags), and times them on the
``chip_smoke.py`` fan scenes, f32, F=64 x E=128 x 2,000 steps of 2 km:
median of 10 launches after 3 warm-ups (CUDA events), every variant of a
scene timed twice in turns (forward, then backward). Variants:

* earlier kernel: as it is (blocks of 128 rays), blocks of 64 and 32, the
  table loads replaced by a value computed from the cell index (results
  wrong: it separates the loads from arithmetic and control), and
  node-major records (five load rounds a step as before);
* current kernel (``cuda_ext``'s build), its shared-memory and global
  paths; with the loads replaced as above; with nvcc's IEEE division for
  each quotient (``div2`` undone); with that and the 4-corner sums behind
  the domain test's branch as well; with unpadded shared-memory rows.

Every variant but the two with replaced loads is checked bit for bit
against the earlier kernel (NaN-aware) on the typical and 621 x 800
scenes, f32 and f64, before anything is timed; a difference fails the
run. Prints one line per variant: median ms, the fan's maximum and mean
steps taken, and microseconds per step of the longest ray (median ms /
max steps); then the card, and writes the whole as JSON to
``build/fan_attribution/attribution.json``.
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
OUT_DIR = REPO / "build" / "fan_attribution"


def rep(s, a, b, n=1):
    """``s`` with ``a`` replaced by ``b``; ``a`` must occur ``n`` times."""
    if s.count(a) != n:
        raise ValueError(f"variant edit expected {n} of {a!r}, found "
                         f"{s.count(a)}")
    return s.replace(a, b)


# ---- variants of the earlier (channel-major, 128-ray) kernel -------------
def any_block(s):
    return rep(s, "block != 128 ||", "(block % 32) != 0 || block > 128 ||")


def fake_loads_earlier(s):
    return rep(s, """  const T v0 = __ldg(ch + c.idx);
  const T v1 = __ldg(ch + c.idx + 1);
  const T v2 = __ldg(ch + c.idx + nx);
  const T v3 = __ldg(ch + c.idx + nx + 1);""", """  const T v0 = T(0.5) + T(1e-7) * T(c.idx & 4095);
  const T v1 = T(0.5) + T(1e-7) * T((c.idx + 1) & 4095);
  const T v2 = T(0.5) + T(1e-7) * T((c.idx + nx) & 4095);
  const T v3 = T(0.5) + T(1e-7) * T((c.idx + nx + 1) & 4095);""")


_STATE = """
template <typename T>
struct State {"""
_NODE_MAJOR = """
__device__ __forceinline__ void node3(const float* __restrict__ rec, int i,
                                      float& mu, float& g0, float& g1) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(rec) + i);
  mu = v.x; g0 = v.y; g1 = v.z;
}
__device__ __forceinline__ void node3(const double* __restrict__ rec, int i,
                                      double& mu, double& g0, double& g1) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(rec) + 2 * i);
  mu = v.x; g0 = v.y; g1 = __ldg(rec + 4 * (size_t)i + 2);
}
template <typename T>
__device__ __forceinline__ T sum4v(const Cell<T>& c, const T v[4]) {
  return ((c.w0 * v[0] + c.w1 * v[1]) + c.w2 * v[2]) + c.w3 * v[3];
}
template <typename T>
__device__ __forceinline__ T fetch_s(const T* __restrict__ ch,
                                     const Cell<T>& c, int nx, int k) {
  const T v0 = __ldg(ch + 4 * (size_t)c.idx + k);
  const T v1 = __ldg(ch + 4 * (size_t)(c.idx + 1) + k);
  const T v2 = __ldg(ch + 4 * (size_t)(c.idx + nx) + k);
  const T v3 = __ldg(ch + 4 * (size_t)(c.idx + nx + 1) + k);
  return ((c.w0 * v0 + c.w1 * v1) + c.w2 * v2) + c.w3 * v3;
}
""" + _STATE


def node_major_earlier(s):
    s = rep(s, _STATE, _NODE_MAJOR)
    s = rep(s, """  const T n = c.inb ? fetch(tab, c, p.nx) : nan;
  const T g0 = c.inb ? fetch(tab + plane, c, p.nx) : T(0);
  const T g1 = c.inb ? fetch(tab + 2 * plane, c, p.nx) : T(0);""",
            """  (void)plane;
  T m[4], a[4], b[4];
  const int off[4] = {0, 1, p.nx, p.nx + 1};
  for (int k = 0; k < 4; ++k) node3(tab, c.idx + off[k], m[k], a[k], b[k]);
  const T n = c.inb ? sum4v(c, m) : nan;
  const T g0 = c.inb ? sum4v(c, a) : T(0);
  const T g1 = c.inb ? sum4v(c, b) : T(0);""")
    s = rep(s, """  const T* __restrict__ tab = p.tab + (size_t)f * kChannels * plane;
  const T* __restrict__ t_mu = tab;
  const T* __restrict__ t_mup = tab + 3 * plane;
  const T* __restrict__ t_kap = tab + 4 * plane;""",
            """  const T* __restrict__ tab = p.tab + (size_t)f * 4 * plane;
  const T* __restrict__ t_kap = p.tab + (size_t)p.F * 4 * plane +
                                (size_t)f * plane;""")
    for a, b in (("fetch(t_mu, c, p.nx)", "fetch_s(tab, c, p.nx, 0)"),
                 ("fetch(t_mup, c, p.nx)", "fetch_s(tab, c, p.nx, 3)"),
                 ("fetch(t_mup, cm, p.nx)", "fetch_s(tab, cm, p.nx, 3)"),
                 ("fetch(t_mu, cp, p.nx)", "fetch_s(tab, cp, p.nx, 0)")):
        s = rep(s, a, b)
    return s


# ---- variants of the current kernel ---------------------------------------
def fake_loads(s):
    return rep(s, """    if (SMEM) {
      const int i = f.c.sidx + (k & 1) + (k >> 1) * sx;
      f.mu[k] = sm[i];
      f.g0[k] = sm[splane + i];
      f.g1[k] = sm[2 * splane + i];
    } else {
      const int i = f.c.idx + (k & 1) + (k >> 1) * p.nx;
      node3(rec, i, f.mu[k], f.g0[k], f.g1[k]);
    }""", """    (void)splane;
    f.mu[k] = T(0.5) + T(1e-7) * T((f.c.idx + k) & 4095);
    f.g0[k] = f.mu[k];
    f.g1[k] = f.mu[k];""")


def ieee_div(s):
    return rep(s, """  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  r = __fmaf_rn(r, __fmaf_rn(r, -b, 1.0f), r);
  q1 = quot(a1, b, r);
  q2 = quot(a2, b, r);
  if (!(in_div_range(b) && (a1 == 0.0f || in_div_range(a1)) &&
        (a2 == 0.0f || in_div_range(a2)))) {
    q1 = a1 / b;
    q2 = a2 / b;
  }""", """  q1 = a1 / b;
  q2 = a2 / b;""")


def branchy(s):
    return rep(s, """  const T s_mu = sum4(c, f.mu), s_g0 = sum4(c, f.g0), s_g1 = sum4(c, f.g1);
  const T n = c.inb ? s_mu : T(NAN);
  const T g0 = c.inb ? s_g0 : T(0);
  const T g1 = c.inb ? s_g1 : T(0);""", """  const T n = c.inb ? sum4(c, f.mu) : T(NAN);
  const T g0 = c.inb ? sum4(c, f.g0) : T(0);
  const T g1 = c.inb ? sum4(c, f.g1) : T(0);""")


def unpadded(s):
    s = rep(s, "c.sidx = (int)i0 * (p.nx | 1) + (int)i1;",
            "c.sidx = (int)i0 * p.nx + (int)i1;")
    return rep(s, "const int sx = p.nx | 1;", "const int sx = p.nx;", 2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("earlier", help="an earlier csrc/fan2d.cu (channel-major "
                    "tables, 128-ray blocks)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pyrayhf_tpu_torch import cuda_ext, oblique, profiling
    from pyrayhf_tpu_torch import pallas_ray as pr
    from pyrayhf_tpu_torch.gradient import _launch_direction

    card = cs.card_line()
    earlier = Path(args.earlier).read_text()
    current = (cuda_ext.SRC_DIR / "fan2d.cu").read_text()
    old_src = {"earlier": any_block(earlier),
               "earlier_fake_loads": any_block(fake_loads_earlier(earlier)),
               "earlier_node_major": any_block(node_major_earlier(earlier))}
    new_src = {"fake_loads": fake_loads(current),
               "ieee_div": ieee_div(current),
               "ieee_div_branchy": branchy(ieee_div(current)),
               "unpadded": unpadded(current)}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(cuda_ext.find_nvcc())
    procs = {}
    for name, src in {**old_src, **new_src}.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_ext.NVCC_FLAGS, "-shared", "-o",
             str(OUT_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuda_ext.build()
    i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    libs = {"current": cuda_ext.load()}
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
        lib.pyrayhf_fan2d.argtypes = (
            [i, i] + ([] if name in old_src else [i])
            + [p, i, i, i, p, p, i, i, i, ctypes.POINTER(d), p, i, p])
        libs[name] = lib

    dev = torch.device("cuda", 0)
    f0s = np.linspace(4e6, 30e6, cs.FAN_F)
    n_steps = int(round(cs.FAN_SMAX / cs.FAN_STEP))
    scenes = {}

    def scene(case, dtype):
        if (case, dtype) not in scenes:
            kind, geom, mode, hops = cs.CHECK_CASES[case][:4]
            z, x, ne, babs, bpsi, nu = cs.fan_scene(kind)

            def T(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
            flds = oblique._fan_fields(T(f0s), T(ne), T(babs), T(bpsi), T(nu),
                                       mode)
            elevs = oblique._linspace(T(5.0), T(85.0), cs.FAN_E)
            geo = pr.fan_geometry(z, x, geom)
            tab = pr.pack_tables(geo, *flds)
            rec, kap = pr.table_views(geo, tab)
            chan = torch.stack([rec[..., 0], rec[..., 1], rec[..., 2],
                                rec[..., 3], kap], 1).contiguous()
            sph = geom == "spherical"
            z0 = float(geo.z[0])
            va0, vb0 = (v.contiguous() for v in _launch_direction(elevs, sph))
            sc = (ctypes.c_double * 16)(
                cs.FAN_STEP, geo.re + z0 if sph else 0.0, 0.0 if sph else z0,
                geo.o0, geo.inv_d0, geo.o1, geo.inv_d1, geo.c0_lo, geo.c0_hi,
                geo.c1_lo, geo.c1_hi, geo.ground, geo.top, geo.lo, geo.hi,
                geo.re)
            scenes[case, dtype] = (geo, tab, chan, va0, vb0, sc, sph, hops)
        return scenes[case, dtype]

    def launcher(variant, case, dtype=torch.float32, block=None, path=None):
        geo, tab, chan, va0, vb0, sc, sph, hops = scene(case, dtype)
        out = torch.empty((9, cs.FAN_F, cs.FAN_E), dtype=dtype, device=dev)
        dt = 0 if dtype == torch.float32 else 1
        stream = torch.cuda.current_stream(dev).cuda_stream
        common = [geo.nz, geo.nx, va0.data_ptr(), vb0.data_ptr(), cs.FAN_E,
                  n_steps, hops - 1, sc, out.data_ptr()]
        if variant in old_src:
            t = tab if variant == "earlier_node_major" else chan
            argv = ([dt, int(sph), t.data_ptr(), cs.FAN_F] + common
                    + [block or 128, stream])
        else:
            shared = (path or pr.fan_path(geo, dtype)) == "shared"
            argv = ([dt, int(sph), int(shared), tab.data_ptr(), cs.FAN_F]
                     + common + [pr._BLOCK, stream])

        def go():
            err = libs[variant].pyrayhf_fan2d(*argv)
            if err:
                raise RuntimeError(f"{variant} {case}: launch error {err}")
            return out
        return go

    print("bit-for-bit against the earlier kernel (elements differing):")
    for dtype in (torch.float32, torch.float64):
        for case in ("typical_cart", "typical_sph", "x_2hop", "large_cart"):
            ref = launcher("earlier", case, dtype)().clone()
            geo = scene(case, dtype)[0]
            runs = {"earlier_node_major": {},
                    "current_global": dict(path="global"),
                    "ieee_div_global": dict(path="global"),
                    "ieee_div_branchy_global": dict(path="global")}
            if pr.fan_path(geo, dtype) == "shared":
                runs.update(current_shared=dict(path="shared"),
                            ieee_div_shared=dict(path="shared"),
                            ieee_div_branchy_shared=dict(path="shared"),
                            unpadded_shared=dict(path="shared"))
            diffs = {}
            for key, kw in runs.items():
                var = key.rsplit("_", 1)[0] if key.startswith(
                    ("current", "ieee", "unpadded")) else key
                o = launcher(var, case, dtype, **kw)()
                diffs[key] = int((torch.nan_to_num(o, nan=-1e30)
                                  != torch.nan_to_num(ref, nan=-1e30)).sum())
            print(f"  {case} {str(dtype)[6:]}: {diffs}", flush=True)
            if any(diffs.values()):
                raise RuntimeError(f"{case}: a variant differs from the "
                                   "earlier kernel")

    def turns(case, cands):
        gos = {k: launcher(*spec[:2], **spec[2]) for k, spec in cands.items()}
        ms = {k: [] for k in cands}
        for k in list(cands) + list(cands)[::-1]:
            ms[k].append(profiling.time_launch(gos[k], iters=10)[0])
        rows = {}
        for k in cands:
            steps = gos[k]()[8].double()
            med = statistics.median(ms[k])
            mx = float(steps.max())
            rows[k] = dict(ms=ms[k], median_ms=med, max_steps=mx,
                           mean_steps=float(steps.mean()),
                           us_per_step=1e3 * med / mx)
            print(f"  {case} {k}: {ms[k][0]:.4f} / {ms[k][1]:.4f} ms; steps "
                  f"max {mx:.0f} mean {rows[k]['mean_steps']:.1f}; "
                  f"{rows[k]['us_per_step']:.4f} us/step of the longest ray",
                  flush=True)
        return rows

    print(f"timing, f32, median of 10 after 3 warm-ups, in turns; {card}")
    res = {"card": card}
    for case in ("typical_cart", "large_cart"):
        cands = {
            "earlier_b128": ("earlier", case, {}),
            "earlier_b64": ("earlier", case, dict(block=64)),
            "earlier_b32": ("earlier", case, dict(block=32)),
            "earlier_fake_loads": ("earlier_fake_loads", case, {}),
            "earlier_node_major": ("earlier_node_major", case, {}),
            "current_global": ("current", case, dict(path="global")),
            "current_fake_loads": ("fake_loads", case, dict(path="global")),
            "current_ieee_div": ("ieee_div", case, dict(path="global")),
            "current_ieee_div_branchy": ("ieee_div_branchy", case,
                                         dict(path="global")),
        }
        if case == "typical_cart":
            cands.update(
                current_shared=("current", case, dict(path="shared")),
                current_ieee_div_shared=("ieee_div", case,
                                         dict(path="shared")),
                current_ieee_div_branchy_shared=(
                    "ieee_div_branchy", case, dict(path="shared")),
                current_unpadded_shared=("unpadded", case,
                                         dict(path="shared")))
        res[case] = turns(case, cands)
    for case in ("typical_sph", "large_sph"):
        res[case] = turns(case, {"earlier_b128": ("earlier", case, {}),
                                 "current": ("current", case, {})})
    (OUT_DIR / "attribution.json").write_text(json.dumps(res, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
