#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's forward operator once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (``cuda:0``) and ``nvcc``; without a card it exits
non-zero before printing any result. Phases, each of which raises on
failure:

1. card identity (``nvidia-smi``) and the build of ``csrc/`` (nvcc, sm_90a);
2. the main path through the user entry points, f32, launch counters
   zeroed first and read after: ``vertical_forward_operator_batch(engine=
   "auto")`` O and X at B=1024 × F=175 × 200 points on a 620-node uniform
   grid and on the 73×144 = 10,512-profile global grid, ``auto`` on a
   non-uniform grid, the README's ``ionogram_pallas`` X-mode 20,000-point
   call at B=32 and ``ionogram_pallas_gather(x_in_kernel_solve=False)``;
   every kernel must have launched and no plain version may have run;
3. every output of that run against the plain version of the kernel that
   made it, on the same f32 inputs (identical NaN masks, ≤ 1e-3 km); the
   same entry points again in f64 at the same shapes against plain f64
   (identical NaN masks, ≤ 1e-6 km); the kernel path against the parity
   operator (f64, small input);
4. every kernel against its plain PyTorch version on the card, f64
   (identical NaN masks, ≤ 1e-6 km) and f32 (≤ 0.1 km of plain f64), at
   200 and 2,000 points, two-peak and sub-gyro rows included; X-mode
   20,000 points at B=32; every 16th profile of the global grid, where
   the values over 0.1 km must be exactly those where the plain f32
   version is over 0.1 km too; a non-uniform grid through the sweep;
5. a gradient through the autograd wrapper: finite, equal to the plain
   sweep's, and equal to a central finite difference of the kernel's
   forward (f64) along one density direction;
6. timing: median of 10 launches after warm-up (CUDA events), kernel and
   plain version at O-200 B=1024 and X-20k B=32;
7. one JSON line of kernels, the card line, and the closing JSON line.

Profiles are Chapman F2 (+ E above a valley for a quarter of them) from
``numpy.random.default_rng(SEED)``.
"""

import json
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda:0"
SEED = 20250901
B_MAIN, F_MAIN, P_MAIN, N_ALT = 1024, 175, 200, 620
GLOBAL_GRID = (73, 144)
B_X20K, P_X20K = 32, 20000
B_CHECK = 64
TIMING_ITERS = 10
# f32 kernel vs f32 plain: the same operations summed in another order
# (2.4e-4 km measured on the global grid, H100); f64 kernel vs plain f64
# and vs parity: the JAX package's own fast-vs-parity bound; f32 vs f64:
# the accuracy contract
TOL_F32_PLAIN, TOL_F64, TOL_F32 = 1e-3, 1e-6, 0.1
# central-difference step (relative, along den·u) and its tolerance: the
# resample index makes vh piecewise smooth, and at 1e-8 the kinks inside
# the step cost 1e-9..2e-8 relative on the plain versions (CPU, f64)
FD_STEP, FD_RTOL = 1e-8, 1e-6
REPO_KERNELS = {
    "gather_osolve": "pyrayhf_tpu/pallas_vh.py:701",
    "gather_xsolve": "pyrayhf_tpu/pallas_vh.py:839",
    "gather": "pyrayhf_tpu/pallas_vh.py:583",
    "sweep": "pyrayhf_tpu/pallas_vh.py:354",
}
SOURCE = "pyrayhf_tpu_torch/csrc/ionogram.cu"
CP, G_P = 8.97866275, 2.799249247e10


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def card_state():
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                        "temperature.gpu", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def profiles(rng, B, alt):
    """Chapman F2 (+ E above a valley for a quarter): den, |B|, ψ [B, N]."""
    nm = 10.0 ** rng.uniform(11.0, np.log10(3e12), B)
    hm = rng.uniform(220.0, 380.0, B)
    H = rng.uniform(40.0, 70.0, B)
    z = (alt[None, :] - hm[:, None]) / H[:, None]
    den = nm[:, None] * np.exp(0.5 * (1.0 - z - np.exp(-z)))
    e = rng.uniform(size=B) < 0.25
    nme = rng.uniform(0.6, 1.2, B) * 0.15 * nm
    ze = (alt[None, :] - rng.uniform(105.0, 120.0, B)[:, None]) / 8.0
    den = den + np.where(e, 1.0, 0.0)[:, None] * nme[:, None] * np.exp(
        0.5 * (1.0 - ze - np.exp(-ze)))
    b0 = rng.uniform(2.5e-5, 6.5e-5, B)
    bmag = b0[:, None] * ((6371.0 + alt[0]) / (6371.0 + alt[None, :])) ** 3
    bpsi = np.broadcast_to(rng.uniform(0.0, 90.0, B)[:, None], den.shape)
    return den, bmag, np.ascontiguousarray(bpsi)


def two_peak(alt):
    """The two-peak pair of tests/test_pallas.py on this grid."""
    f2 = 2.5e12 * np.exp(-(alt - 300.0) ** 2 / (2 * 55.0 ** 2))
    e_layer = 9e11 * np.exp(-(alt - 110.0) ** 2 / (2 * 10.0 ** 2))
    den = np.stack([f2, f2 + e_layer])
    return den, np.full_like(den, 3.2e-5), np.full_like(den, 65.0)


def degenerate_rows(freqs, den, bmag, mode_mult):
    """[B, F] rows whose first node already exceeds the cutoff (sub-gyro
    X rows): compared on their NaN pattern only, as the JAX tests do."""
    f = freqs[None, :] * 1e6
    s = den[:, :1] * CP * CP / f ** 2
    if mode_mult < 0:
        s = s + bmag[:, :1] * G_P / f
    return s >= 1.0


def over_tol(out, ref, tol):
    """[B, F] bool: finite in both and |out − ref| > tol."""
    out = out.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    m = np.isfinite(out) & np.isfinite(ref)
    return m & (np.abs(np.where(m, out - ref, 0.0)) > tol)


def compare(name, out, ref, tol, degenerate, masks_equal, excused=None):
    """Max |Δvh| on values finite in both (degenerate rows excluded).

    Fails when any compared value exceeds ``tol``, or, with ``excused``
    ([B, F] bool), unless the values over ``tol`` are exactly the excused
    ones.
    """
    out = out.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    check(out.shape == ref.shape, f"{name}: shape {out.shape} {ref.shape}")
    mis = int((np.isnan(out) != np.isnan(ref)).sum())
    if masks_equal:
        check(mis == 0, f"{name}: {mis} NaN-mask differences")
    else:
        check(mis <= 1e-3 * out.size, f"{name}: {mis} NaN-mask differences")
    m = np.isfinite(out) & np.isfinite(ref) & ~degenerate
    check(m.sum() > 0.1 * m.size, f"{name}: too few finite values")
    diff = np.abs(out[m] - ref[m])
    err = float(diff.max())
    over = diff > tol
    note = "" if excused is None else f", {int(excused[m].sum())} excused"
    print(f"  {name}: max|dvh| = {err:.3e} km (tol {tol:g}), "
          f"{int(m.sum())} values, {int(over.sum())} over tol{note}, "
          f"NaN-mask differences {mis}", flush=True)
    if excused is None:
        check(not over.any(),
              f"{name}: {int(over.sum())} values over {tol} km (max {err})")
    else:
        check(np.array_equal(over, excused[m]),
              f"{name}: the values over {tol} km are not exactly those "
              f"where the plain f32 version is over {tol} km too")
    return err


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's kernels need a CUDA card")
    import pyrayhf_tpu_torch as prt
    from pyrayhf_tpu_torch import cuda_ext, profiling
    from pyrayhf_tpu_torch import pallas_vh as pv

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---- 1. build ----------------------------------------------------
    t0 = time.perf_counter()
    so, compile_s = cuda_ext.build()
    cuda_ext.load()
    regs = [ln.strip() for ln in cuda_ext.build_log().splitlines()
            if "registers" in ln]
    print(f"build: {so.name}: nvcc {compile_s:.2f} s, build+load "
          f"{time.perf_counter() - t0:.2f} s; ptxas: "
          f"{'; '.join(sorted(set(regs)))}", flush=True)

    rng = np.random.default_rng(SEED)
    alt = np.linspace(80.0, 699.0, N_ALT)
    freqs = np.round(np.arange(1, F_MAIN + 1) * 0.1, 10)

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    den, bmag, bpsi = profiles(rng, B_MAIN, alt)
    n_glob = GLOBAL_GRID[0] * GLOBAL_GRID[1]
    gden, gbmag, gbpsi = profiles(rng, n_glob, alt)
    alt_nu = np.concatenate([np.linspace(80.0, 200.0, 241)[:-1],
                             np.linspace(200.0, 699.0, 380)])
    nden, nbmag, nbpsi = profiles(rng, 256, alt_nu)
    xden, xbmag, xbpsi = den[:B_X20K], bmag[:B_X20K], bpsi[:B_X20K]

    # ---- 2. main path, counted ----------------------------------------
    main_in = [T(a) for a in (freqs, den, bmag, bpsi, alt)]
    glob_in = [T(a) for a in (freqs, gden, gbmag, gbpsi, alt)]
    nu_in = [T(a) for a in (freqs, nden, nbmag, nbpsi, alt_nu)]
    x_in = [T(a) for a in (freqs, xden, xbmag, xbpsi, alt)]
    torch.cuda.synchronize()
    pv.reset_counters()
    t0 = time.perf_counter()
    vfo = prt.vertical_forward_operator_batch
    out = {
        "O": vfo(*main_in, mode="O", n_points=P_MAIN),
        "X": vfo(*main_in, mode="X", n_points=P_MAIN),
        "global_O": vfo(*glob_in, mode="O", n_points=P_MAIN),
        "global_X": vfo(*glob_in, mode="X", n_points=P_MAIN),
        "nonuniform_O": vfo(*nu_in, mode="O", n_points=P_MAIN),
        "readme_X20k": prt.ionogram_pallas(*x_in, mode_mult=-1.0,
                                           n_points=P_X20K),
        "host_solve_X": prt.ionogram_pallas_gather(
            *main_in, mode_mult=-1.0, n_points=P_MAIN,
            x_in_kernel_solve=False),
    }
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(pv.LAUNCHES)
    plain = dict(pv.PLAIN_CALLS)
    print(f"main path: {main_s:.3f} s wall; kernel launches {launches}; "
          f"plain-version calls {plain}", flush=True)
    check(all(launches[k] > 0 for k in pv.KERNELS),
          f"a kernel of the path never launched: {launches}")
    check(sum(plain.values()) == 0, f"plain versions ran: {plain}")
    # the kernel behind each output, its mode, inputs and points
    routes = {"O": ("gather_osolve", 1.0, (den, bmag, bpsi, alt), P_MAIN),
              "X": ("gather_xsolve", -1.0, (den, bmag, bpsi, alt), P_MAIN),
              "global_O": ("gather_osolve", 1.0, (gden, gbmag, gbpsi, alt),
                           P_MAIN),
              "global_X": ("gather_xsolve", -1.0, (gden, gbmag, gbpsi, alt),
                           P_MAIN),
              "nonuniform_O": ("sweep", 1.0, (nden, nbmag, nbpsi, alt_nu),
                               P_MAIN),
              "readme_X20k": ("sweep", -1.0, (xden, xbmag, xbpsi, alt),
                              P_X20K),
              "host_solve_X": ("gather", -1.0, (den, bmag, bpsi, alt),
                               P_MAIN)}
    for name, vh in out.items():
        _, mm, (pden, pbmag, _, grid), _ = routes[name]
        v = vh.cpu().numpy()
        fin = np.isfinite(v)
        ok = fin & ~degenerate_rows(freqs, pden, pbmag, mm)
        print(f"  {name}: shape {tuple(v.shape)} {vh.dtype}, finite "
              f"{fin.mean():.3f}, vh {v[ok].min():.2f}..{v[ok].max():.2f}"
              " km", flush=True)
        check(vh.dtype == torch.float32
              and v.shape == (pden.shape[0], F_MAIN), f"{name}: shape/dtype")
        check(fin.mean() > 0.15, f"{name}: too few finite values")
        check(np.all(v[ok] >= grid[0] - 1e-3), f"{name}: vh below the grid")

    def plain_version(kind, mm, t, P, chunk=2048):
        """Plain version of ``kind`` on tensors t, in chunks of profiles
        (each profile is independent) to bound the [b, F, N] solves."""
        fr, tden, tbmag, tbpsi, grid = t
        kinv = None if kind == "sweep" else pv.uniform_inv_dalt(grid)
        parts = []
        for b0 in range(0, tden.shape[0], chunk):
            c = [x[b0:b0 + chunk] for x in (tden, tbmag, tbpsi)]
            if kind == "sweep":
                parts.append(pv.ionogram_fast_xla(fr, *c, grid, mode_mult=mm,
                                                  n_points=P))
            else:
                parts.append(pv.plain_ionogram(pv.prepare_kernel_args(
                    kind, fr, *c, grid, mm, P, kinv)))
        return torch.cat(parts)

    no_rows = np.zeros((1, 1), dtype=bool)
    errs = {k: [] for k in pv.KERNELS}
    errs32 = {k: [] for k in pv.KERNELS}
    main_f32 = {k: [] for k in pv.KERNELS}

    # ---- 3. the main path's outputs against the plain versions --------
    print(f"main path vs plain versions: f32 outputs vs plain f32 (tol "
          f"{TOL_F32_PLAIN:g} km)", flush=True)
    for name, vh in out.items():
        kind, mm, prof, P = routes[name]
        ref = plain_version(kind, mm, [T(a) for a in (freqs, *prof)], P)
        main_f32[kind].append(compare(f"{name} ({kind}) f32 vs plain f32",
                                      vh, ref, TOL_F32_PLAIN, no_rows, True))
    print(f"main path vs plain versions: the same entry points in f64 vs "
          f"plain f64 (tol {TOL_F64:g} km)", flush=True)
    f64_in = {k: [T(a, torch.float64) for a in (freqs, *routes[k][2])]
              for k in ("O", "nonuniform_O", "readme_X20k")}
    pv.reset_counters()
    out64 = {
        "O": vfo(*f64_in["O"], mode="O", n_points=P_MAIN),
        "X": vfo(*f64_in["O"], mode="X", n_points=P_MAIN),
        "nonuniform_O": vfo(*f64_in["nonuniform_O"], mode="O",
                            n_points=P_MAIN),
        "readme_X20k": prt.ionogram_pallas(*f64_in["readme_X20k"],
                                           mode_mult=-1.0, n_points=P_X20K),
        "host_solve_X": prt.ionogram_pallas_gather(
            *f64_in["O"], mode_mult=-1.0, n_points=P_MAIN,
            x_in_kernel_solve=False),
    }
    check(all(pv.LAUNCHES[k] > 0 for k in pv.KERNELS)
          and sum(pv.PLAIN_CALLS.values()) == 0,
          f"f64 entry points: launches {pv.LAUNCHES}, plain "
          f"{pv.PLAIN_CALLS}")
    for name, vh in out64.items():
        kind, mm, prof, P = routes[name]
        check(vh.dtype == torch.float64, f"{name} f64: dtype {vh.dtype}")
        ref = plain_version(kind, mm, [T(a, torch.float64)
                                       for a in (freqs, *prof)], P)
        errs[kind].append(compare(f"{name} ({kind}) f64 vs plain f64", vh,
                                  ref, TOL_F64, no_rows, True))

    # above the largest gyrofrequency (1.8 MHz): the parity operator and
    # the kernels treat sub-gyro X rows differently (first-node cutoff)
    print("reference: kernel path vs parity operator (f64, f > 2 MHz)",
          flush=True)
    fr = freqs[freqs > 2.0]
    sm = [T(a, torch.float64) for a in (fr, den[:8], bmag[:8], bpsi[:8],
                                        alt)]
    for mode, mm in (("O", 1.0), ("X", -1.0)):
        compare(f"auto vs parity {mode}", vfo(*sm, mode=mode),
                vfo(*sm, mode=mode, engine="parity"), TOL_F64,
                degenerate_rows(fr, den[:8], bmag[:8], mm), True)

    # ---- 4. every kernel against its plain version --------------------
    print("kernels vs plain versions", flush=True)
    tp = two_peak(alt)
    cden = np.concatenate([den[:B_CHECK - 2], tp[0]])
    cbmag = np.concatenate([bmag[:B_CHECK - 2], tp[1]])
    cbpsi = np.concatenate([bpsi[:B_CHECK - 2], tp[2]])
    cases = [("gather_osolve", 1.0), ("gather_xsolve", -1.0),
             ("gather", 1.0), ("gather", -1.0), ("sweep", 1.0),
             ("sweep", -1.0)]

    def kernel_vs_plain(kind, mm, prof, grid, P, tag):
        fr, pden, pbmag, pbpsi = prof
        degen = degenerate_rows(fr, pden, pbmag, mm)
        kinv = None if kind == "sweep" else pv.uniform_inv_dalt(grid)

        def run(dtype, kernel):
            t = [T(a, dtype) for a in (fr, pden, pbmag, pbpsi, grid)]
            if not kernel:
                return plain_version(kind, mm, t, P)
            return pv.launch_kernel(pv.prepare_kernel_args(kind, *t, mm, P,
                                                           kinv))

        ref = run(torch.float64, False)
        name = f"{kind} {'O' if mm > 0 else 'X'} P={P} {tag}"
        if P <= 2000:
            errs[kind].append(compare(f"{name} f64", run(torch.float64, True),
                                      ref, TOL_F64, degen, True))
        k32 = run(torch.float32, True)
        errs32[kind].append(compare(f"{name} f32 vs plain f64", k32, ref,
                                    TOL_F32, degen, False))
        if P <= 2000:
            compare(f"{name} f32 vs plain f32", k32,
                    run(torch.float32, False), TOL_F32_PLAIN, degen, True)

    prof = (freqs, cden, cbmag, cbpsi)
    for kind, mm in cases:
        for P in (P_MAIN, 2000):
            kernel_vs_plain(kind, mm, prof, alt, P, f"B={B_CHECK}")
    for kind, mm in (("sweep", -1.0), ("gather_xsolve", -1.0)):
        kernel_vs_plain(kind, mm, (freqs, xden, xbmag, xbpsi), alt, P_X20K,
                        f"B={B_X20K}")
    kernel_vs_plain("sweep", 1.0, (freqs, nden[:B_CHECK], nbmag[:B_CHECK],
                                   nbpsi[:B_CHECK]), alt_nu, P_MAIN,
                    "non-uniform grid")
    # The global grid's random profiles reach the f32 limit of the JAX
    # algorithm itself: where the crossing lies just above a node, the
    # last grid points take the computed f32 1 - X on the segment below
    # (ROADMAP Queue 3; tests/test_torch_pallas_vh.py reproduces it in
    # both packages). So the kernel's values over 0.1 km of plain f64 must
    # be exactly those where the plain f32 version is over 0.1 km too.
    sub = slice(None, None, 16)
    global_err = {}
    for mode, mm, kind in (("O", 1.0, "gather_osolve"),
                           ("X", -1.0, "gather_xsolve")):
        degen = degenerate_rows(freqs, gden[sub], gbmag[sub], mm)
        p32, p64 = (plain_version(kind, mm, [T(a, dt) for a in (
            freqs, gden[sub], gbmag[sub], gbpsi[sub], alt)], P_MAIN)
            for dt in (torch.float32, torch.float64))
        global_err[kind] = compare(
            f"global grid {mode}, every 16th profile, main-path f32 vs "
            "plain f64", out[f"global_{mode}"][sub], p64, TOL_F32, degen,
            False, excused=over_tol(p32, p64, TOL_F32) & ~degen)

    # ---- 5. gradient through the autograd wrapper ----------------------
    print(f"gradient (f64): autograd vs the plain sweep's, and a central "
          f"difference of the kernel forward (step {FD_STEP:g}·den·u, "
          f"rtol {FD_RTOL:g})", flush=True)
    g_in = [T(a, torch.float64) for a in (freqs, den[:8], bmag[:8],
                                          bpsi[:8], alt)]
    # one density direction: den scaled by u ~ U(-1, 1), from the seed
    u_dir = T(den[:8] * rng.uniform(-1.0, 1.0, den[:8].shape),
              torch.float64)

    def loss_of(vh):
        return torch.where(torch.isfinite(vh), vh, 0.0).sum()

    for fn, mm in ((prt.ionogram_pallas_gather, 1.0),
                   (prt.ionogram_pallas, -1.0)):
        grads = []
        for f in (fn, pv.ionogram_fast_xla):
            d = g_in[1].clone().requires_grad_(True)
            vh = f(g_in[0], d, *g_in[2:], mode_mult=mm, n_points=P_MAIN)
            grads.append(torch.autograd.grad(loss_of(vh), d)[0])
        g, gp = grads
        rel = float(((g - gp).abs().max() / gp.abs().max()).item())
        n0 = sum(pv.LAUNCHES.values())
        with torch.no_grad():
            vp, vm = (fn(g_in[0], g_in[1] + s * FD_STEP * u_dir, *g_in[2:],
                         mode_mult=mm, n_points=P_MAIN) for s in (1.0, -1.0))
        check(sum(pv.LAUNCHES.values()) == n0 + 2,
              f"{fn.__name__}: the central difference did not launch")
        check(torch.equal(torch.isnan(vp), torch.isnan(vm)),
              f"{fn.__name__}: NaN mask moved within the step")
        fd = float((loss_of(vp) - loss_of(vm)) / (2.0 * FD_STEP))
        ad = float((g * u_dir).sum())
        fd_rel = abs(fd - ad) / abs(ad)
        print(f"  {fn.__name__}: |grad| max {gp.abs().max().item():.4e}, "
              f"max rel diff vs plain sweep {rel:.2e}; directional "
              f"derivative autograd {ad:.10e}, central difference "
              f"{fd:.10e}, rel diff {fd_rel:.2e}", flush=True)
        check(bool(torch.isfinite(g).all()) and gp.abs().max() > 0,
              f"{fn.__name__}: gradient not finite")
        check(torch.allclose(g, gp, rtol=1e-10, atol=0),
              f"{fn.__name__}: gradient differs from the plain sweep's")
        check(fd_rel <= FD_RTOL, f"{fn.__name__}: autograd directional "
              f"derivative {ad} vs central difference {fd}")

    # ---- 6. timing -------------------------------------------------------
    print(f"timing: median of {TIMING_ITERS} launches after 3 warm-up "
          f"launches, CUDA events, f32; card: {card}", flush=True)
    timing = {}

    def time_kind(kind, mm, inp, P, label):
        fr, td, tb, tpsi, ta = inp
        kinv = None if kind == "sweep" else pv.uniform_inv_dalt(ta)
        a = pv.prepare_kernel_args(kind, *inp, mm, P, kinv)
        B, F = td.shape[0], fr.shape[0]
        k_ms, _ = profiling.time_launch(pv.launch_kernel, a,
                                        iters=TIMING_ITERS)
        if kind == "sweep":
            def plain():
                return pv.ionogram_fast_xla(*inp, mode_mult=mm, n_points=P)
        else:
            def plain():
                return pv.plain_ionogram(a)
        p_ms, _ = profiling.time_launch(plain, iters=TIMING_ITERS)
        if kind == "sweep":
            def wrapper():
                return prt.ionogram_pallas(*inp, mode_mult=mm, n_points=P)
        else:
            def wrapper():
                return prt.ionogram_pallas_gather(
                    *inp, mode_mult=mm, n_points=P,
                    x_in_kernel_solve=(kind != "gather"))
        w_ms, _ = profiling.time_launch(wrapper, iters=TIMING_ITERS)
        row = {"shape": f"B={B} F={F} P={P} N={ta.shape[0]} f32 {label}",
               "kernel_ms": k_ms, "plain_ms": p_ms, "wrapper_ms": w_ms,
               "kernel_vh_per_s": profiling.vh_evals_per_s(B, F, k_ms),
               "plain_vh_per_s": profiling.vh_evals_per_s(B, F, p_ms),
               "wrapper_vh_per_s": profiling.vh_evals_per_s(B, F, w_ms)}
        print(f"  {kind} {row['shape']}: kernel {k_ms:.4f} ms "
              f"({row['kernel_vh_per_s']:.4e} vh/s), wrapper "
              f"{w_ms:.4f} ms ({row['wrapper_vh_per_s']:.4e} vh/s), plain "
              f"{p_ms:.4f} ms ({row['plain_vh_per_s']:.4e} vh/s)",
              flush=True)
        return row

    timing["gather_osolve"] = time_kind("gather_osolve", 1.0, main_in,
                                        P_MAIN, "O")
    timing["gather_xsolve"] = time_kind("gather_xsolve", -1.0, main_in,
                                        P_MAIN, "X")
    timing["gather"] = time_kind("gather", -1.0, main_in, P_MAIN, "X")
    timing["sweep"] = time_kind("sweep", -1.0, x_in, P_X20K, "X")
    time_kind("gather_xsolve", -1.0, x_in, P_X20K, "X")
    time_kind("sweep", 1.0, main_in, P_MAIN, "O")
    e2e_ms, _ = profiling.time_launch(
        lambda: vfo(*main_in, mode="O", n_points=P_MAIN), iters=TIMING_ITERS)
    print(f"  vertical_forward_operator_batch(auto) O B={B_MAIN} F={F_MAIN} "
          f"P={P_MAIN} f32: {e2e_ms:.4f} ms "
          f"({profiling.vh_evals_per_s(B_MAIN, F_MAIN, e2e_ms):.4e} vh/s)",
          flush=True)
    print(f"card state after timing (clocks.sm, power.draw, temp): "
          f"{card_state()}", flush=True)

    # ---- 7. result lines ---------------------------------------------
    kernels = []
    for k in pv.KERNELS:
        row = timing[k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPO_KERNELS[k], "launches": launches[k],
            "max_abs_err": max(errs[k]), "tol": TOL_F64,
            "main_path_f32_vs_plain_f32": max(main_f32[k]),
            "tol_f32_plain": TOL_F32_PLAIN,
            "max_abs_err_f32_vs_f64": max(errs32[k]), "tol_f32": TOL_F32,
            **({"global_grid_f32_vs_f64": global_err[k]}
               if k in global_err else {}),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "wrapper_ms": row["wrapper_ms"], "shape": row["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
