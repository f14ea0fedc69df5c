#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (``cuda:0``) and ``nvcc``; without a card it exits
non-zero before printing any result. Phases, each of which raises on
failure:

1. card identity (``nvidia-smi``) and the build of ``csrc/`` (nvcc, sm_90a),
   with each kernel's registers by name (``cuobjdump``);
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
   kernel 2 at frequencies on the node cutoffs of Chapman, E-above-valley,
   two-peak and constant-|B| profiles, times (1 +- n ulp), n <= 4, at 200
   and 2,000 points (f64 identical NaN masks, <= 1e-6 km; f32 identical
   NaN masks, <= 1e-3 km or 4 ulps of vh where that is more);
5. a gradient through the autograd wrapper: finite, equal to the plain
   sweep's, and equal to a central finite difference of the kernel's
   forward (f64) along one density direction;
6. timing: median of 10 launches after warm-up (CUDA events), kernel and
   plain version at O-200 B=1024 and X-20k B=32 (kernels 1-4 in f64 too,
   kernel 3 in O mode too, and the sweep at X-20k on the non-uniform
   grid), each beside its bound (the tail on the pairs the solve marks
   valid, whose share it prints), its issue bound (the SASS instructions
   of its loops, ``tools.cuda_sass.sass_loops``, over the schedulers' rate
   at the SM clock read under load) and the launch layout ``launch_shape``
   chose;
7. the 2-D oblique ionogram (``csrc/fan2d.cu``): the main path, counters
   zeroed first and read after — ``synthesize_oblique_ionogram_2d`` and
   ``_fan_2d_fn`` with ``engine="auto"`` on f32 CUDA tensors, F=64 × E=128
   × 2,000 steps, on the typical 512×32 slice (Cartesian and spherical),
   the 621×800 field, X mode through a ground bounce, and a grid from
   80 km through the free-space ladder with a lossy ground; the kernel
   must have launched and no plain version may have run. Then the kernel,
   launched through its wrapper ``fan_2d_pallas``, against its plain
   version on the same fields, on the card: f64 (identical status codes
   and landing masks, rtol 1e-8, atol 1e-10) on both geometries, 2-hop X
   and the 621×800 field, and f32 on those and 621×800 spherical, which
   runs both of the kernel's paths (512×32 f32 tables in shared memory,
   the others from global memory); the f32 kernel's landing mask against
   plain f64; the main path's fans equal to those f32 launches; timing of
   the kernel, the whole fan call and the plain version, each kernel time
   beside a bound that counts the table bytes the rays of this run need,
   with the fan's maximum and mean steps taken and the time per step of
   the longest ray; the kernel against its plain version on a 2-node x
   axis (f64, f32; and ``synthesize_oblique_ionogram_2d`` there on the
   kernel against its ``xla`` engine) and on 65,537 frequencies (f64);
8. the tensor-core one-hot kernel (``csrc/ionogram_mxu.cu``): its main
   path, counters zeroed first and read after — ``vertical_forward_
   operator_batch(engine="pallas_mxu")`` O and X, f32, at O-200 B=1024
   (2 launches, no plain call); its outputs against the plain version in
   f32 (≤ 1e-3 km) and, through the same entry point in f64, in f64
   (≤ 1e-6 km), f32 against plain f64 (≤ 0.1 km, phase 4's rule), and the
   f64 kernel against kernel 3 (``gather``, a warp per pair) on the same
   prepared inputs (≤ 1e-9 km, identical masks), and the kernel equal to
   kernel 3 bit for bit in f32 and f64; the same at P=2,000 on the B=64
   check set;
   autograd through ``ionogram_pallas_mxu`` against the plain sweep's and
   a central difference; timing of the kernel, its wrapper, its plain
   version and kernel 3 beside the bound (the function's own work on the
   valid (profile, frequency) pairs), and the tensor-core time of the
   one-hot products it issues on these inputs (counted on the host from
   the kernel's indices) beside that of its first design;
9. the inversions on the card: ``retrieve_gradient_batch`` on a
   station-day of B=288 O-mode ionograms (hmF2 260-400 km, B_bot 25-60
   km; 25 LM steps, f64 and f32, per-sample |B| and ψ),
   ``minimize_parameters(method="brute")`` on one of them and
   ``retrieve_profile_batch`` on B=64 Chapman ionograms, each against its
   truths at the JAX package's test thresholds; then, with the card idle,
   the same f64 LM call on the first 2 ionograms on the CPU, whose fits
   must equal the card's;
10. the 1-D oblique link (``link_phase``): Snell fans
    (``trace_rays_{spherical,cartesian}_snells``) and
    ``synthesize_oblique_ionogram`` at example 06's width (1,000 km,
    F=42 from 5 to 25.5 MHz, E=512, 620 nodes; O and X, f64 and f32),
    timed, with the fan's peak memory and the link MUF, and on six of the
    frequencies against the same port code on the CPU (f64: every output,
    identical NaN masks, rtol 1e-10; f32: identical landing masks off
    the penetration edge); the
    MUF map of the 10,512-profile global grid (``muf_map``, ranges 500 to
    3,000 km, O and X, f32, ``engine="auto"``), counters zeroed first and
    read after: kernels 1 and 2 must have launched and no plain version
    run, and every MUF lies within one frequency step of the plain f64
    map with identical NaN rows (the f64 map through the same kernels
    within 2.5e-8 of it); the adaptive single-ray tracers (DP45,
    rtol 1e-7, atol 1e-9) on the Gaussian field of the ``gauss_*``
    goldens, card against CPU (1e-9 on the landing point and group path,
    the same status and accepted attempts); Faraday rotation and Doppler
    at example 13's width, card against CPU (rtol 1e-10); and
    ``retrieve_from_oblique`` at example 12's width (261 nodes, 12
    frequencies, n_elev 256, 14 steps) on delays synthesised on the card,
    which must recover its truth to the JAX package's test thresholds;
11. the 3-D slice (``trace3d_phase``; plain PyTorch, no kernel) at
    example 10's width: ``generate_input_3D`` of a 620 × 36 × 41 =
    915,120-node volume (card against CPU); ``synthesize_oblique_
    ionogram_3d`` of example 10's link, 24 frequencies (3.0–14.5 MHz) ×
    ``home_ray_3d``'s 48 × 9 fan at 2-km steps over 4,000 km, f64 and f32;
    ``trace_rays_3d`` (48 × 9 at 8 MHz, f64 and f32) and ``trace_ray_3d``
    fixed-step and adaptive; ``igrf_volume``, ``build_field_3d_aniso``,
    ``trace_rays_3d_anisotropic`` O and X, ``synthesize_oblique_ionogram_
    3d_anisotropic`` (12 frequencies, 3–14 MHz) and the gradient of a
    ray's group delay w.r.t. the Ne table; each call's time, steps run and
    peak memory, the link MUFs; every f64 result on a subset against the
    CPU (rtol 1e-9, identical NaN masks; the gradient 1e-6);
12. mesh sharding (``mesh_phase``): ``ionogram_mesh()`` on the card, a
    4 x 2 mesh of ``cuda:0`` and a mesh of 2; ``synthesize_ionograms_
    sharded(engine="pallas")`` O and X on the global grid at F=176 and
    P=200, X-20k at F=176 (B=32) and X at 5,000 points and B=1024 (where
    the whole call and a shard take different launch layouts), f32,
    counters zeroed first and read after
    (the sweep kernel 8 times a call, no plain version), each against the
    unsharded ``ionogram_pallas`` on the same tensors (identical NaN
    masks; bit for bit where the two launch layouts match, else <= 1e-3
    km) and timed beside it; the same in f64 against plain f64 (<= 1e-6
    km); the xla engine against the kernel at O-200 B=1024 (<= 1e-3 km
    f32); ``vh_height_sharded`` at 20,000 points, the retrieval step on
    the station-day (B=288) and ``doppler_batch_sharded`` on the global
    grid, f64, against their unsharded forms (rtol 1e-10); and on 2 shards
    the LM on 24 ionograms (8 steps, rtol 1e-9) and the fixed-psi (rtol
    1e-12) and anisotropic (1e-9) fans of the 3-D phase's volume;
13. differentiation through the kernel entry points (``ad_phase``),
    counters zeroed before each part and read after it:
    ``torch.func.jvp`` of ``vertical_forward_operator_batch(engine=
    "auto")`` at O-200 B=1024, O and X, f32 and f64 (kernels 1 and 2, no
    plain call), the primal equal to the call without AD bit for bit and
    the tangent to ``torch.func.jvp`` of the plain sweep (first 64
    profiles; rtol 1e-12 f64, 1e-5 f32); ``jacfwd`` and ``jacrev`` in
    (density scale, |B| scale, psi offset), f64, through kernels 1-5 (8
    profiles; kernel 4 at X-20k on 2 profiles and 16 frequencies), each
    against the plain sweep's and against each other where both are
    finite (rtol 1e-10); ``torch.func.vmap`` of ``ionogram_pallas_gather``
    over the global grid cut 4 x 2,628 (one launch, bit for bit the whole
    call); the parity engine on the global grid with every 8th profile's
    |B| = 0 (rows equal to their profile alone; f64 equal to ``auto``
    above 2 MHz, <= 1e-6 km, identical NaN masks); ``fan_2d_pallas``
    under forward mode, which must raise; the jvp and jacfwd calls timed
    beside the forward call alone;
14. one JSON line of kernels, the card line, and the closing JSON line.

Profiles are Chapman F2 (+ E above a valley for a quarter of them) from
``numpy.random.default_rng(SEED)``; the fan scenes are the tilted Chapman
slice of ``tools/bench_fan_pallas.py``.
"""

import json
import pathlib
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
# kernel 2 at cutoffs: frequencies at fx_j and cfx_j times (1 +- n ulp),
# n <= RAZOR_ULPS, at RAZOR_NODES nodes of each razor profile
RAZOR_NODES, RAZOR_ULPS = 12, 4
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
TABLE_SOURCE = "pyrayhf_tpu_torch/csrc/segment_table.cu"
CP, G_P = 8.97866275, 2.799249247e10

# the card's published peaks (NVIDIA data sheet, H100 SXM, 700 W):
# float32 and float64 outside the tensor cores, the tensor cores (dense
# TF32, and FP64), and device memory
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_TENSOR = {"float32": 495e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
# operations per grid point of a valid (profile, frequency) pair in the
# ionogram kernels, counted from csrc/ionogram.cu (each add, multiply,
# division, sqrt, sin, cos, floor and comparison as one): the resample and
# mup_stable ~115, plus the sweep's 2 comparisons that keep a point in its
# last segment (its index on any grid); an escaped pair's vh is NaN, with
# no work. The in-kernel solve adds ~1 (O) or ~10 (X) per altitude node
# and frequency, for every pair.
ION_OPS_POINT = {"gather_osolve": 115, "gather_xsolve": 115,
                 "gather": 115, "sweep": 117}
ION_OPS_NODE = {"gather_osolve": 1, "gather_xsolve": 10, "gather": 0,
                "sweep": 0}

# ---- the tensor-core one-hot kernel (csrc/ionogram_mxu.cu) ----------------
MXU_SOURCE = "pyrayhf_tpu_torch/csrc/ionogram_mxu.cu"
MXU_REPLACES = "pyrayhf_tpu/pallas_vh.py:456"
# the f64 kernel against kernel 3 on the same prepared inputs: the JAX
# package's own MXU-vs-sweep bound (tests/test_pallas.py:247); the kernel
# must moreover equal kernel 3 bit for bit, f32 and f64
TOL_MXU_K3 = 1e-9
# grid points per band of the kernel's products (csrc kTile)
MXU_TILE = 16

# ---- the inversions on the card ---------------------------------------------
# one station-day at 5-minute cadence: the golden layer parameters of
# tests/test_edp_retrieval.py:19-36 with hmF2 U(260, 400) km, B_bot
# U(25, 60) km and NmF2 within ±20% of the golden
# (the CPU side of the card-vs-CPU LM comparison on 2 of them: 4 took
# ~110 s of the script, with the card idle)
LM_B, LM_STEPS, LM_CPU_B = 288, 25, 2
TH_B = 64
LM_POP = {"hm": (260.0, 400.0), "B_bot": (25.0, 60.0)}
GOLDEN = {"F2": {"Nm": 1.17848165e+12, "hm": 365.13828931,
                 "B_top": 32.52487907, "B_bot": 41.26005561},
          "F1": {"Nm": 7.80902301e+11, "P": 0.91422852,
                 "hm": 219.26637887},
          "E": {"Nm": 1.2846662e+11, "hm": 110.0, "B_bot": 5.0,
                "B_top": 7.0}}
# the inversions' scene drops the golden F1 ledge (P = 0, the night-time
# shape of the continuous builder): with it (P = 0.914) the LM of either
# package stalls in local minima for some truths of this population
# (tests/test_torch_lm_f1_ledge.py runs both packages on such truths)
LM_F1 = dict(GOLDEN["F1"], P=0.0)
# recovery thresholds of the JAX package's own tests:
# tests/test_edp_retrieval.py:444-447 (f64 LM: hmF2 2%, B_bot 5%, vh
# 5 km), :374-377 (f32 LM: 1%, 2%, 5 km), :176-180 (brute: 4 km, 2.5 km),
# tests/test_true_height.py:45-62 (rms 0.2 km, top knot 1 km, all 25 km)
LM_TOL = {"float64": (0.02, 0.05, 5.0), "float32": (0.01, 0.02, 5.0)}
# a fit whose final cost stays above the retry cost (km², retrieve_
# gradient_batch's default) is one the LM flags as not converged: on this
# population the JAX package's LM stalls on some truths too
# (tests/test_torch_lm_f1_ledge.py). The thresholds hold every converged
# fit, and at most this share of the day may stall.
RETRY_COST, LM_STALL_SHARE = 10.0, 0.05
BRUTE_TOL = (4.0, 2.5)
BRUTE_SIGMA = 20.0         # percent: the reference's default grid
# the card's f64 LM fits against the CPU's: every sample takes the same
# accept decisions, and the sweep, the Jacobian and the normal equations
# sum in another order (tests/test_torch_edp_retrieval.py holds the port
# to the JAX package at the same rtol)
LM_CPU_RTOL = 1e-8

# ---- the 2-D oblique fan (csrc/fan2d.cu) ----------------------------------
# the fan of tools/bench_fan_pallas.py: F = 64 frequencies 4-30 MHz, E = 128
# elevations 5-85 deg, 2,000 RK4 steps of 2 km
FAN_F, FAN_E, FAN_STEP, FAN_SMAX = 64, 128, 2.0, 4000.0
FAN_SOURCE = "pyrayhf_tpu_torch/csrc/fan2d.cu"
FAN_TABLES_SOURCE = "pyrayhf_tpu_torch/csrc/fan_tables.cu"
# operations per (frequency, node) of csrc/fan_tables.cu, each add,
# multiply, division, root and comparison as one (its source note's
# count): X and Y 2, the Appleton-Hartree mu ~26, mu' ~35, kappa ~12, the
# two gradients ~12, mu again on the tile's halo ~9 (80 halo nodes a
# 256-node tile, mu alone)
FAN_TABLE_OPS = 96
FAN_REPLACES = "pyrayhf_tpu/pallas_ray.py:130"
# f64 kernel vs f64 plain: the JAX package's own bound for the kernel
# against the scan fan (tests/test_pallas_ray.py:58)
FAN_RTOL, FAN_ATOL = 1e-8, 1e-10
# f32 kernel vs f32 plain: the trajectories take the same operations in the
# same order (identical status codes, landing masks, step counts and
# ranges, measured on the H100), and only the four path sums add in
# another order (sequential in the kernel, torch.nansum in the plain
# version); 2,000 f32 terms give ~1e-5 relative at worst
FAN_F32_RTOL = 1e-4
# operations per ray step, counted from csrc/fan2d.cu as above: 4 RHS
# evaluations (a locate ~24, 3 channel fetches of 7, the RHS ~11 / ~17),
# the RK4 combination ~54, renormalisation 6, events and tests ~22, and
# the midpoint quadrature (one locate + 3 fetches, or two locates in
# spherical geometry) ~69 / ~100
FAN_OPS_STEP = {"cartesian": 375, "spherical": 430}
# (grid, geometry, mode, n_hops, ground range km, ground): the typical
# 512 x 32 slice of tools/bench_fan_pallas.py:78 with its 15 % tilt; the
# 621 x 800 node count of the reference gradient tutorials (BASELINE.md:12),
# 1 km x 5 km; X mode through one ground bounce; a grid from 80 km whose
# spacing divides 80, so that the free-space ladder to the ground runs,
# with a lossy ground under its one bounce
FAN_CASES = {
    "typical_cart": ("typical", "cartesian", "O", 1, 1500.0, None),
    "typical_sph": ("typical", "spherical", "O", 1, 1500.0, None),
    "large_cart": ("large", "cartesian", "O", 1, 1500.0, None),
    "x_2hop": ("typical", "cartesian", "X", 2, 3000.0, None),
    "ladder_2hop": ("ladder", "cartesian", "O", 2, 1500.0, "medium"),
}
# the kernel against its plain version: f64 on both geometries, the field
# the TPU refused, X mode through a bounce; f32 on those and the 621 x 800
# field in spherical geometry too (timed below)
CHECK_CASES = {**FAN_CASES,
               "large_sph": ("large", "spherical", "O", 1, 1500.0, None)}
F64_CASES = ("typical_cart", "typical_sph", "x_2hop", "large_cart")
F32_CASES = F64_CASES + ("large_sph",)
# a range-independent slice written with a 2-node x axis (x = -100, 3000
# km): a Gaussian F layer, 1e12 m^-3 at 300 km, on 121 heights 80-680 km,
# at 5 and 7 MHz, 16 elevations, a 1,000-km link
TWO_NODE_F, TWO_NODE_E, TWO_NODE_RANGE = (5.0e6, 7.0e6), 16, 1000.0
# more frequencies than a launch grid's y extent holds: 65,537 of them on
# a 16 x 8 grid, 2 elevations, 64 steps of 10 km
WIDE_F, WIDE_E, WIDE_STEPS, WIDE_STEP = 65537, 2, 64, 10.0

# ---- the 1-D oblique link (link_phase) ------------------------------------
# example 06's link: 1,000 km, 5.0-25.5 MHz in 0.5 MHz steps, 512 elevations
# 5-85 deg, on the golden layers (LM_F1: no F1 ledge) over 80-699 km at 1 km
LINK_D, LINK_F0S, LINK_NELEV = 1000.0, np.arange(5e6, 26e6, 0.5e6), 512
# six of the 42 frequencies, spread over the band: the card's fans and
# link ionograms against the same port code on the CPU
LINK_SUB = [0, 8, 16, 24, 32, 41]
# f64 card vs CPU: the same operations, summed in another order (nansum,
# cumsum) and with the card's libm; the JAX package's fan-vs-single bound
# is 1e-12 (tests/test_tracers.py:123)
LINK_RTOL = 1e-10
# f32 card vs CPU: the libm of each rounds μ differently by an ulp or two,
# which moves a ray that grazes the layer's peak across the penetration
# edge; a ray whose CPU landing changes when its elevation moves by this
# much (1e-3 deg: ≥ 13 f32 ulps of the Snell invariant from 5 deg up) is
# on the edge, and only such rays may land on one side only
LINK_EDGE_DEG = 1e-3
MUF_RANGES = [500.0, 1000.0, 2000.0, 3000.0]
MUF_F64_RTOL = 2.0 * TOL_F64 / 80.0
# the adaptive single rays: the Gaussian field of the gauss_* goldens
# (tests/goldens/reference_goldens.npz; its recipe: a 1e12 m^-3 layer at
# 250 km, 60 km wide, 4e-5 T, 45 deg, at 10 MHz, 0-600 km x 0-1000 km on
# 200 x 200 nodes), the scipy defaults rtol 1e-7, atol 1e-9, and the
# steps of tests/test_tracers.py:284,318; card vs CPU to 1e-9
GRAD_RTOL = 1e-9
# example 13's Doppler sweep and example 12's inversion
DOP_FREQS = np.arange(2.0, 13.0, 1.0)
FARADAY_FREQS = np.array([15e6, 20e6, 30e6, 50e6, 100e6])
INV_F0S, INV_NELEV, INV_STEPS = np.linspace(5e6, 14e6, 12), 256, 14
INV_TRUTH = {"Nm": 9e11, "hm": 310.0, "B_bot": 48.0, "B_top": 60.0}
INV_PRIOR = {"Nm": 6e11, "hm": 270.0, "B_bot": 38.0, "B_top": 60.0}

# ---- the 3-D slice (trace3d_phase) ------------------------------------------
# example 10's region (examples/10_trace3d.py) on the main path's 620-node
# altitude axis: 620 x 36 x 41 = 915,120 nodes, from generate_input_3D
T3D_DATE, T3D_F107 = (2020, 6, 15, 17.0), 140.0
T3D_LAT, T3D_LON = np.linspace(10.0, 45.0, 36), np.linspace(-90.0, -50.0, 41)
T3D_ALT = np.linspace(80.0, 699.0, 620)
# example 10's link (38 N 72 W -> 33 N 72 W) and home_ray_3d's default fan
T3D_LINK = (38.0, -72.0, 33.0, -72.0)
T3D_FAN = dict(n_elev=48, n_az=9, step_km=2.0, s_max_km=4000.0)
T3D_F0S = np.arange(3.0e6, 14.75e6, 0.5e6)          # 24 frequencies
T3D_SUB = [4, 10, 16]                              # the CPU subset
T3D_FAN_F0 = 8.0e6
ANISO_F0S = np.linspace(3.0e6, 14.0e6, 12)
# the card's f64 against the CPU: the CPU tests' rtol (tests/test_torch_
# trace3d.py, the JAX package's fan-versus-single bound); the anisotropic
# fans (and the anisotropic ionogram) at 4-km steps, the CPU side at 2 km
# would take minutes; the adaptive ray on a 200-km arc (further on, a
# 1-ulp difference of the card's libm moves its step controller, as the
# JAX function parts from itself between jit and eager); the field-table
# gradient of one ray at 4-km steps, as tests/test_trace3d_aniso.py
T3D_RTOL = 1e-9
T3D_GRAD_RTOL = 1e-6
T3D_ADAPTIVE_ARC = 200.0

# ---- mesh sharding (mesh_phase) ---------------------------------------------
# the sweep kernel through synthesize_ionograms_sharded(engine="pallas") on a
# 4 x 2 mesh of the one card: the global grid at F = 176 (0.1-17.6 MHz, even
# for the 'freq' axis) and P = 200, and X-20k (B = 32, P = 20,000); O-200
# B = 1024 for the xla engine against the kernel
MESH_FREQS = np.round(np.arange(1, 177) * 0.1, 10)
MESH_SHAPE = (4, 2)
# points at which B=1024 x F=176 takes a warp per pair and its [256, 88]
# blocks a block per pair, for 3 to 8 blocks an SM (launch_shape; at
# 20,000 points both take a block per pair on an H100 80GB HBM3)
MESH_P_SPLIT = 5000
# the height-split quadrature's points; the retrieval step's learning rate
# (1: the step is the gradient itself, so rtol 1e-10 holds the gradient);
# the Doppler velocity (km/s) and the stride of the per-profile check; the
# host-bound LM on the first ionograms of the station-day at 8 steps; the
# fixed-psi fan at 4-km steps over 1,500 km (the 3-D phase's fan runs
# 2,000 steps of 2 km, and each shard pays its host time)
MESH_VH_P, MESH_LR, MESH_DOP_V, MESH_DOP_EVERY = 20000, 1.0, 0.02, 512
MESH_LM_B, MESH_LM_STEPS = 12, 8
MESH_FAN = dict(step_km=4.0, s_max_km=1500.0)
# the fixed-psi fan against its unsharded self, each shard integrating its
# rays as the whole fan does; the retrieval step and height quadrature
# against their unsharded forms (partial sums in another order)
MESH_FAN_RTOL, MESH_SUM_RTOL, MESH_LM_RTOL = 1e-12, 1e-10, 1e-9

# ---- differentiation through the kernel entry points (ad_phase) ------------
# torch.func.jvp of the auto operator at O-200 B=1024 (the main path's
# width), its tangent held to torch.func.jvp of the plain sweep on the first
# AD_REF_B profiles (each profile is independent); jacfwd against jacrev in
# (density scale, |B| scale, psi offset) on AD_JAC_B profiles, and kernel 4
# at X-20k on AD_X20K_B profiles at every AD_X20K_F_EVERY-th frequency:
# reverse mode through the sweep keeps each of its N-1 segment steps, about
# 3 x B x F x P values a step (8 GB at the X-20k cut in f64)
AD_SEED = SEED + 1
AD_REF_B, AD_JAC_B, AD_X20K_B, AD_X20K_F_EVERY = 64, 8, 2, 11
# tangent tolerances (the rule's sweep against the plain sweep: the same
# operations), derivatives between modes and against the sweep (the CPU
# tests' bound), the parity engine against auto (phase 3's)
AD_RTOL = {"float64": 1e-12, "float32": 1e-5}
AD_JAC_RTOL = 1e-10
# the global grid with every AD_B0_EVERY-th profile without a field, run
# through the parity engine in chunks of AD_PARITY_CHUNK profiles (each
# profile is decided on its own); the rows checked against their profile
# run alone
AD_B0_EVERY, AD_PARITY_CHUNK = 8, 1024
AD_ALONE_ROWS = (0, 1, 7, 8, 9, 5000, 10504, 10511)
# (profile, MHz) of the global grid where the kernels and the parity
# operator part by more than TOL_F64 in f64 (1.1e-6 to 2.1e-6 km): the JAX
# package's own kernels and parity operator part there by the same amounts
# (tests/test_torch_pallas_vh.py); allowed up to AD_PARITY_EXCUSED_TOL. The
# JAX package's X pairs (7318, 2.8) and (7342, 2.2) are first-exceedance
# pairs, on which the port's kernels give the parity operator's alt_min
AD_PARITY_EXCUSED = {"O": ((1274, 12.5), (2919, 8.6), (9339, 10.7)),
                     "X": ()}
AD_PARITY_EXCUSED_TOL = 3e-6
# jacfwd of jacfwd in (density scale, |B| scale): kernels 1-3 and 5 on
# AD_HESS_B profiles at AD_HESS_F frequencies spread over the band, kernel 4
# at X-20k on 1 profile at 4 of them; against the plain sweep's jacfwd of
# jacfwd (the same operations: the CPU tests hold both to JAX's). The
# profiles on every AD_HESS_NODE_EVERY-th node (5 km): a derivative
# transform costs host time per segment step (3.1-4.7 s a jacfwd of jacfwd
# on all 620 nodes, H100)
AD_HESS_B, AD_HESS_F, AD_HESS_X20K_F, AD_HESS_NODE_EVERY = 2, 8, 4, 5
AD_HESS_RTOL = 1e-12
# vmap of the fan kernel: 2 field stacks (the typical 512 x 32 slice, its
# layer as it is and 10 % denser) at F = 8, E = 32, the fan phase's steps
AD_FAN_F, AD_FAN_E, AD_FAN_DENSER = 8, 32, 1.1


def fan_grid(kind):
    """(z, x) host grids [km] of a fan scene."""
    x = np.linspace(0.0, 3995.0, 32)
    if kind == "typical":
        return np.linspace(0.0, 638.75, 512), x
    if kind == "large":
        return np.linspace(0.0, 620.0, 621), np.linspace(0.0, 3995.0, 800)
    return 80.0 + 1.25 * np.arange(448), x           # 80 .. 638.75 km


def fan_scene(kind):
    """The Chapman slice of tools/bench_fan_pallas.py on a grid:
    (z, x, Ne, |B|, psi, nu(z))."""
    z, x = fan_grid(kind)
    h = (z[:, None] - 250.0) / 45.0
    ne = (8.0e11 * (1.0 + 0.15 * (x[None, :] / x[-1] - 0.5))
          * np.exp(0.5 * (1.0 - h - np.exp(-h))))
    return (z, x, ne, np.full(ne.shape, 4.5e-5),
            np.full(ne.shape, np.deg2rad(30.0)),
            1e7 * np.exp(-(z - 70.0) / 8.0))


def two_node_scene():
    """(z, x, Ne) of the 2-node slice, 80-680 km."""
    z = np.linspace(80.0, 680.0, 121)
    ne = np.repeat(1e12 * np.exp(-((z - 300.0) / 50.0) ** 2)[:, None], 2, 1)
    return z, np.array([-100.0, 3000.0]), ne


def bound_ms(ops, nbytes, dtype_name):
    """The least time the card could take: max(ops / peak, bytes / rate)
    in ms, and which of the two bounds it."""
    t_ops = ops / PEAK_OPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def kernel_launches(got):
    """The ionogram kernels' launches in a copy of ``pallas_vh.LAUNCHES``,
    without the segment-table kernel that builds kernels 1 and 2's table
    (once before each of their launches, and for their plain versions on
    CUDA tensors)."""
    return sum(got.values()) - got["segment_table"]


def check_table_launches(got, what):
    """One segment-table launch for each launch of kernels 1 and 2."""
    check(got["segment_table"] == got["gather_osolve"]
          + got["gather_xsolve"], f"{what}: segment-table launches {got}")


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def sm_clock_under(torch, fn, seconds=2.0):
    """The SM clock (MHz) ``nvidia-smi`` reads while ``fn`` is launched
    again and again (at most ``seconds``)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    t0 = time.perf_counter()
    while proc.poll() is None and time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    out, _ = proc.communicate(timeout=60)
    clock = out.strip().splitlines()[:1]
    check(proc.returncode == 0 and clock and clock[0].replace(".", "", 1)
          .isdigit(), f"nvidia-smi clocks.sm: {out!r}")
    return float(clock[0])


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


def razor_profiles(alt, den, bmag, bpsi):
    """The razor phase's profiles: 8 of the main batch (Chapman F2, some
    with an E layer above a valley), the two-peak pair, and two of the
    first with |B| constant in height."""
    tp = two_peak(alt)
    flat_b = np.repeat(bmag[:2, :1], alt.size, axis=1)
    return (np.concatenate([den[:8], tp[0], den[:2]]),
            np.concatenate([bmag[:8], tp[1], flat_b]),
            np.concatenate([bpsi[:8], tp[2], bpsi[:2]]))


def razor_args(torch, pv, prof, alt, P, dtype, dev):
    """Prepared kernel-2 (``gather_xsolve``) args whose frequencies sit on
    cutoffs: for each profile, at RAZOR_NODES nodes spread over the grid,
    its node cutoff fx_j and prefix maximum cfx_j (``pallas_vh.
    cutoff_frequencies`` and ``cutoff_table``, in the working dtype) times
    (1 +- n ulp), n = 0..RAZOR_ULPS."""
    import dataclasses
    t = [torch.as_tensor(x, dtype=dtype, device=dev)
         for x in (np.array([5.0]), *prof, alt)]
    a = pv.prepare_kernel_args("gather_xsolve", *t, -1.0, P,
                               pv.uniform_inv_dalt(t[-1]))
    fx, cfx = pv.cutoff_frequencies(a), pv.cutoff_table(a)
    nodes = torch.linspace(0, fx.shape[1] - 1, RAZOR_NODES,
                           device=dev).round().long()
    base = torch.cat([fx[:, nodes], cfx[:, nodes]]).flatten()
    base = base[torch.isfinite(base) & (base > 0)]
    fs, up, down = [base], base, base
    for _ in range(RAZOR_ULPS):
        up = torch.nextafter(up, torch.full_like(up, float("inf")))
        down = torch.nextafter(down, torch.full_like(down, -float("inf")))
        fs += [up, down]
    return dataclasses.replace(a, freq_hz=torch.unique(torch.cat(fs)))


def sass_function(want, sass):
    """The SASS loops (``tools.cuda_sass.sass_loops``) of the one kernel
    whose demangled name holds ``want``."""
    hits = [v for k, v in sass.items() if want in k]
    check(len(hits) == 1, f"SASS of {want}: {len(hits)} functions")
    return hits[0]


def ionogram_function(kind, mode_mult, dtype_name):
    """The instantiation of csrc/ionogram.cu that runs ``kind``."""
    t = "float" if dtype_name == "float32" else "double"
    m = "(int)1" if mode_mult > 0 else "(int)-1"
    return {"gather_osolve": f"gather_kernel<{t}, (int)1, (bool)1>",
            "gather_xsolve": f"gather_kernel<{t}, (int)-1, (bool)1>",
            "gather": f"gather_kernel<{t}, {m}, (bool)0>",
            "sweep": f"ionogram_kernel<{t}, {m}>"}[kind]


def main_loop(loops, mufu="RSQ"):
    """The innermost loop with a MUFU ``mufu`` instruction (of several
    copies, the one whose longest path is longest): the tail's loop over
    grid points (a MUFU.RSQ: the roots of mu'), the fan's loop over
    steps."""
    cand = [lp for lp in loops if lp["path"]
            and any(mufu in m for m in lp["mufu"])]
    inner = [lp for lp in cand if not any(
        o is not lp and lp["start"] <= o["start"] and o["end"] <= lp["end"]
        for o in cand)]
    return max(inner, key=lambda lp: lp["longest"])


def issue_ms(torch, dev, instructions, clock_mhz):
    """Warp instructions over the card's issue rate: its SMs x 4
    schedulers, one warp instruction a cycle each, at ``clock_mhz``."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return 1e3 * instructions / (n_sm * 4 * clock_mhz * 1e6)


def issue_bound_ms(torch, pv, kind, a, valid, clock_mhz, sass):
    """The time the card's schedulers take to issue the kernel's loops
    (:func:`issue_ms`): the tail loop's instructions an iteration issues
    (:func:`main_loop`) times its warp iterations (ceil(P/32) a valid
    pair), and for kernel 2 its solve: the ballot scan (from the bracket's
    first node to the first exceedance) and the prefix-maximum pass over
    [0, k-1], each at its loop's instructions per 32 nodes (over the
    loop's MUFU.RCP, one a node). Other work (binary search, table loads,
    sums) is not counted. Returns (ms at the fewest instructions an
    iteration can issue: the bound, ms at the most, {what: count})."""
    loops = sass_function(ionogram_function(kind, a.mode_mult,
                                            str(a.tab.dtype)[6:]), sass)
    tail = main_loop(loops)
    P = a.mult.shape[0]
    warp_iters = int(valid.sum()) * -(-P // 32)
    issued = {k: tail[k] * warp_iters for k in ("path", "longest")}
    counts = {"tail_instructions": tail["path"],
              "tail_instructions_longest": tail["longest"],
              "tail_warp_iterations": warp_iters}
    if kind == "gather_xsolve":
        def per_node(vote, k):
            return min(lp[k] / sum("RCP" in m for m in lp["mufu"])
                       for lp in loops if lp["path"]
                       and (lp["vote"] > 0) == vote
                       and not any("RSQ" in m for m in lp["mufu"])
                       and any("RCP" in m for m in lp["mufu"]))
        scan, f0 = xsolve_iterations(torch, pv, a)
        for k in issued:
            issued[k] += per_node(True, k) * scan + per_node(False, k) * f0
        counts.update(scan_instructions=per_node(True, "path"),
                      scan_iterations=scan,
                      f0_instructions=per_node(False, "path"),
                      f0_iterations=f0)
    return (issue_ms(torch, a.tab.device, issued["path"], clock_mhz),
            issue_ms(torch, a.tab.device, issued["longest"], clock_mhz),
            counts)


def xsolve_iterations(torch, pv, a, chunk=128):
    """Warp iterations of kernel 2's solve loops on prepared args, summed
    over the pairs: the ballot scan (32 nodes an iteration from the first
    node whose cfx reaches f(1 - delta), to the first exceedance or the
    last node) and the f0 pass (ceil(k/32), valid pairs)."""
    cfx = pv.cutoff_table(a)
    tab = pv._table(a)
    N = tab.shape[2]
    f = a.freq_hz
    fl = f * (1.0 - pv.XSOLVE_MARGIN[tab.dtype])
    scan = f0 = 0
    for b0 in range(0, tab.shape[0], chunk):
        c = cfx[b0:b0 + chunk]
        den, bm = tab[b0:b0 + chunk, 2], tab[b0:b0 + chunk, 4]
        s = (den[:, None, :] * (CP * CP) * (1.0 / (f * f))[None, :, None]
             + bm[:, None, :] * G_P / f[None, :, None])
        exceed = s >= 1.0
        kf = torch.where(exceed.any(2), torch.argmax(exceed.to(torch.uint8),
                                                     dim=2), N)
        jlo = torch.searchsorted(c.contiguous(),
                                 fl[None, :].expand(c.shape[0], -1)
                                 .contiguous())
        live = jlo < N
        last = torch.where(kf < N, kf, N - 1)
        scan += int(torch.where(live, (last - jlo) // 32 + 1, 0).sum())
        k = torch.clamp(kf, min=1)
        f0 += int(torch.where(kf < N, (k + 31) // 32, 0).sum())
    return scan, f0


def razor_tol_f32(ref):
    """The razor phase's f32 tolerance: 1e-3 km, or 4 f32 ulps of the
    value where that is more (above ~2,000 km: f at the gyrofrequency of
    a constant-|B| profile, Y ~ 1 at every node, gives vh up to ~1e7 km,
    where 1e-3 km is below one ulp and any order of the sum differs)."""
    return np.fmax(TOL_F32_PLAIN, 4 * np.finfo(np.float32).eps
                      * np.abs(np.asarray(ref.double().cpu())))


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


def fan_phase(torch, prt, dev, card, sass):
    """The 2-D oblique slice: main path (counted), kernel against plain
    version, timing. Returns the kernels-line entries of ``fan_tables`` and
    ``fan_2d``."""
    from pyrayhf_tpu_torch import oblique, profiling
    from pyrayhf_tpu_torch import pallas_ray as pr

    f0s = np.linspace(4e6, 30e6, FAN_F)
    n_steps = int(round(FAN_SMAX / FAN_STEP))

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # ---- main path, counted --------------------------------------------
    print(f"fan main path: synthesize_oblique_ionogram_2d and _fan_2d_fn, "
          f"engine='auto', f32, F={FAN_F} x E={FAN_E} x {n_steps} steps",
          flush=True)
    torch.cuda.synchronize()
    pr.reset_counters()
    t0 = time.perf_counter()
    outs = {}
    for name, (kind, geom, mode, hops, rng_km, ground) in FAN_CASES.items():
        z, x, ne, babs, bpsi, nu = fan_scene(kind)
        syn = prt.synthesize_oblique_ionogram_2d(
            f0s, rng_km, x, z, T(ne), T(babs), T(bpsi), mode=mode,
            geometry=geom, n_elev=FAN_E, elev_min_deg=5.0, elev_max_deg=85.0,
            step_km=FAN_STEP, s_max_km=FAN_SMAX, n_hops=hops, nu=nu,
            ground=ground, engine="auto")
        fan = None
        if z[0] == 0.0:
            fan = oblique._fan_2d_fn(z, x, mode, geom, FAN_E, n_steps, hops,
                                     engine="auto")(
                T(f0s), T([5.0, 85.0]), T(ne), T(babs), T(bpsi), T(nu),
                T(FAN_STEP))
        outs[name] = (syn, fan)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, plain = dict(pr.LAUNCHES), dict(pr.PLAIN_CALLS)
    print(f"fan main path: {main_s:.3f} s wall; kernel launches {launches}; "
          f"plain-version calls {plain}", flush=True)
    check(launches["fan_2d"] >= 9, f"fan kernel launches {launches}")
    check(launches["fan_tables"] == launches["fan_2d"],
          f"fan table kernel launches {launches}")
    check(sum(plain.values()) == 0, f"fan plain versions ran: {plain}")
    for name, (syn, fan) in outs.items():
        _, _, _, hops, rng_km, ground = FAN_CASES[name]
        fr = syn["fan_range_km"].cpu().numpy()
        lo = syn["delay_low_sec"].cpu().numpy()
        el = syn["elev_low_deg"].cpu().numpy()
        gl = syn["ground_loss_low_db"].cpu().numpy()
        check(fr.shape == (FAN_F, FAN_E) and lo.shape == (FAN_F,)
              and syn["fan_range_km"].dtype == torch.float32,
              f"{name}: shapes {fr.shape} {lo.shape}")
        landed = np.isfinite(fr)
        hit = np.isfinite(lo)
        print(f"  {name}: rays landed {int(landed.sum())}/{fr.size}, "
              f"frequencies with a low ray {int(hit.sum())}/{FAN_F} (up to "
              f"{f0s[hit].max() / 1e6 if hit.any() else float('nan'):.2f} "
              f"MHz), low delay {np.nanmin(lo) * 1e3:.4f}.."
              f"{np.nanmax(lo) * 1e3:.4f} ms, ground loss "
              f"{np.nanmin(gl):.3f}..{np.nanmax(gl):.3f} dB", flush=True)
        check(0.05 < landed.mean() < 1.0, f"{name}: landing fraction")
        check(hit.any() and not hit.all(),
              f"{name}: low rays at {hit.sum()} of {FAN_F} frequencies")
        check(np.all(lo[hit] >= rng_km / 299792.458)
              and np.all((el[hit] >= 5.0) & (el[hit] <= 85.0)),
              f"{name}: delay below light time or elevation out of range")
        check(np.all(gl[hit] > 0.0) if ground else np.all(gl[hit] == 0.0),
              f"{name}: ground loss {gl[hit]}")
        if fan is not None:
            check(torch.equal(torch.nan_to_num(fan[0]),
                              torch.nan_to_num(syn["fan_range_km"])),
                  f"{name}: _fan_2d_fn and the synthesis fan differ")

    # ---- the kernel, through its wrapper, against its plain version -----
    def fields(kind, mode, dtype):
        """Host grids, the [F, nz, nx] mu, mu', kappa of a scene, the launch
        elevations and the step, on the card in ``dtype``."""
        z, x, ne, babs, bpsi, nu = fan_scene(kind)
        flds = oblique._fan_fields(T(f0s, dtype), T(ne, dtype),
                                   T(babs, dtype), T(bpsi, dtype),
                                   T(nu, dtype), mode)
        elevs = oblique._linspace(T(5.0, dtype), T(85.0, dtype), FAN_E)
        return z, x, flds, elevs, T(FAN_STEP, dtype)

    def needed_bytes(geo, p, itemsize):
        """Bytes of the table nodes this run's rays need: the 4 corners of
        every cell that holds a step point or a segment midpoint (where the
        RK4 stages and the quadrature read), 5 channels each, per
        frequency."""
        c0, c1 = (torch.cat([c, 0.5 * (c[..., :-1] + c[..., 1:])], -1)
                  for c in (p["c0_path"], p["c1_path"]))
        inside = (torch.isfinite(c0) & torch.isfinite(c1)
                  & (c0 >= geo.c0_lo) & (c0 <= geo.c0_hi)
                  & (c1 >= geo.c1_lo) & (c1 <= geo.c1_hi))
        i0 = torch.floor((torch.where(inside, c0, geo.o0) - geo.o0)
                         * geo.inv_d0).clamp(0, geo.nz - 2).long()
        i1 = torch.floor((torch.where(inside, c1, geo.o1) - geo.o1)
                         * geo.inv_d1).clamp(0, geo.nx - 2).long()
        f = torch.arange(FAN_F, device=dev)[:, None, None]
        key = ((f * geo.nz + i0) * geo.nx + i1)[inside]
        touched = torch.zeros(FAN_F * geo.nz * geo.nx, dtype=torch.bool,
                              device=dev)
        for off in (0, 1, geo.nx, geo.nx + 1):
            touched[key + off] = True
        return int(touched.sum()) * pr._CHANNELS * itemsize

    def run(name, dtype):
        """The wrapper ``fan_2d_pallas`` (one kernel launch) and the plain
        version on the tables it packs, on the same fields."""
        kind, geom, mode, hops = CHECK_CASES[name][:4]
        z, x, flds, elevs, ds = fields(kind, mode, dtype)
        n0 = pr.LAUNCHES["fan_2d"]
        k = pr.fan_2d_pallas(z, x, *flds, elevs, ds, geometry=geom,
                             n_steps=n_steps, n_hops=hops)
        check(pr.LAUNCHES["fan_2d"] == n0 + 1,
              f"{name}: the wrapper did not launch the kernel")
        geo = pr.fan_geometry(z, x, geom)
        tab = pr.pack_tables(geo, *flds)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p = pr.plain_fan(geo, tab, elevs, ds, n_steps=n_steps, n_hops=hops,
                         paths=True)
        end.record()
        torch.cuda.synchronize()
        info = dict(plain_ms=start.elapsed_time(end),
                    needed_bytes=needed_bytes(geo, p, tab.element_size()),
                    nan_mu=int(torch.isnan(
                        pr.table_views(geo, tab)[0][..., 0]).sum()),
                    path=pr.fan_path(geo, dtype), kernel=k)
        return ({key: v.double().cpu().numpy() for key, v in k.items()},
                {key: p[key].double().cpu().numpy() for key in pr.OUTPUTS},
                info)

    def diff(k, p):
        """(status equal, landing equal, max |d range| km on rays landed in
        both, max relative difference over every output, count over the
        f64 bound, landed fraction)."""
        st = np.array_equal(k["status_code"], p["status_code"])
        lk = np.isfinite(k["ground_range_km"])
        lp = np.isfinite(p["ground_range_km"])
        both = lk & lp
        dr = float(np.abs(k["ground_range_km"][both]
                          - p["ground_range_km"][both]).max()) \
            if both.any() else 0.0
        rel, over = 0.0, 0
        for key in pr.OUTPUTS:
            a, b = k[key], p[key]
            m = np.isfinite(a) & np.isfinite(b)
            if m.any():
                rel = max(rel, float((np.abs(a[m] - b[m])
                                      / np.maximum(np.abs(b[m]), 1e-300))
                                     .max()))
            over += int((~np.isclose(a, b, rtol=FAN_RTOL, atol=FAN_ATOL,
                                     equal_nan=True)).sum())
        return st, bool(np.array_equal(lk, lp)), dr, rel, over, lk.mean()

    print(f"fan kernel (through fan_2d_pallas) vs plain version on the card, "
          f"f64 (identical status and landing masks, rtol {FAN_RTOL:g}, "
          f"atol {FAN_ATOL:g})", flush=True)
    err64, plain64 = [], {}
    for name in F64_CASES:
        k, p, info = run(name, torch.float64)
        plain64[name] = p
        st, lm, dr, rel, over, frac = diff(k, p)
        frozen_bad = int(((p["status_code"] == 0)
                          & (p["steps_taken"] < n_steps)).sum())
        print(f"  {name} ({info['path']} path): status equal {st}, landing "
              f"equal {lm} ({frac:.3f} "
              f"landed), max|d range| {dr:.3e} km, max rel diff {rel:.3e}, "
              f"{over} values over the bound; NaN-mu table nodes "
              f"{info['nan_mu']}, rays frozen on a non-finite state "
              f"{frozen_bad}; plain {info['plain_ms']:.1f} ms", flush=True)
        check(st and lm and over == 0, f"{name}: f64 kernel vs plain")
        check(info["nan_mu"] > 0, f"{name}: no evanescent (NaN-mu) region")
        err64.append(dr)

    print("fan kernel (through fan_2d_pallas) vs plain version on the card, "
          "f32; the landing mask of the f32 kernel against plain f64; the "
          "main path's fan against the same launch", flush=True)
    f32, needed, plain32_ms, paths32 = {}, {}, {}, set()
    for name in F32_CASES:
        k, p, info = run(name, torch.float32)
        paths32.add(info["path"])
        needed[name], plain32_ms[name] = info["needed_bytes"], info["plain_ms"]
        st, lm, dr, rel, _, _ = diff(k, p)
        steps_eq = np.array_equal(k["steps_taken"], p["steps_taken"])
        agree32 = float((k["status_code"] == p["status_code"]).mean())
        row = dict(status_agree_f32=agree32, max_drange_f32=dr,
                   max_rel_f32=rel, path=info["path"])
        note = ""
        if name in plain64:
            lk = np.isfinite(k["ground_range_km"])
            lp64 = np.isfinite(plain64[name]["ground_range_km"])
            both = lk & lp64
            row.update(landing_agree_vs_f64=float((lk == lp64).mean()),
                       max_drange_vs_f64=float(np.abs(
                           k["ground_range_km"][both]
                           - plain64[name]["ground_range_km"][both]).max()))
            note = (f"; f32 kernel vs f64 plain: landing agreement "
                    f"{row['landing_agree_vs_f64']:.5f}, max|d range| "
                    f"{row['max_drange_vs_f64']:.4e} km")
        main_fan = outs[name][1] if name in outs else None
        if main_fan is not None:
            same = all(torch.equal(torch.nan_to_num(a),
                                   torch.nan_to_num(info["kernel"][key]))
                       for a, key in zip(main_fan, pr.OUTPUTS[:5]))
            check(same, f"{name}: the main path's fan differs from the "
                  "checked launch on the same fields")
            note += "; main path's fan identical to this launch"
        f32[name] = row
        print(f"  {name} ({info['path']} path): f32 kernel vs f32 plain: "
              f"status agreement "
              f"{agree32:.5f}, landing equal {lm}, steps equal {steps_eq}, "
              f"max|d range| {dr:.4e} km on rays landed in both, max rel "
              f"diff {rel:.3e} (bound {FAN_F32_RTOL:g}){note}; plain "
              f"{info['plain_ms']:.1f} ms", flush=True)
        check(st and lm and steps_eq and rel <= FAN_F32_RTOL,
              f"{name}: f32 kernel vs f32 plain")
    check(paths32 == {"shared", "global"},
          f"the f32 checks ran the kernel's paths {paths32}, not both")

    # ---- a 2-node x axis; more than 65,535 frequencies ------------------
    def grid_check(name, z, x, ne, fs, elevs, step, steps, dtype):
        """The wrapper ``fan_2d_pallas`` (one launch) against the plain
        version on the tables it packs, Cartesian O, on the scene's
        fields; checks codes, masks and steps identical and the values
        within the dtype's tolerance."""
        nu = 1e7 * np.exp(-(z - 70.0) / 8.0)
        flds = oblique._fan_fields(T(fs, dtype), T(ne, dtype),
                                   T(np.full(ne.shape, 4.5e-5), dtype),
                                   T(np.full(ne.shape, np.deg2rad(30.0)),
                                     dtype), T(nu, dtype), "O")
        el, ds = T(elevs, dtype), T(step, dtype)
        n0 = pr.LAUNCHES["fan_2d"]
        k = pr.fan_2d_pallas(z, x, *flds, el, ds, n_steps=steps)
        check(pr.LAUNCHES["fan_2d"] == n0 + 1,
              f"{name}: the wrapper did not launch the kernel")
        geo = pr.fan_geometry(z, x, "cartesian")
        p = pr.plain_fan(geo, pr.pack_tables(geo, *flds), el, ds,
                         n_steps=steps)
        k = {key: v.double().cpu().numpy() for key, v in k.items()}
        p = {key: p[key].double().cpu().numpy() for key in pr.OUTPUTS}
        st, lm, dr, rel, over, frac = diff(k, p)
        steps_eq = np.array_equal(k["steps_taken"], p["steps_taken"])
        f64 = dtype == torch.float64
        print(f"  {name} {str(dtype)[6:]} ({pr.fan_path(geo, dtype)} path, "
              f"{geo.nz}x{geo.nx} nodes, F={len(fs)} E={len(elevs)} {steps} "
              f"steps): status equal {st}, landing equal {lm} ({frac:.3f} "
              f"landed), steps equal {steps_eq}, max|d range| {dr:.3e} km, "
              f"max rel diff {rel:.3e}"
              + (f", {over} values over the bound" if f64 else ""),
              flush=True)
        check(st and lm and steps_eq
              and (over == 0 if f64 else rel <= FAN_F32_RTOL),
              f"{name} {dtype}: kernel vs plain")
        return k

    print(f"fan kernel vs plain version on a 2-node x axis (the slice from "
          f"the ground: heights below 80 km free space) and on F={WIDE_F} "
          f"frequencies", flush=True)
    z2, x2, ne2 = two_node_scene()
    z_ext = np.arange(0.0, z2[-1] + 1.0, z2[1] - z2[0])
    ne_ext = np.concatenate([np.zeros((len(z_ext) - len(z2), 2)), ne2])
    for dtype in (torch.float64, torch.float32):
        k = grid_check("2-node x axis", z_ext, x2, ne_ext, TWO_NODE_F,
                       np.linspace(5.0, 85.0, TWO_NODE_E), FAN_STEP,
                       n_steps, dtype)
        check((k["status_code"] == 1).any(), "2-node x axis: no ray landed")
    # the entry point on the same slice, routed to the kernel, against
    # its gradient-ODE engine, f64
    kw = dict(f0s_hz=np.array(TWO_NODE_F), ground_range_km=TWO_NODE_RANGE,
              x_grid_km=x2, z_grid_km=z2, Ne2d=T(ne2, torch.float64),
              Babs2d=np.full(ne2.shape, 4.5e-5),
              bpsi2d=np.full(ne2.shape, np.deg2rad(30.0)),
              n_elev=TWO_NODE_E)
    n0 = pr.LAUNCHES["fan_2d"]
    syn_k = prt.synthesize_oblique_ionogram_2d(engine="auto", **kw)
    check(pr.LAUNCHES["fan_2d"] == n0 + 1,
          "2-node x axis: engine='auto' did not launch the kernel")
    syn_x = prt.synthesize_oblique_ionogram_2d(engine="xla", **kw)
    bad = [key for key in syn_x if not np.allclose(
        syn_k[key].cpu().numpy(), syn_x[key].cpu().numpy(), rtol=FAN_RTOL,
        atol=FAN_ATOL, equal_nan=True)]
    lo = syn_k["delay_low_sec"].cpu().numpy()
    print(f"  synthesize_oblique_ionogram_2d on the 2-node slice, f64: "
          f"engine='auto' (the kernel) vs 'xla', keys beyond rtol "
          f"{FAN_RTOL:g}: {bad}; low-ray delay {lo} s, elevation "
          f"{syn_k['elev_low_deg'].cpu().numpy()} deg", flush=True)
    check(not bad and np.isfinite(lo).any(),
          f"2-node x axis: synthesis on the kernel vs xla: {bad}")
    zw = np.linspace(0.0, 400.0, 16)
    xw = np.linspace(0.0, 2000.0, 8)
    hw = (zw[:, None] - 250.0) / 45.0
    ne_w = (8.0e11 * (1.0 + 0.15 * (xw[None, :] / xw[-1] - 0.5))
            * np.exp(0.5 * (1.0 - hw - np.exp(-hw))))
    grid_check(f"F={WIDE_F}", zw, xw, ne_w, np.linspace(2e6, 30e6, WIDE_F),
               np.array([10.0, 60.0]), WIDE_STEP, WIDE_STEPS, torch.float64)

    # ---- timing -------------------------------------------------------
    print(f"fan timing: median of {TIMING_ITERS} launches after 3 warm-up "
          f"launches, CUDA events, f32, F={FAN_F} E={FAN_E} {n_steps} "
          f"steps; card: {card}", flush=True)
    rows = {}
    for name in ("typical_cart", "typical_sph", "large_cart", "large_sph"):
        kind, geom = CHECK_CASES[name][:2]
        z, x, flds, elevs, ds = fields(kind, "O", torch.float32)
        geo = pr.fan_geometry(z, x, geom)
        tab = pr.pack_tables(geo, *flds)

        def launch():
            return pr.launch_fan(geo, tab, elevs, ds, n_steps=n_steps)

        ms, _ = profiling.time_launch(launch, iters=TIMING_ITERS)
        taken = launch()["steps_taken"].double()
        steps = float(taken.sum())
        ops = steps * FAN_OPS_STEP[geom]
        nbytes = needed[name] + (elevs.numel() + len(pr.OUTPUTS) * FAN_F
                                 * FAN_E) * 4
        b_ms, b_by = bound_ms(ops, nbytes, "float32")
        # issue bound: the step loop's instructions times the warp
        # iterations, each warp (32 elevations of one frequency) running
        # as many steps as its longest ray
        path = pr.fan_path(geo, torch.float32)
        loop = main_loop(sass_function(
            f"fan2d_kernel<float, (bool){int(geom == 'spherical')}, "
            f"(bool){int(path == 'shared')}>", sass), "MUFU")
        E = taken.shape[-1]
        per_warp = torch.nn.functional.pad(
            taken.reshape(-1, E), (0, -E % 32)).reshape(-1, 32).amax(1)
        warp_iters = int(per_warp.sum())
        clock = sm_clock_under(torch, launch)
        i_ms = issue_ms(torch, dev, loop["path"] * warp_iters, clock)
        i_long = issue_ms(torch, dev, loop["longest"] * warp_iters, clock)
        # the longest ray is a serial chain: its time per step
        max_steps, mean_steps = float(taken.max()), float(taken.mean())
        rows[name] = dict(ms=ms, rays_per_s=FAN_F * FAN_E / (ms * 1e-3),
                          steps=steps, bound_ms=b_ms, bound_by=b_by,
                          issue_ms=i_ms, issue_ms_longest=i_long,
                          sm_clock_mhz=clock,
                          step_instructions=loop["path"],
                          step_instructions_longest=loop["longest"],
                          warp_iterations=warp_iters,
                          table_mb=tab.numel() * 4 / 1e6,
                          needed_mb=needed[name] / 1e6,
                          max_steps=max_steps, mean_steps=mean_steps,
                          us_per_step=1e3 * ms / max_steps,
                          block=pr._BLOCK,
                          path=pr.fan_path(geo, torch.float32))
        print(f"  kernel {kind} {geom} O ({rows[name]['path']} path, "
              f"blocks of {pr._BLOCK} rays): {ms:.4f} ms "
              f"({rows[name]['rays_per_s']:.4e} rays/s); steps taken "
              f"{steps:.0f} of {FAN_F * FAN_E * n_steps} ({ops:.4e} ops), "
              f"max {max_steps:.0f}, mean {mean_steps:.1f}, "
              f"{rows[name]['us_per_step']:.4f} us per step of the longest "
              f"ray; tables {rows[name]['table_mb']:.1f} MB of which the "
              f"rays need {rows[name]['needed_mb']:.2f} MB, bound "
              f"{b_ms:.4f} ms ({b_by}), issue bound {i_ms:.4f} ms "
              f"({loop['path']} instructions a step x {warp_iters} warp "
              f"steps at {clock} MHz; {i_long:.4f} ms at the longest path, "
              f"{loop['longest']})", flush=True)
    z, x, ne, babs, bpsi, nu = fan_scene("typical")
    fan = oblique._fan_2d_fn(z, x, "O", "cartesian", FAN_E, n_steps, 1)
    fan_args = (T(f0s), T([5.0, 85.0]), T(ne), T(babs), T(bpsi), T(nu),
                T(FAN_STEP))
    call_ms, _ = profiling.time_launch(fan, *fan_args, iters=TIMING_ITERS)
    # the call's parts: the broadcast Appleton-Hartree fields, the table
    # packing (gradients included), the kernel
    fld_args = (T(f0s), T(ne), T(babs), T(bpsi), T(nu), "O")
    fields_ms, _ = profiling.time_launch(oblique._fan_fields, *fld_args,
                                         iters=TIMING_ITERS)
    geo = pr.fan_geometry(z, x, "cartesian")
    pack_ms, _ = profiling.time_launch(pr.pack_tables, geo,
                                       *oblique._fan_fields(*fld_args),
                                       iters=TIMING_ITERS)
    plain_ms = plain32_ms["typical_cart"]
    print(f"  whole _fan_2d_fn(auto) call, typical cartesian: {call_ms:.4f} "
          f"ms ({FAN_F * FAN_E / (call_ms * 1e-3):.4e} rays/s), of which "
          f"fields {fields_ms:.4f} ms and table packing {pack_ms:.4f} ms; "
          f"plain version once (f32, above): {plain_ms:.1f} ms "
          f"({FAN_F * FAN_E / (plain_ms * 1e-3):.4e} rays/s)", flush=True)
    tables = fan_tables_timing(torch, pr, oblique, profiling, dev, card, sass,
                               f0s, launches["fan_tables"])
    r = rows["typical_cart"]
    return tables, {
        "name": "fan_2d", "route": "cuda", "source": FAN_SOURCE,
        "replaces": FAN_REPLACES, "launches": launches["fan_2d"],
        "max_abs_err": max(err64), "tol": {"rtol": FAN_RTOL,
                                           "atol": FAN_ATOL},
        "f32": f32, "ms": r["ms"], "plain_ms": plain_ms,
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "issue_ms": r["issue_ms"], "issue_ms_longest": r["issue_ms_longest"],
        "sm_clock_mhz": r["sm_clock_mhz"],
        "library_ms": None, "fan_2d_fn_ms": call_ms,
        "fields_ms": fields_ms, "pack_ms": pack_ms,
        "rays_per_s": r["rays_per_s"], "max_steps": r["max_steps"],
        "mean_steps": r["mean_steps"], "us_per_step": r["us_per_step"],
        "block": r["block"], "path": r["path"],
        "timing": {k: {key: v[key] for key in (
            "ms", "bound_ms", "bound_by", "issue_ms", "issue_ms_longest",
            "needed_mb",
            "max_steps", "mean_steps", "us_per_step", "path")}
            for k, v in rows.items()},
        "shape": f"F={FAN_F} E={FAN_E} steps={n_steps} 512x32 cartesian "
                 f"f32"}


def table_bits_differ(torch, got, want):
    """(elements whose bits differ, NaN counting as one value; the largest
    difference in units in the last place of ``want``)."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    bad = (nan_g != nan_w) | (~nan_w & (got.view(ints) != want.view(ints)))
    both = ~nan_g & ~nan_w & bad
    ulps = 0.0
    if both.any():
        w = want[both]
        ulp = (torch.nextafter(w.abs(), torch.full_like(w, np.inf))
               - w.abs())
        ulps = float(((got[both] - w).abs() / ulp).max())
    return int(bad.sum()), ulps


def fan_tables_timing(torch, pr, oblique, profiling, dev, card, sass, f0s,
                      main_launches):
    """``csrc/fan_tables.cu`` at the benchmark cell's shape (F = 64, 621 x
    800): its table against ``pack_tables`` of ``_fan_fields``, bit for
    bit in f64 (O and X, Cartesian and spherical) and in f32 (O,
    Cartesian), then its time beside theirs, its bound (the table written
    once, the slice read once) and its issue time (the frequency loop's
    longest path: its shortest is a thread with no node of the grid), f64
    and f32. Returns the kernels-line entry of ``fan_tables``."""
    z, x, ne, babs, bpsi, nu = fan_scene("large")
    print(f"fan tables: the table kernel against pack_tables(_fan_fields) "
          f"on the {len(z)} x {len(x)} slice, F={len(f0s)}; card: {card}",
          flush=True)
    rows = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        args = tuple(torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
                     for a in (f0s, ne, babs, bpsi, nu))
        cases = ([(g, m) for g in ("cartesian", "spherical")
                  for m in ("O", "X")] if dtype == torch.float64
                 else [("cartesian", "O")])
        for geom, mode in cases:
            geo = pr.fan_geometry(z, x, geom)
            n0 = pr.LAUNCHES["fan_tables"]
            got = pr.fan_tables(geo, *args, mode)
            check(pr.LAUNCHES["fan_tables"] == n0 + 1,
                  "fan_tables did not launch the kernel")
            want = pr.pack_tables(geo, *oblique._fan_fields(*args, mode))
            bad, ulps = table_bits_differ(torch, got, want)
            nan_mu = int(torch.isnan(pr.table_views(geo, want)[0][..., 0])
                         .sum())
            del got, want
            print(f"  {dname} {geom} {mode}: {bad} of "
                  f"{5 * len(f0s) * geo.nz * geo.nx} table elements differ "
                  f"in their bits (largest "
                  f"{ulps:.1f} ulp); NaN-mu nodes {nan_mu}", flush=True)
            check(bad == 0,
                  f"fan tables {dname} {geom} {mode}: {bad} elements differ")
            rows.setdefault(dname, {})[f"{geom}_{mode}_bits_differ"] = bad
            rows[dname][f"{geom}_{mode}_max_ulp"] = ulps
        geo = pr.fan_geometry(z, x, "cartesian")

        def kernel():
            return pr.launch_fan_tables(geo, *args, "O")

        k_ms, _ = profiling.time_launch(kernel, iters=TIMING_ITERS)
        f_ms, _ = profiling.time_launch(oblique._fan_fields, *args, "O",
                                        iters=TIMING_ITERS)
        fields = oblique._fan_fields(*args, "O")
        p_ms, _ = profiling.time_launch(pr.pack_tables, geo, *fields,
                                        iters=TIMING_ITERS)
        del fields
        n = len(f0s) * geo.nz * geo.nx
        item = args[1].element_size()
        b_ms, b_by = bound_ms(n * FAN_TABLE_OPS,
                              item * (5 * n + 3 * geo.nz * geo.nx + geo.nz
                                      + len(f0s)), dname)
        loop = main_loop(sass_function(
            f"fan_tables_kernel<{'double' if item == 8 else 'float'}, "
            f"(bool)0>", sass), "RSQ")
        # every warp of a tile runs each frequency of its chunk once
        warp_iters = (-(-geo.nx // 32)) * (-(-geo.nz // 8)) * 8 * len(f0s)
        clock = sm_clock_under(torch, kernel)
        i_ms = issue_ms(torch, dev, loop["longest"] * warp_iters, clock)
        torch.cuda.empty_cache()
        rows[dname].update(ms=k_ms, fields_ms=f_ms, pack_ms=p_ms,
                           plain_ms=f_ms + p_ms, bound_ms=b_ms,
                           bound_by=b_by, issue_ms=i_ms, sm_clock_mhz=clock,
                           loop_instructions=loop["longest"])
        print(f"  {dname} O cartesian: kernel {k_ms:.4f} ms; _fan_fields "
              f"{f_ms:.4f} ms + pack_tables {p_ms:.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}); issue {i_ms:.4f} ms "
              f"({loop['longest']} instructions a frequency on the longest "
              f"path x {warp_iters} warp iterations at {clock} MHz)",
              flush=True)
    r = rows["float64"]
    return {"name": "fan_tables", "route": "cuda",
            "source": FAN_TABLES_SOURCE, "replaces": None,
            "launches": main_launches, "bits_differ_f64": sum(
                v for k, v in r.items() if k.endswith("_bits_differ")),
            "f32": rows["float32"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "fields_ms": r["fields_ms"], "pack_ms": r["pack_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "issue_ms": r["issue_ms"], "sm_clock_mhz": r["sm_clock_mhz"], "library_ms": None,
            "shape": f"F={len(f0s)} 621x800 f64"}


def segment_table_timing(torch, pv, profiling, dev, card, prof, alt):
    """``csrc/segment_table.cu`` alone at the global grid's shape (kernel
    1's table, and kernel 2's), f64 and f32: its time beside its memory
    bound (inputs read once, table written once) and the time of the
    PyTorch composition it replaces, both on the card, after a check
    that the two tables agree bit for bit."""
    rows = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        den, bmag, bpsi, a = (torch.as_tensor(x, dtype=dtype, device=dev)
                              for x in (*prof, alt))
        B, N = den.shape
        for kind in ("gather_osolve", "gather_xsolve"):
            args = (kind, den, bmag, bpsi, a)
            tab, ref = pv.launch_segment_table(*args), \
                pv.plain_segment_table(*args)
            ints = torch.int64 if dtype == torch.float64 else torch.int32
            check(tab.shape == ref.shape and torch.equal(
                tab.view(ints), ref.view(ints)),
                f"segment table {kind} {dname}: differs from the plain "
                "version")
            _, C, ld = tab.shape
            nbytes = tab.element_size() * (3 * B * N + N + B * C * ld)
            b_ms, _ = bound_ms(0, nbytes, dname)
            del tab, ref
            k_ms, _ = profiling.time_launch(pv.launch_segment_table, *args,
                                            iters=TIMING_ITERS)
            p_ms, _ = profiling.time_launch(pv.plain_segment_table, *args,
                                            iters=TIMING_ITERS)
            rows[f"{kind} {dname}"] = {"ms": k_ms, "bound_ms": b_ms,
                                       "plain_ms": p_ms, "bytes": nbytes}
            print(f"  segment_table ({kind}'s table) B={B} N={N} C={C} "
                  f"ld={ld} {dname}: kernel {k_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({nbytes:.4e} bytes at "
                  f"{PEAK_BYTES:.3g} B/s, {100 * b_ms / k_ms:.1f}%), "
                  f"plain {p_ms:.4f} ms; {card}", flush=True)
    return rows


def mxu_phase(torch, prt, dev, card, freqs, alt, main_prof, check_prof,
              u_dir, sass):
    """The tensor-core one-hot kernel: main path (counted), against its
    plain version and kernel 3, gradient, timing. Returns its kernels-line
    entry."""
    from pyrayhf_tpu_torch import cuda_ext, pallas_vh as pv, profiling

    inv = pv.uniform_inv_dalt(alt)
    vfo = prt.vertical_forward_operator_batch
    no_rows = np.zeros((1, 1), dtype=bool)

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def args(kind, prof, mm, P, dtype):
        # 1/dalt read from the grid in the working dtype, as the entry
        # point reads it
        t = [T(a, dtype) for a in (freqs, *prof, alt)]
        return pv.prepare_kernel_args(kind, *t, mm, P,
                                      pv.uniform_inv_dalt(t[-1]))

    # ---- main path, counted ------------------------------------------
    main_in = [T(a) for a in (freqs, *main_prof, alt)]
    torch.cuda.synchronize()
    pv.reset_counters()
    t0 = time.perf_counter()
    out = {m: vfo(*main_in, mode=m, n_points=P_MAIN, engine="pallas_mxu")
           for m in ("O", "X")}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, plain = dict(pv.LAUNCHES), dict(pv.PLAIN_CALLS)
    print(f"mxu main path: vertical_forward_operator_batch(engine="
          f"'pallas_mxu') O and X, f32, B={B_MAIN} F={F_MAIN} P={P_MAIN}: "
          f"{main_s:.3f} s wall; kernel launches {launches}; plain-version "
          f"calls {plain}", flush=True)
    check(launches["mxu"] == 2 and sum(launches.values()) == 2,
          f"mxu main path launches {launches}")
    check(sum(plain.values()) == 0, f"plain versions ran: {plain}")
    for mode, vh in out.items():
        v = vh.cpu().numpy()
        check(vh.dtype == torch.float32 and v.shape == (B_MAIN, F_MAIN)
              and np.isfinite(v).mean() > 0.15, f"mxu {mode}: output")

    # ---- against the plain version and kernel 3 ------------------------
    errs, errs32, errs_k3, k3_f32 = [], [], [], []
    print(f"mxu kernel vs its plain version (f32 ≤ {TOL_F32_PLAIN:g} km, "
          f"f64 ≤ {TOL_F64:g} km, f32 vs plain f64 ≤ {TOL_F32:g} km) and vs "
          f"kernel 3 on the same prepared inputs (f64 ≤ {TOL_MXU_K3:g} km; "
          f"f32 and f64 bit for bit, identical NaN masks)", flush=True)

    def kernel3_warp(a):
        """Kernel 3 on prepared gather args in one frequency group of 8
        warps, a warp per pair (a check's launch: counted nowhere)."""
        B, C, ld = a.tab.shape
        F, P = a.freq_hz.shape[0], a.mult.shape[0]
        out = torch.empty((B, F), dtype=a.tab.dtype, device=dev)
        err = cuda_ext.load().pyrayhf_ionogram(
            int(a.tab.dtype == torch.float64), 1 if a.mode_mult > 0 else -1,
            0, 1, a.tab.data_ptr(), C, B, a.n_alt, ld, a.mult.data_ptr(),
            a.omm.data_ptr(), a.dmult.data_ptr(), P, a.freq_hz.data_ptr(),
            F, 1, 8, 0, a.span.data_ptr(), a.slope.data_ptr(),
            a.emax.data_ptr(), a.valid.data_ptr(), a.alt_min.data_ptr(),
            float(a.inv_dalt), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"kernel 3 warp launch: "
              f"{cuda_ext.error_string(err)} ({err})")
        return out

    def bitwise(name, out, ref):
        nan = torch.isnan(out)
        same = (torch.equal(nan, torch.isnan(ref))
                and torch.equal(out[~nan], ref[~nan]))
        print(f"  {name}: bit for bit {same} ({int((~nan).sum())} finite "
              f"values)", flush=True)
        check(same, f"{name}: not bit for bit")

    def against(prof, mm, P, tag, vh32=None):
        name = f"mxu {'O' if mm > 0 else 'X'} P={P} {tag}"
        degen = degenerate_rows(freqs, prof[0], prof[1], mm)
        a32, a64 = (args("mxu", prof, mm, P, dt)
                    for dt in (torch.float32, torch.float64))
        p32, p64 = pv.plain_ionogram(a32), pv.plain_ionogram(a64)
        if vh32 is None:
            vh32 = pv.launch_mxu(a32)
            vh64 = pv.launch_mxu(a64)
        else:       # the main path's output, and its entry point in f64
            vh64 = vfo(*[T(a, torch.float64) for a in (freqs, *prof, alt)],
                       mode="O" if mm > 0 else "X", n_points=P,
                       engine="pallas_mxu")
        compare(f"{name} f32 vs plain f32", vh32, p32, TOL_F32_PLAIN,
                no_rows, True)
        errs.append(compare(f"{name} f64 vs plain f64", vh64, p64, TOL_F64,
                            no_rows, True))
        errs32.append(compare(
            f"{name} f32 vs plain f64", vh32, p64, TOL_F32, degen, False,
            excused=over_tol(p32, p64, TOL_F32) & ~degen))
        # kernel 3 a warp per pair, whose sum over a pair's points runs in
        # the mxu kernel's order (on long grids launch_kernel gives it a
        # block per pair, which adds in another order)
        k3 = {dt: kernel3_warp(args("gather", prof, mm, P, dt))
              for dt in (torch.float32, torch.float64)}
        errs_k3.append(compare(f"{name} f64 vs kernel 3 f64", vh64,
                               k3[torch.float64], TOL_MXU_K3, no_rows, True))
        bitwise(f"{name} f64 vs kernel 3 f64", vh64, k3[torch.float64])
        bitwise(f"{name} f32 vs kernel 3 f32", vh32, k3[torch.float32])
        d32 = np.abs(vh32.double().cpu().numpy()
                     - k3[torch.float32].double().cpu().numpy())
        k3_f32.append(float(np.nanmax(d32)))

    for mode, mm in (("O", 1.0), ("X", -1.0)):
        against(main_prof, mm, P_MAIN, f"B={B_MAIN} (main path)", out[mode])
        against(check_prof, mm, 2000, f"B={B_CHECK}")

    # ---- gradient ---------------------------------------------------------
    print(f"mxu gradient (f64): autograd vs the plain sweep's (rtol 1e-10) "
          f"and a central difference along phase 5's direction (step "
          f"{FD_STEP:g}·den·u, rtol {FD_RTOL:g})", flush=True)
    g_in = [T(a[:8] if np.ndim(a) == 2 else a, torch.float64)
            for a in (freqs, *main_prof, alt)]

    def loss_of(vh):
        return torch.where(torch.isfinite(vh), vh, 0.0).sum()

    grads = []
    for f in (prt.ionogram_pallas_mxu, pv.ionogram_fast_xla):
        d = g_in[1].clone().requires_grad_(True)
        vh = f(g_in[0], d, *g_in[2:], mode_mult=1.0, n_points=P_MAIN)
        grads.append(torch.autograd.grad(loss_of(vh), d)[0])
    g, gp = grads
    n0 = pv.LAUNCHES["mxu"]
    with torch.no_grad():
        vp, vm = (prt.ionogram_pallas_mxu(
            g_in[0], g_in[1] + sgn * FD_STEP * u_dir, *g_in[2:],
            mode_mult=1.0, n_points=P_MAIN) for sgn in (1.0, -1.0))
    check(pv.LAUNCHES["mxu"] == n0 + 2, "mxu central difference launches")
    check(torch.equal(torch.isnan(vp), torch.isnan(vm)),
          "mxu: NaN mask moved within the step")
    fd = float((loss_of(vp) - loss_of(vm)) / (2.0 * FD_STEP))
    ad = float((g * u_dir).sum())
    rel = float(((g - gp).abs().max() / gp.abs().max()).item())
    print(f"  ionogram_pallas_mxu: max rel diff vs plain sweep {rel:.2e}; "
          f"directional derivative autograd {ad:.10e}, central difference "
          f"{fd:.10e}, rel diff {abs(fd - ad) / abs(ad):.2e}", flush=True)
    check(bool(torch.isfinite(g).all()) and torch.allclose(
        g, gp, rtol=1e-10, atol=0), "mxu gradient differs from the sweep's")
    check(abs(fd - ad) / abs(ad) <= FD_RTOL, "mxu central difference")

    # ---- timing -----------------------------------------------------------
    print(f"mxu timing: median of {TIMING_ITERS} launches after 3 warm-up "
          f"launches, CUDA events, O-200 B={B_MAIN}; card: {card}",
          flush=True)
    rows = {}
    for dt in (torch.float32, torch.float64):
        dname = str(dt).split(".")[-1]
        inp = [T(a, dt) for a in (freqs, *main_prof, alt)]
        a = pv.prepare_kernel_args("mxu", *inp, 1.0, P_MAIN, inv)
        a3 = pv.prepare_kernel_args("gather", *inp, 1.0, P_MAIN, inv)
        k_ms, _ = profiling.time_launch(pv.launch_mxu, a, iters=TIMING_ITERS)
        k3_ms, _ = profiling.time_launch(pv.launch_kernel, a3,
                                         iters=TIMING_ITERS)
        p_ms, _ = profiling.time_launch(lambda: pv.plain_ionogram(a),
                                        iters=TIMING_ITERS)
        w_ms, _ = profiling.time_launch(
            lambda: prt.ionogram_pallas_mxu(*inp, mode_mult=1.0,
                                            n_points=P_MAIN),
            iters=TIMING_ITERS)
        # the bound is the function's own work on these inputs: the tail's
        # scalar operations at every grid point of each valid (profile,
        # frequency) — an escaped ray's vh is NaN, with no work — and the
        # bytes of its inputs (the [B, 8, N] table, the grid, the host
        # solve's [B, F] rows) and output
        n_valid = int((a.valid != 0).sum())
        ops = n_valid * P_MAIN * ION_OPS_POINT["gather"]
        nbytes = a3.tab.element_size() * (a3.tab.numel() + F_MAIN
                                          + 3 * P_MAIN + 1
                                          + 4 * B_MAIN * F_MAIN) \
            + B_MAIN * F_MAIN
        b_ms, b_by = bound_ms(ops, nbytes, dname)
        # issue bound: the tail loop's instructions (one pass of its band
        # products included) times ceil(P/32) a valid pair
        tail = main_loop(sass_function(
            f"ionogram_mxu_kernel<{'float' if dname == 'float32' else 'double'}"
            ", (int)1>", sass))
        warp_iters = n_valid * -(-P_MAIN // 32)
        clock = sm_clock_under(torch, lambda: pv.launch_mxu(a))
        i_ms = issue_ms(torch, dev, tail["path"] * warp_iters, clock)
        i_long = issue_ms(torch, dev, tail["longest"] * warp_iters, clock)
        # apart from the bound: the tensor-core flops of the one-hot
        # products the kernel issues on these inputs (mxu_products) and
        # their time at the tensor peak; and, for comparison, those of the
        # first design, which took every pair (per 32 points 16 N-tiles ×
        # K1P/8 K-steps × 2 M-tiles × 3 parts of m16n8k8, 2,048 flops
        # each, or 16 × K1P/4 × 4 m8n8k4, 512 flops each) at every
        # (profile, frequency)
        pairs, tflops = mxu_products(torch, a)
        tc_ms = 1e3 * tflops / PEAK_TENSOR[dname]
        K1P = -(-a.tab.shape[2] // 8) * 8
        chunks = B_MAIN * F_MAIN * (-(-P_MAIN // 32))
        tflops_pr3 = chunks * (16 * (K1P // 8) * 2 * 3 * 2048
                               if dt == torch.float32
                               else 16 * (K1P // 4) * 4 * 512)
        tc_pr3_ms = 1e3 * tflops_pr3 / PEAK_TENSOR[dname]
        rows[dname] = dict(ms=k_ms, plain_ms=p_ms, wrapper_ms=w_ms,
                           same_function_kernel_ms=k3_ms, bound_ms=b_ms,
                           bound_by=b_by, issue_ms=i_ms,
                           issue_ms_longest=i_long, sm_clock_mhz=clock,
                           tail_instructions=tail["path"],
                           tail_instructions_longest=tail["longest"],
                           tail_warp_iterations=warp_iters,
                           scalar_ops=ops, bytes=nbytes,
                           valid_share=n_valid / (B_MAIN * F_MAIN),
                           mma_pairs=pairs, tensor_flops=tflops,
                           tensor_core_ms=tc_ms,
                           tensor_flops_pr3_design=tflops_pr3,
                           tensor_core_ms_pr3_design=tc_pr3_ms)
        print(f"  mxu {dname}: kernel {k_ms:.4f} ms ("
              f"{profiling.vh_evals_per_s(B_MAIN, F_MAIN, k_ms):.4e} vh/s; "
              f"bound {b_ms:.4f} ms, {b_by}: {ops:.4e} ops on the "
              f"{n_valid / (B_MAIN * F_MAIN):.4f} valid share, {nbytes:.4e} "
              f"bytes; issue bound {i_ms:.4f} ms ({tail['path']} "
              f"instructions x {warp_iters} warp iterations at {clock} "
              f"MHz; {i_long:.4f} ms at the longest path, "
              f"{tail['longest']}); the one-hot products issued, {pairs} (N-tile, "
              f"K-step) pairs over tiles of {MXU_TILE} points, "
              f"{tflops:.4e} tensor-core flops, take {tc_ms:.4f} ms at "
              f"{PEAK_TENSOR[dname]:.3g}/s, against {tflops_pr3:.4e} flops "
              f"and {tc_pr3_ms:.4f} ms for the first design), wrapper "
              f"{w_ms:.4f} ms, plain {p_ms:.4f} ms; kernel 3 (gather) on "
              f"the same inputs {k3_ms:.4f} ms", flush=True)
    r = rows["float32"]
    return {"name": "mxu", "route": "cuda", "source": MXU_SOURCE,
            "replaces": MXU_REPLACES, "launches": launches["mxu"],
            "max_abs_err": max(errs), "tol": TOL_F64,
            "max_abs_err_f32_vs_f64": max(errs32), "tol_f32": TOL_F32,
            "max_abs_err_vs_kernel3_f64": max(errs_k3),
            "tol_vs_kernel3": TOL_MXU_K3,
            "max_abs_err_vs_kernel3_f32": max(k3_f32),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "issue_ms": r["issue_ms"], "issue_ms_longest": r["issue_ms_longest"],
            "sm_clock_mhz": r["sm_clock_mhz"],
            "library_ms": None, "wrapper_ms": r["wrapper_ms"],
            "same_function_kernel_ms": r["same_function_kernel_ms"],
            "valid_share": r["valid_share"], "mma_pairs": r["mma_pairs"],
            "tensor_flops": r["tensor_flops"],
            "tensor_core_ms": r["tensor_core_ms"],
            "tensor_flops_pr3_design": r["tensor_flops_pr3_design"],
            "tensor_core_ms_pr3_design": r["tensor_core_ms_pr3_design"],
            "f64": rows["float64"],
            "shape": f"B={B_MAIN} F={F_MAIN} P={P_MAIN} N={N_ALT} f32 O"}


def mxu_products(torch, a, tile=None):
    """Tensor-core products that ``csrc/ionogram_mxu.cu`` issues on the
    prepared mxu args ``a``, counted on the host from the indices the
    kernel forms (the same ``span * (mult * inv_dalt)`` in the working
    dtype): for each valid (profile, frequency) and each tile of ``tile``
    consecutive grid points, the N-tiles of the offsets its points select
    times the K-steps (8 columns in f32, 4 in f64) that hold its one-hot
    columns. Returns (pairs, tensor flops): per pair, 3 TF32 parts of
    m16n8k8 (2,048 flops) per m16 tile of points in f32, one m8n8k4 (512
    flops) per m8 tile in f64."""
    from pyrayhf_tpu_torch import pallas_vh as pv
    tile = tile or MXU_TILE
    f32 = a.tab.dtype == torch.float32
    kstep = 8 if f32 else 4
    i0, _ = pv._uniform_index(a.span[:, :, None] * (a.mult * a.inv_dalt),
                              a.n_alt)
    B, F, P = i0.shape
    # points past P and frequencies the host solve marks invalid: no part
    i0 = torch.where((a.valid != 0)[:, :, None], i0, -1)
    i0 = torch.cat([i0, i0.new_full((B, F, -P % 32), -1)], 2)
    t = i0.reshape(B, F, -1, tile)
    inp = t >= 0
    col = torch.div(t, 16, rounding_mode="floor")
    lo = torch.where(inp, col, 1 << 30).amin(-1)
    hi = torch.where(inp, col, -1).amax(-1)
    ksteps = torch.where(hi >= 0, torch.div(hi, kstep, rounding_mode="floor")
                         - torch.div(lo, kstep, rounding_mode="floor") + 1, 0)
    off = t - 16 * col
    ntiles = sum(((off == nt) & inp).any(-1).long() for nt in range(16))
    pairs = int((ksteps * ntiles).sum())
    return pairs, pairs * ((tile // 16) * 3 * 2048 if f32
                           else (tile // 8) * 512)


def lm_scene(rng, alt, freqs, B):
    """B O-mode truths: hmF2 and B_bot uniform over LM_POP's ranges [km],
    NmF2 within ±20% of the golden — set to freq2den(f)·1.001 at the
    sounded frequency f nearest its foF2 — and per-sample |B| (a
    dipole-like fall-off) and ψ.

    The NmF2 pin of the retrieval (freq2den(f)·1.0001) cannot equal the
    truth on this grid: the flat extension at the peak leaves the peak
    node out, which costs up to 0.25·(Δh/B_bot)² of the peak, 4e-4 at
    Δh = 1 km and B_bot = 25 km, so a truth at the pin would not reflect
    at f (tests/test_torch_lm_f1_ledge.py shows it in both packages).
    At × 1.001, f reflects and the pin is 0.09% below the truth.
    """
    fo = CP * np.sqrt(GOLDEN["F2"]["Nm"] * rng.uniform(0.8, 1.2, B)) / 1e6
    f_top = freqs[np.abs(freqs[None, :] - fo[:, None]).argmin(axis=1)]
    truth = {"hm": rng.uniform(*LM_POP["hm"], B),
             "B_bot": rng.uniform(*LM_POP["B_bot"], B),
             "Nm": (f_top * 1e6 / CP) ** 2 * 1.001}
    b0 = rng.uniform(2.5e-5, 6.5e-5, B)
    bmag = b0[:, None] * ((6371.0 + alt[0]) / (6371.0 + alt[None, :])) ** 3
    bpsi = np.broadcast_to(rng.uniform(20.0, 80.0, B)[:, None],
                           bmag.shape).copy()
    return truth, bmag, bpsi


def lm_observe(prt, truth, bmag, bpsi, alt, freqs, F1, device):
    """The truths' ionograms [B, F] by one batched model_VH call (f64)."""
    import torch
    B = bmag.shape[0]

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    F2 = dict(GOLDEN["F2"], **{k: T(v)[:, None] for k, v in truth.items()})
    return prt.model_VH(F2, F1, GOLDEN["E"], T(freqs), T(alt).expand(B, -1),
                        T(bmag), T(bpsi))[0].cpu().numpy()


def lm_day(prt):
    """Phase 9's station-day, made on the CPU in f64: LM_B ionograms of
    LM_POP with LM_F1, the truths, |B| and ψ."""
    rng = np.random.default_rng(SEED + 9)
    alt = np.linspace(80.0, 699.0, N_ALT)
    freqs = np.arange(2.0, 11.51, 0.25)
    truth, bmag, bpsi = lm_scene(rng, alt, freqs, LM_B)
    obs = lm_observe(prt, truth, bmag, bpsi, alt, freqs, LM_F1, "cpu")
    return dict(rng=rng, alt=alt, freqs=freqs, truth=truth, bmag=bmag,
                bpsi=bpsi, obs=obs)


def lm_fit(prt, lm, n, dtype, device):
    """retrieve_gradient_batch on the first ``n`` ionograms of the day from
    hmF2 × 0.95 and B_bot × 1.1 of the truths: (vh, fit, history)."""
    import torch

    def T(a):
        return torch.as_tensor(np.asarray(a)[:n], dtype=dtype, device=device)

    guess = dict(GOLDEN["F2"], hm=lm["truth"]["hm"][:n] * 0.95,
                 B_bot=lm["truth"]["B_bot"][:n] * 1.1)
    vh, _, fit, hist = prt.retrieve_gradient_batch(
        guess, LM_F1, GOLDEN["E"],
        torch.as_tensor(lm["freqs"], dtype=dtype, device=device),
        T(lm["obs"]), torch.as_tensor(lm["alt"], dtype=dtype, device=device),
        T(lm["bmag"]), T(lm["bpsi"]), steps=LM_STEPS, chunk_size=None,
        dtype=dtype)
    return vh, fit, hist


def fit_errors(fit, vh, lm):
    """Per ionogram: |hmF2/truth − 1|, |B_bot/truth − 1| and max |vh_fit −
    obs| [km] over every finite value but the top one.

    The top sounded frequency lies within 0.05% of the truth's foF2, where
    vh diverges, and the fit's NmF2 pin (0.09% below the truth, see
    ``lm_scene``) moves it by up to hundreds of km; the LM leaves it out of
    its cost too (``crit_margin``: 0.995·foF2). Every other finite value
    is below 0.98·foF2 and compared.
    """
    B = vh.shape[0]
    truth, freqs = lm["truth"], lm["freqs"]
    obs = lm["obs"][:B]
    d = np.abs(vh.double().cpu().numpy() - obs)
    fin = np.isfinite(obs)
    top = np.arange(freqs.size)[None, :] == np.argmax(
        np.where(fin, freqs[None, :], -1.0), axis=1)[:, None]
    e_vh = np.nanmax(np.where(fin & ~top, d, 0.0), axis=1)
    return (np.abs(fit["hm"] / truth["hm"][:B] - 1),
            np.abs(fit["B_bot"] / truth["B_bot"][:B] - 1), e_vh)


def retrieval_phase(torch, prt, dev, card):
    """The inversions on the card (phase 9), then the CPU side of the LM
    comparison, with no card work running. Returns a summary dict."""
    from pyrayhf_tpu_torch import pallas_vh as pv, retrieval

    lm = lm_day(prt)
    alt, freqs, truth, obs = lm["alt"], lm["freqs"], lm["truth"], lm["obs"]
    fin = np.isfinite(obs)
    f_top = freqs[np.argmax(np.where(fin, freqs[None, :], -1.0), axis=1)]
    check(np.allclose((f_top * 1e6 / CP) ** 2 * 1.001, truth["Nm"],
                      rtol=1e-12),
          "a truth's top frequency does not reflect on the grid")
    check(np.all((freqs[None, :] < 0.98 * f_top[:, None])
                 | (freqs[None, :] == f_top[:, None]) | ~fin),
          "a finite value between 0.98 foF2 and the top frequency")
    print(f"inversions on the card; card: {card}", flush=True)
    print(f"  station-day: B={LM_B} O-mode ionograms (hmF2 U{LM_POP['hm']} "
          f"km, B_bot U{LM_POP['B_bot']} km, NmF2 within ±20% of the "
          f"golden, F1 P = {LM_F1['P']}), F={freqs.size} ({freqs[0]}.."
          f"{freqs[-1]} MHz), N_alt={N_ALT}, finite {fin.sum(1).min()}.."
          f"{fin.sum(1).max()} per ionogram", flush=True)

    # ---- batched LM, f64 and f32, checked at the JAX thresholds ----------
    # the LM loop itself (_lm_batch_core) runs in the sync debug mode
    # "error": any host sync inside it raises
    lm_core = retrieval._lm_batch_core

    def strict_core(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return lm_core(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    summary, fits = {}, {}
    retrieval._lm_batch_core = strict_core
    try:
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[-1]
            torch.cuda.synchronize()
            pv.reset_counters()
            t0 = time.perf_counter()
            vh, fit, hist = lm_fit(prt, lm, LM_B, dt, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fits[dname] = fit
            th = LM_TOL[dname]
            e_hm, e_bb, e_vh = fit_errors(fit, vh, lm)
            ok = (e_hm < th[0]) & (e_bb < th[1]) & (e_vh < th[2])
            conv = hist[-1] <= RETRY_COST
            step_up = float(np.max(np.diff(hist, axis=0)
                                   / np.maximum(hist[:-1], 1.0)))
            print(f"  retrieve_gradient_batch {dname}: B={LM_B}, {LM_STEPS} "
                  f"steps: {wall:.3f} s wall ({LM_B / wall:.2f} "
                  f"ionograms/s); plain sweep calls "
                  f"{pv.PLAIN_CALLS['sweep']}; final cost at most the retry "
                  f"cost ({RETRY_COST:g} km²) for {int(conv.sum())} of "
                  f"{LM_B}, and of those {int(ok[conv].sum())} within the "
                  f"thresholds: max |hmF2/truth - 1| {e_hm[conv].max():.3e} "
                  f"(tol {th[0]}), max |B_bot/truth - 1| "
                  f"{e_bb[conv].max():.3e} (tol {th[1]}), max |vh_fit - "
                  f"obs| {e_vh[conv].max():.3e} km (tol {th[2]}); all "
                  f"{LM_B}: {int(ok.sum())} within the thresholds, final "
                  f"cost median {np.median(hist[-1]):.3e}, max "
                  f"{hist[-1].max():.3e}; largest relative cost rise "
                  f"{step_up:.2e}", flush=True)
            for i in np.nonzero(~conv | ~ok)[0]:
                print(f"    sample {i}: truth hmF2 {truth['hm'][i]:.4f} km, "
                      f"B_bot {truth['B_bot'][i]:.4f} km, top frequency "
                      f"{f_top[i]} MHz; final cost {hist[-1, i]:.4e} km², "
                      f"|hmF2/truth - 1| {e_hm[i]:.3e}, |B_bot/truth - 1| "
                      f"{e_bb[i]:.3e}, max |vh_fit - obs| {e_vh[i]:.3e} km",
                      flush=True)
            check(vh.dtype == dt and vh.device.type == dev.type,
                  f"LM {dname}: output dtype/device")
            check(ok[conv].all(), f"LM {dname}: a converged fit missed its "
                  "truth")
            check((~conv).mean() <= LM_STALL_SHARE,
                  f"LM {dname}: {int((~conv).sum())} fits above the retry "
                  "cost")
            check(step_up <= (1e-9 if dname == "float64" else 1e-6),
                  f"LM {dname}: the cost history rose")
            summary[f"lm_{dname}_s"] = wall
    finally:
        retrieval._lm_batch_core = lm_core
    print("  the LM loops made no host sync (sync debug mode \"error\")",
          flush=True)

    # ---- brute search on one ionogram --------------------------------
    summary.update(brute_phase(torch, prt, dev, truth, lm["bmag"],
                               lm["bpsi"], f_top[0], truth["hm"][0] * 0.95,
                               truth["B_bot"][0] * 1.1))

    # ---- true height on B=64 Chapman ionograms ----------------------
    summary.update(true_height_phase(torch, prt, dev, lm["rng"]))

    # ---- the card's f64 LM fits against the CPU's, after the card work ---
    n = LM_CPU_B
    t0 = time.perf_counter()
    _, cpu_fit, _ = lm_fit(prt, lm, n, torch.float64, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    worst = max(float(np.max(np.abs(fits["float64"][k][:n] / cpu_fit[k]
                                    - 1)))
                for k in ("hm", "B_bot", "Nm"))
    print(f"  card f64 LM fits of the first {n} ionograms vs the same call "
          f"on the CPU ({cpu_s:.1f} s, {torch.get_num_threads()} threads): "
          f"max relative difference {worst:.3e} (rtol {LM_CPU_RTOL:g})",
          flush=True)
    check(worst <= LM_CPU_RTOL, "card vs CPU LM fits")
    summary["lm_cpu_vs_card_rel"] = worst
    return summary


def brute_phase(torch, prt, dev, truth, bmag, bpsi, f_top, hm0, bb0):
    """minimize_parameters(method="brute") on the station-day's first
    ionogram, its truths re-made on the 0.25-km grid of the JAX brute test
    (tests/test_edp_retrieval.py:146-178): there the peak truncation costs
    ≤ 1e-4 of the peak, so NmF2 = freq2den(f_top)·1.0001 keeps f_top
    reflecting and the pin closes the model family (the brute cost, unlike
    the LM's, counts the top frequency)."""
    alt = np.arange(80.0, 700.0, 0.25)
    freqs = np.arange(2.0, f_top + 1e-9, 0.25)
    bm = bmag[0, 0] * ((6371.0 + alt[0]) / (6371.0 + alt)) ** 3
    bp = np.full(alt.size, bpsi[0, 0])

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)

    F2 = dict(GOLDEN["F2"], Nm=(f_top * 1e6 / CP) ** 2 * 1.0001,
              hm=truth["hm"][0], B_bot=truth["B_bot"][0])
    obs = prt.model_VH(F2, LM_F1, GOLDEN["E"], T(freqs), T(alt),
                       T(bm), T(bp))[0].cpu().numpy()
    check(np.isfinite(obs).all(), "brute: the pin frequency escapes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, fit = prt.minimize_parameters(
        dict(F2, hm=hm0, B_bot=bb0), LM_F1, GOLDEN["E"], freqs, obs,
        T(alt), T(bm), T(bp), method="brute", percent_sigma=BRUTE_SIGMA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    G = np.prod([np.arange(v - v * BRUTE_SIGMA / 100.0,
                           v + v * BRUTE_SIGMA / 100.0, 1.0).size
                 for v in (hm0, bb0)])
    d_hm = abs(float(fit["hm"]) - truth["hm"][0])
    d_bb = abs(float(fit["B_bot"]) - truth["B_bot"][0])
    print(f"  minimize_parameters(brute): {G} forward operators (F="
          f"{freqs.size}, N_alt={alt.size}) in one batched call, {wall:.3f} "
          f"s wall; |hmF2 - truth| {d_hm:.3f} km (tol {BRUTE_TOL[0]}), "
          f"|B_bot - truth| {d_bb:.3f} km (tol {BRUTE_TOL[1]})", flush=True)
    check(d_hm <= BRUTE_TOL[0] and d_bb <= BRUTE_TOL[1], "brute recovery")
    return {"brute_s": wall, "brute_grid": int(G)}


def true_height_phase(torch, prt, dev, rng):
    """retrieve_profile_batch on B=64 Chapman O-mode ionograms (the scene
    of tests/test_true_height.py, hmF2 drawn per ionogram from U(260, 340)
    km on the grid's nodes, as the test's 300 km is: an off-node peak moves
    the top knot's start-model bias by ±0.15 km around the test scene's
    0.83 km, across its 1.0 km threshold), checked at that test's
    thresholds."""
    alt = np.arange(80.0, 600.0, 0.5)
    hm = np.round(rng.uniform(260.0, 340.0, TH_B) * 2.0) / 2.0
    z = (alt[None, :] - hm[:, None]) / 45.0
    den = (9e6 / CP) ** 2 * np.exp(0.5 * (1 - z - np.exp(-z)))
    bmag, bpsi = np.full(alt.size, 4.5e-5), np.full(alt.size, 35.0)
    freqs = np.linspace(2.0, 8.8, 16)

    def T(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)

    vh = prt.vertical_forward_operator_batch(
        T(freqs), T(den), T(bmag).expand(TH_B, -1),
        T(bpsi).expand(TH_B, -1), T(alt), mode="O", engine="parity")
    check(bool(torch.isfinite(vh).all()), "true height: escaped traces")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prt.retrieve_profile_batch(freqs, vh, T(alt), T(bmag), T(bpsi),
                                     mode="O")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = out["h_knots_km"].cpu().numpy()
    ne = out["ne_knots_m3"].cpu().numpy()
    rms = out["rms_km"].cpu().numpy()
    vh_n = vh.cpu().numpy()
    err = np.stack([h[b] - np.interp(ne[b], den[b][alt <= hm[b]],
                                     alt[alt <= hm[b]])
                    for b in range(TH_B)])
    print(f"  retrieve_profile_batch: B={TH_B} Chapman O-mode ionograms, "
          f"K={freqs.size}, N_alt={alt.size}: {wall:.3f} s wall; rms "
          f"{rms.max():.3e} km max (tol 0.2), top-knot error "
          f"{np.abs(err[:, -1]).max():.3f} km max (tol 1.0), knot error "
          f"{np.abs(err).max():.3f} km max (tol 25)", flush=True)
    check(out["den_fit"].device.type == dev.type, "true height on the card")
    check(rms.max() < 0.2 and np.all(np.diff(h, axis=1) > 0)
          and np.all(np.diff(ne, axis=1) > 0) and np.all(h < vh_n + 1e-9)
          and np.abs(err[:, -1]).max() < 1.0 and np.abs(err).max() < 25.0,
          "true height recovery")
    return {"true_height_s": wall}


def link_profile(prt, torch, alt):
    """The link phase's midpoint profile on ``alt`` (host, float64): the
    golden layers with LM_F1 by the port's edp, a dipole-like |B| of
    4.5e-5 T at alt[0] and psi 50 deg."""
    from pyrayhf_tpu_torch import retrieval
    den, _ = retrieval._build_edp(GOLDEN["F2"], LM_F1, GOLDEN["E"],
                                  torch.as_tensor(alt), "B_bot")
    bmag = 4.5e-5 * ((6371.0 + alt[0]) / (6371.0 + alt)) ** 3
    return den.numpy(), bmag, np.full_like(alt, 50.0)


def same_outputs(name, card_out, cpu_out, rtol):
    """Every key of two output dicts: identical NaN masks, finite values
    to ``rtol``. Returns the largest relative difference of each key."""
    worst = {}
    for k, v in cpu_out.items():
        a = v.double().numpy()
        b = card_out[k].double().cpu().numpy()
        check(a.shape == b.shape, f"{name} {k}: shape {b.shape} vs {a.shape}")
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"{name} {k}: NaN masks differ")
        m = np.isfinite(a)
        # a level in dB relative to max(|level|, 1 dB): the focusing gain
        # crosses 0 dB
        floor = 1.0 if k.endswith("_db") else 1e-300
        rel = np.abs(b[m] - a[m]) / np.maximum(np.abs(a[m]), floor)
        worst[k] = float(rel.max()) if m.any() else 0.0
    over = {k: w for k, w in worst.items() if w > rtol}
    check(not over, f"{name}: relative differences over tolerance {over}; "
          f"all: {worst}")
    return worst


def path_rows(r, keys):
    """The path columns ``keys`` of a traced ray as host rows [n, k]."""
    return np.stack([r[k].double().cpu().numpy() for k in keys], axis=1)


def accepted_attempts(r, keys):
    """Attempts whose state moved (a rejected attempt repeats it)."""
    y = path_rows(r, keys)
    return int((y[1:] != y[:-1]).any(axis=1).sum())


def link_phase(torch, prt, dev, card, glob):
    """The 1-D oblique link on the card (phase 10): Snell fans and the link
    ionogram at full width, the MUF map of the global grid through kernels
    1 and 2 (counted), the adaptive single-ray tracers, Faraday and
    Doppler, and the oblique inversion. Every card output that has a CPU
    counterpart is held to it. Returns (summary dict, launches of kernels
    1 and 2 by muf_map)."""
    from pyrayhf_tpu_torch import gradient, profiling
    from pyrayhf_tpu_torch import pallas_vh as pv
    from pyrayhf_tpu_torch import retrieval, snell

    cpu = torch.device("cpu")
    summary = {"card": card}
    t_phase = time.perf_counter()

    def T(a, dtype=torch.float64, device=dev):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # ---- 1. Snell fans and the link ionogram ------------------------------
    alt = np.linspace(80.0, 699.0, N_ALT)
    den, bmag, bpsi = link_profile(prt, torch, alt)
    els = np.linspace(5.0, 85.0, LINK_NELEV)
    F = LINK_F0S.size
    print(f"link: Snell fans and synthesize_oblique_ionogram, D={LINK_D} km, "
          f"F={F} ({LINK_F0S[0] / 1e6}-{LINK_F0S[-1] / 1e6} MHz), "
          f"E={LINK_NELEV}, N={N_ALT} (+ ground node); chunks of "
          f"{snell.fan_chunk_rows(F, LINK_NELEV, N_ALT + 1, 8, True)} rows "
          f"(spherical f64) within {snell._FAN_BYTES} bytes; {card}",
          flush=True)
    links = {}
    for geom in ("spherical", "cartesian"):
        tracer = getattr(prt, f"trace_rays_{geom}_snells")
        for mode in ("O", "X"):
            for dt in (torch.float64, torch.float32):
                prof = [T(a, dt) for a in (alt, den, bmag, bpsi)]
                tag = f"{geom} {mode} {str(dt)[6:]}"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fan = tracer(T(LINK_F0S, dt), T(els, dt), *prof, mode)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                del fan
                fan_ms, _ = profiling.time_launch(
                    lambda: tracer(T(LINK_F0S, dt), T(els, dt), *prof, mode),
                    iters=3, warmup=1)
                syn_ms, _ = profiling.time_launch(
                    lambda: prt.synthesize_oblique_ionogram(
                        T(LINK_F0S, dt), LINK_D, *prof, mode=mode,
                        geometry=geom, n_elev=LINK_NELEV),
                    iters=3, warmup=1)
                out = prt.synthesize_oblique_ionogram(
                    T(LINK_F0S, dt), LINK_D, *prof, mode=mode, geometry=geom,
                    n_elev=LINK_NELEV)
                lo = out["delay_low_sec"].double().cpu().numpy()
                hit = np.isfinite(lo)
                muf = float(LINK_F0S[hit].max() / 1e6) if hit.any() else None
                fr = out["fan_range_km"]
                check(fr.shape == (F, LINK_NELEV) and fr.dtype == dt,
                      f"link {tag}: fan shape {tuple(fr.shape)} {fr.dtype}")
                check(hit.any() and not hit.all(),
                      f"link {tag}: low rays at {hit.sum()} of {F}")
                check(np.all(lo[hit] >= LINK_D / 299792.458),
                      f"link {tag}: a delay below the light time")
                row = {"fan_ms": fan_ms, "synthesize_ms": syn_ms,
                       "fan_peak_bytes": peak, "link_muf_mhz": muf,
                       "landed_share": float(torch.isfinite(fr).float()
                                             .mean())}
                links[tag] = row
                print(f"  {tag}: trace_rays_{geom}_snells {fan_ms:.3f} ms, "
                      f"synthesize_oblique_ionogram {syn_ms:.3f} ms, fan "
                      f"peak {peak / 2**30:.3f} GiB above "
                      f"{base / 2**30:.3f} GiB, rays landed "
                      f"{row['landed_share']:.3f}, link MUF {muf} MHz",
                      flush=True)
                # the same port code on the CPU, six frequencies
                sub = LINK_F0S[LINK_SUB]
                c_out = prt.synthesize_oblique_ionogram(
                    T(sub, dt), LINK_D, *[T(a, dt) for a in
                                         (alt, den, bmag, bpsi)],
                    mode=mode, geometry=geom, n_elev=LINK_NELEV)
                p_out = prt.synthesize_oblique_ionogram(
                    T(sub, dt, cpu), LINK_D, *[T(a, dt, cpu) for a in
                                              (alt, den, bmag, bpsi)],
                    mode=mode, geometry=geom, n_elev=LINK_NELEV)
                if dt == torch.float64:
                    row["card_vs_cpu_f64"] = max(same_outputs(
                        f"link {tag} card vs CPU", c_out, p_out,
                        LINK_RTOL).values())
                else:
                    a = torch.isfinite(p_out["fan_range_km"])
                    b = torch.isfinite(c_out["fan_range_km"]).cpu()
                    # rays at the penetration edge: their CPU landing
                    # changes when the elevation moves by LINK_EDGE_DEG
                    edge = torch.zeros_like(a)
                    for sgn in (-1.0, 1.0):
                        nudged = tracer(T(sub, dt, cpu),
                                        T(els + sgn * LINK_EDGE_DEG, dt, cpu),
                                        *[T(v, dt, cpu) for v in
                                          (alt, den, bmag, bpsi)], mode)
                        edge |= (torch.isfinite(nudged["ground_range_km"])
                                 != a)
                    row["landing_differs"] = int((a != b).sum())
                    row["edge_rays"] = int(edge.sum())
                    check(not bool((a != b)[~edge].any()),
                          f"link {tag}: landing masks card vs CPU differ in "
                          f"{int(((a != b) & ~edge).sum())} rays off the "
                          "penetration edge")
                    d = (c_out["fan_range_km"].cpu() - p_out["fan_range_km"])
                    row["card_vs_cpu_f32_range_km"] = float(
                        torch.nan_to_num(d.abs()).max())
                shown = {k: v for k, v in row.items()
                         if k.startswith(("card_vs", "edge", "landing"))}
                print(f"    card vs CPU on {len(sub)} frequencies: {shown}",
                      flush=True)
    summary["link"] = links

    # ---- 2. the MUF map of the global grid (kernels 1 and 2) -------------
    gden, gbmag, gbpsi, galt = glob
    B = gden.shape[0]
    print(f"link: muf_map of the {B}-profile global grid, ranges "
          f"{MUF_RANGES} km, O and X, f32, engine='auto'", flush=True)
    g32 = [T(a, torch.float32) for a in (gden, gbmag, gbpsi, galt)]
    torch.cuda.synchronize()
    pv.reset_counters()
    t0 = time.perf_counter()
    maps = {m: prt.muf_map(MUF_RANGES, *g32, mode=m) for m in ("O", "X")}
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    launches, plain = dict(pv.LAUNCHES), dict(pv.PLAIN_CALLS)
    print(f"  muf_map O and X: {map_s:.3f} s wall; kernel launches "
          f"{launches}; plain-version calls {plain}", flush=True)
    check(launches["gather_osolve"] > 0 and launches["gather_xsolve"] > 0,
          f"muf_map did not launch kernels 1 and 2: {launches}")
    check(sum(plain.values()) == 0, f"muf_map: plain versions ran {plain}")
    map_ms = {m: profiling.time_launch(
        lambda: prt.muf_map(MUF_RANGES, *g32, mode=m), iters=3,
        warmup=1)[0] for m in ("O", "X")}
    from pyrayhf_tpu_torch import muf as muf_mod
    g64 = [T(a) for a in (gden, gbmag, gbpsi, galt)]
    inv_dalt = pv.uniform_inv_dalt(g64[3])
    f_ce = float(gbmag.max()) * G_P / 1e6
    map_err = {}
    for m, mm, kind in (("O", 1.0, "gather_osolve"),
                        ("X", -1.0, "gather_xsolve")):
        host_grid = muf_mod._default_freq_grid(gden, gbmag, m)
        check(np.array_equal(host_grid, muf_mod._default_freq_grid(
            g32[0], g32[1], m)), f"muf_map {m}: the f32 map's frequencies")
        freqs = T(host_grid)
        # the same route's plain version in f64 (chunks of profiles), and
        # the secant of each MUF: one vertical frequency step maps to
        # 0.1 MHz x secant in oblique frequency
        vh = torch.cat([pv.plain_ionogram(pv.prepare_kernel_args(
            kind, freqs, g64[0][b:b + 1024], g64[1][b:b + 1024],
            g64[2][b:b + 1024], g64[3], mm, 200, inv_dalt))
            for b in range(0, B, 1024)])
        f_ob = prt.vertical_to_oblique(freqs, vh[None],
                                       T(MUF_RANGES)[:, None, None])[0]
        ok = torch.isfinite(f_ob)
        ref = torch.where(ok.any(-1), torch.where(ok, f_ob, -torch.inf)
                          .amax(-1), float("nan"))
        idx = torch.where(ok, f_ob, -torch.inf).argmax(-1)
        tol = 0.1 * ref / freqs[idx] + 1e-9
        got = maps[m].double()
        check(got.shape == (len(MUF_RANGES), B),
              f"muf_map {m}: shape {tuple(got.shape)}")
        check(torch.equal(torch.isnan(got), torch.isnan(ref)),
              f"muf_map {m}: NaN rows differ from the plain f64 map")
        fin = torch.isfinite(ref)
        d = (got - ref).abs()
        over = int((d[fin] > tol[fin]).sum())
        map_err[m] = {"max_abs_mhz": float(d[fin].max()),
                      "max_in_steps": float((d[fin] / (tol[fin] - 1e-9))
                                            .max()),
                      "over_one_step": over, "nan_share": float(
                          (~fin).double().mean()),
                      # MUFs read at a vertical frequency below the
                      # largest gyrofrequency of the grid
                      "sub_gyro_share": float(
                          (freqs[idx][fin] < f_ce).double().mean())}
        print(f"  muf_map {m} f32 (kernel) vs its plain version f64: "
              f"{map_err[m]}; MUF {float(ref[fin].min()):.2f}.."
              f"{float(ref[fin].max()):.2f} MHz; f32 call "
              f"{map_ms[m]:.3f} ms; {card}", flush=True)
        check(over == 0, f"muf_map {m}: {over} MUFs more than one "
              "frequency step from the plain f64 map")
        # the f64 map through the same kernels: vh within the f64 kernel
        # tolerance (TOL_F64 km) moves f_ob by at most TOL_F64 / h' of
        # itself, h' ≥ 80 km
        got64 = prt.muf_map(MUF_RANGES, *g64, mode=m)
        check(torch.equal(torch.isnan(got64), torch.isnan(ref)),
              f"muf_map {m} f64: NaN rows differ from the plain f64 map")
        rel64 = float(((got64 - ref).abs() / ref)[fin].max())
        map_err[m]["f64_kernel_vs_plain_rel"] = rel64
        print(f"  muf_map {m} f64 (kernel) vs its plain version: max "
              f"relative difference {rel64:.3e} (tol "
              f"{MUF_F64_RTOL:g})", flush=True)
        check(rel64 <= MUF_F64_RTOL, f"muf_map {m} f64: {rel64}")
    summary["muf_map"] = {"profiles": B, "ranges_km": MUF_RANGES,
                          "launches": {k: launches[k] for k in
                                       ("gather_osolve", "gather_xsolve")},
                          "first_call_s": map_s, "ms": map_ms,
                          "vs_plain_f64": map_err}

    # ---- 3. adaptive single-ray gradient tracers ----------------------------
    gold = np.load(pathlib.Path(__file__).resolve().parent / "tests"
                   / "goldens" / "reference_goldens.npz")
    zg, xg = gold["gauss_alt"], gold["gauss_x_grid"]
    mu, mup = gold["gauss_mu_field"], gold["gauss_mup_field"]
    rays = {}
    for geom, kw, keys, golden in (
            ("cartesian", dict(step_km=5.0, max_step_km=5.0, z_max_km=600.0,
                               x_min_km=0.0, x_max_km=1000.0),
             ("x", "z", "vx", "vz"), "grad_cart_O"),
            ("spherical", dict(step_km=2.0, max_step_km=2.0,
                               r_max_km=6371.0 + 600.0, phi_min=-0.1,
                               phi_max=1000.0 / 6371.0),
             ("r", "phi", "v_r", "v_phi"), "grad_sph_O")):
        res = []
        for where in (dev, cpu):
            nag = getattr(prt, "build_refractive_index_interpolator_"
                          + geom)(zg, xg, T(mu, device=where))
            mupf = prt.build_mup_function(T(mup, device=where), xg, zg,
                                          geometry=geom)
            fn = getattr(prt, f"trace_ray_{geom}_gradient")
            if where == dev:
                fn(nag, mupf, 0.0, 0.0, 35.0, 4000.0, rtol=1e-7, atol=1e-9,
                   **kw)                                    # warm-up
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(nag, mupf, 0.0, 0.0, 35.0, 4000.0, rtol=1e-7, atol=1e-9,
                   **kw)
            if where == dev:
                torch.cuda.synchronize()
            res.append((r, time.perf_counter() - t0,
                        dict(gradient.EXIT_STATS)))
        (rc, tc, sc), (rp, tp, sp) = res
        acc_c, acc_p = accepted_attempts(rc, keys), accepted_attempts(rp,
                                                                      keys)
        errs = {}
        for k in ("ground_range_km", "group_path_km"):
            a, b = float(rp[k]), float(rc[k])
            errs[k] = abs(b - a) / abs(a)
        land_c = path_rows(rc, ("x", "z"))[-1]
        land_p = path_rows(rp, ("x", "z"))[-1]
        errs["landing_point"] = float(np.abs(land_c - land_p).max()
                                      / np.abs(land_p).max())
        oracle = gold[golden][1]
        ours = np.array([float(rc[k]) for k in (
            "group_path_km", "group_delay_sec", "ground_range_km",
            "x_apex_km", "z_apex_km")])
        vs_oracle = float(np.max(np.abs(ours - oracle) / np.abs(oracle)))
        rays[geom] = {"status": rc["status"], "attempts_run": sc["steps"],
                      "attempt_budget": sc["of"], "chunks": sc["chunks"],
                      "accepted": acc_c, "card_s": tc, "cpu_s": tp,
                      "card_ms_per_attempt": 1e3 * tc / sc["steps"],
                      "card_vs_cpu": errs, "vs_oracle": vs_oracle}
        print(f"  adaptive {geom} ray, 35 deg, rtol 1e-7 atol 1e-9: "
              f"{rays[geom]}", flush=True)
        check(rc["status"] == rp["status"] == "ground",
              f"adaptive {geom}: status card {rc['status']} CPU "
              f"{rp['status']}")
        check(acc_c == acc_p and sc == sp,
              f"adaptive {geom}: accepted attempts card {acc_c} CPU {acc_p},"
              f" exits {sc} {sp}")
        check(max(errs.values()) <= GRAD_RTOL,
              f"adaptive {geom}: card vs CPU {errs}")
        check(vs_oracle < 0.015, f"adaptive {geom}: {vs_oracle} from the "
              "scipy oracle")
    summary["adaptive_rays"] = rays

    # ---- 4. Faraday and Doppler ----------------------------------------
    dalt = np.linspace(80.0, 700.0, 620)
    dden = 2.5e12 * np.exp(-((dalt - 320.0) / 80.0) ** 2)
    dprof = (dden, np.full_like(dalt, 4.5e-5), np.full_like(dalt, 35.0),
             dalt)
    fr_out = [{"rad": prt.faraday_rotation_vertical(
        T(FARADAY_FREQS, device=w), *[T(a, device=w) for a in dprof])}
        for w in (dev, cpu)]
    fd_err = {"faraday": max(same_outputs("faraday", *fr_out,
                                          LINK_RTOL).values())}
    for name, tend in (("uplift", -0.02 * np.gradient(dden, dalt)),
                       ("tid", dden * 2e-3 * np.sin(
                           2 * np.pi * (dalt - dalt[0]) / 150.0))):
        for mode in ("O", "X"):
            outs = [prt.doppler_shift_vertical(
                T(DOP_FREQS, device=w), T(dden, device=w),
                T(tend, device=w), *[T(a, device=w) for a in dprof[1:]],
                mode=mode) for w in (dev, cpu)]
            fd_err[f"doppler_{name}_{mode}"] = max(same_outputs(
                f"doppler {name} {mode}", *outs, LINK_RTOL).values())
            fd = outs[0]["doppler_hz"].cpu().numpy()
            check(np.isfinite(fd).sum() >= 5,
                  f"doppler {name} {mode}: {fd}")
            if name == "uplift":
                check(np.all(fd[np.isfinite(fd)] < 0.0),
                      f"doppler uplift {mode}: a non-negative shift {fd}")
    print(f"  Faraday and Doppler (N=620, {DOP_FREQS.size} sounding "
          f"frequencies) card vs CPU, f64, max relative difference: "
          f"{fd_err}", flush=True)
    summary["faraday_doppler_card_vs_cpu"] = fd_err

    # ---- 5. retrieve_from_oblique ----------------------------------------
    ialt = np.linspace(80.0, 600.0, 261)
    F1, E = {"P": 0.0}, {"Nm": 5e10, "hm": 110.0, "B_bot": 5.0,
                         "B_top": 7.0}
    ib, ip = T(np.full_like(ialt, 4.5e-5)), T(np.full_like(ialt, 40.0))
    edp_t, _ = retrieval._build_edp(INV_TRUTH, F1, E, T(ialt), "B_bot")
    obs = prt.synthesize_oblique_ionogram(
        T(INV_F0S), 900.0, T(ialt), edp_t, ib, ip, geometry="spherical",
        n_elev=INV_NELEV)
    lo, hi = obs["delay_low_sec"], obs["delay_high_sec"]
    n_obs = int(torch.isfinite(lo).sum())
    check(6 <= n_obs < INV_F0S.size, f"inversion: {n_obs} echoes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfit, _, edp_f, F2f, hist = prt.retrieve_from_oblique(
        INV_PRIOR, F1, E, T(INV_F0S), lo, 900.0, T(ialt), ib, ip,
        geometry="spherical", n_elev=INV_NELEV, steps=INV_STEPS,
        delay_high_obs_sec=hi)
    torch.cuda.synchronize()
    inv_s = time.perf_counter() - t0
    rel = {k: abs(F2f[k] / INV_TRUTH[k] - 1) for k in ("Nm", "hm", "B_bot")}
    m = torch.isfinite(lo) & torch.isfinite(dfit)
    rms = float(torch.sqrt(torch.mean((dfit[m] - lo[m]) ** 2)))
    summary["oblique_inversion"] = {"wall_s": inv_s, "rel_err": rel,
                                    "rms_delay_s": rms,
                                    "echoes": n_obs,
                                    "history": hist.tolist()}
    print(f"  retrieve_from_oblique (N=261, F={INV_F0S.size}, spherical, "
          f"n_elev={INV_NELEV}, {INV_STEPS} steps): {inv_s:.3f} s wall; "
          f"{summary['oblique_inversion']}", flush=True)
    # tests/test_oblique_inversion.py:62-74
    check(max(rel.values()) < 1e-3, f"inversion: parameters {rel}")
    check(int(m.sum()) >= 6 and rms < 1e-6, f"inversion: rms {rms}")
    check(hist.shape == (INV_STEPS,) and (hist[-1] < hist[0]
                                          or hist[-1] < 1e-10),
          f"inversion: history {hist}")
    check(abs(float(edp_f.max()) / F2f["Nm"] - 1) < 1e-6,
          "inversion: the fitted EDP's peak is not the fitted NmF2")
    summary["wall_s"] = time.perf_counter() - t_phase
    return summary, summary["muf_map"]["launches"]


def tensors_only(out):
    """The tensor values of a tracer's output dict."""
    return {k: v for k, v in out.items() if hasattr(v, "dim")}


def close_3d(name, card_out, cpu_out, rtol):
    """The 3-D slice's card against CPU rule, the CPU tests' (tests/
    test_torch_trace3d.py): every tensor key with identical NaN masks (and
    equal booleans and status codes), finite values within rtol, with an
    absolute floor of rtol times the channel's largest value on the path
    channels and 1e-12 of it elsewhere (offsets and gradients near zero).
    Returns the largest relative difference."""
    worst = 0.0
    for k, v in tensors_only(cpu_out).items():
        a = v.double().numpy()
        b = card_out[k].double().cpu().numpy()
        check(a.shape == b.shape, f"{name} {k}: shape {b.shape} vs {a.shape}")
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"{name} {k}: NaN masks differ")
        m = np.isfinite(a)
        if not m.any():
            continue
        scale = np.abs(a[m]).max()
        floor = (rtol if k in ("lat", "lon", "alt", "ecef", "u")
                 else 1e-12) * scale
        d = np.abs(b[m] - a[m])
        over = d > rtol * np.abs(a[m]) + floor
        check(not over.any(), f"{name} {k}: {int(over.sum())} values over "
              f"tolerance, worst {d.max():.3e} (scale {scale:.3e})")
        worst = max(worst, float((d / np.maximum(
            np.maximum(np.abs(a[m]), floor / rtol), 1e-300)).max()))
    print(f"    {name}: largest relative difference {worst:.3e} "
          f"(rtol {rtol:g})", flush=True)
    return worst


def trace3d_phase(torch, prt, dev, card, keep=None):
    """The 3-D slice on the card (phase 11): the input volume from the
    climatology and the IGRF, the fixed-psi link ionogram, fan and single
    rays, and the anisotropic fans, ionogram and field-table gradient, at
    example 10's width. Each f64 card result is held against the same
    call on the CPU on a subset. The slice runs no kernel of its own.
    Returns a summary dict; a ``keep`` dict receives the volume, the fan's
    elevations and azimuths, the anisotropic field and its O-mode fan at
    4-km steps (the mesh phase's unsharded fan)."""
    from pyrayhf_tpu_torch import gradient, trace3d, trace3d_aniso

    cpu = torch.device("cpu")
    here = "card" if dev.type == "cuda" else "CPU"
    summary = {"card": card}
    t_phase = time.perf_counter()

    def T(a, dtype=torch.float64, device=dev):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def run(name, fn, device=dev):
        """fn() timed on the host clock around a synchronise, with its
        steps run and the peak memory above the start (card only)."""
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        gradient.EXIT_STATS.update(steps=0, of=0)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        row = {"s": sec, "steps": gradient.EXIT_STATS["steps"],
               "of": gradient.EXIT_STATS["of"]}
        if device.type == "cuda":
            row["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        where = "card" if device.type == "cuda" else "CPU"
        print(f"  {name} ({where}): {sec:.3f} s, steps run {row['steps']} "
              f"of {row['of']}"
              + (f", peak {row['peak_bytes'] / 2**30:.3f} GiB"
                 if "peak_bytes" in row else ""), flush=True)
        summary[f"{name} {where}"] = row
        return out

    def muf(out, f0s):
        lo = out["delay_low_sec"].double().cpu().numpy()
        hit = np.isfinite(lo)
        return float(f0s[hit].max() / 1e6) if hit.any() else None

    # ---- 1. the input volume ---------------------------------------------
    n_nodes = T3D_ALT.size * T3D_LAT.size * T3D_LON.size
    print(f"3-D: generate_input_3D{T3D_DATE}, F107={T3D_F107}, "
          f"{T3D_ALT.size} x {T3D_LAT.size} x {T3D_LON.size} = {n_nodes} "
          f"nodes; {card}", flush=True)
    gen = (*T3D_DATE, T3D_LAT, T3D_LON, T3D_ALT, T3D_F107)
    inp = run("generate_input_3D", lambda: prt.generate_input_3D(
        *gen, device=dev))
    inp_c = run("generate_input_3D", lambda: prt.generate_input_3D(
        *gen, device=cpu), cpu)
    summary["generate_input_3D card vs CPU"] = close_3d(
        "generate_input_3D card vs CPU",
        {k: torch.from_numpy(inp[k]) for k in ("den", "bmag", "bpsi")},
        {k: torch.from_numpy(inp_c[k]) for k in ("den", "bmag", "bpsi")},
        T3D_RTOL)
    den, bmag, bpsi = inp["den"], inp["bmag"], inp["bpsi"]
    check(den.shape == (T3D_ALT.size, T3D_LAT.size, T3D_LON.size)
          and np.isfinite(den).all() and den.max() > 1e11,
          f"generate_input_3D: den {den.shape}, max {den.max():.3e}")
    vol = (T3D_ALT, T3D_LAT, T3D_LON, den, bmag, bpsi)

    # ---- 2. the fixed-psi link ionogram ------------------------------------
    fan_rays = T3D_F0S.size * T3D_FAN["n_elev"] * T3D_FAN["n_az"]
    print(f"3-D: synthesize_oblique_ionogram_3d, link {T3D_LINK}, "
          f"F={T3D_F0S.size} ({T3D_F0S[0] / 1e6}-{T3D_F0S[-1] / 1e6} MHz), "
          f"O, {T3D_FAN} ({fan_rays} rays in one fan); stacked volumes "
          f"{6 * T3D_F0S.size * n_nodes * 8 / 2**30:.2f} GiB in f64",
          flush=True)
    ions = {}
    for dt in (torch.float64, torch.float32):
        tag = str(dt)[6:]
        ions[tag] = run(f"ionogram {tag}",
                        lambda: prt.synthesize_oblique_ionogram_3d(
                            T(T3D_F0S), *T3D_LINK,
                            *[T(a, dt) for a in vol], **T3D_FAN))
        summary[f"ionogram {tag} {here}"]["link_muf_mhz"] = muf(ions[tag],
                                                              T3D_F0S)
        lo = ions[tag]["delay_low_sec"]
        check(lo.shape == (T3D_F0S.size,) and lo.dtype == dt,
              f"ionogram {tag}: {tuple(lo.shape)} {lo.dtype}")
        hit = torch.isfinite(lo).cpu().numpy()
        check(hit.any() and not hit.all(),
              f"ionogram {tag}: low rays at {hit.sum()} of {hit.size}")
        print(f"    link MUF {summary[f'ionogram {tag} {here}']['link_muf_mhz']}"
              f" MHz, range {ions[tag]['range_km']:.3f} km, azimuth "
              f"offsets {ions[tag]['azimuth_offset_low_deg'][hit].abs().max():.4e}"
              " deg at most", flush=True)
    m64 = summary[f"ionogram float64 {here}"]["link_muf_mhz"]
    m32 = summary[f"ionogram float32 {here}"]["link_muf_mhz"]
    check(abs(m64 - m32) <= 0.5, f"ionogram: MUF f32 {m32} vs f64 {m64}")
    # the CPU sweeps T3D_SUB's frequencies alone: its rows are held to the
    # same rows of the card's whole sweep (a ray's steps do not depend on
    # the other rays of its fan)
    sub = T3D_F0S[T3D_SUB]
    i_cpu = run("ionogram subset", lambda: prt.synthesize_oblique_ionogram_3d(
        T(sub, device=cpu), *T3D_LINK, *[T(a, device=cpu) for a in vol],
        **T3D_FAN), cpu)
    summary["ionogram card vs CPU"] = close_3d(
        "ionogram card vs CPU",
        {k: v[T3D_SUB] for k, v in tensors_only(ions["float64"]).items()
         if v.shape == (T3D_F0S.size,)},
        {k: v for k, v in tensors_only(i_cpu).items()
         if v.shape == (sub.size,)}, T3D_RTOL)
    del ions

    # ---- 3. the fixed-psi fan and single rays -------------------------------
    az0, _, els, azs, _ = trace3d._home_setup(*T3D_LINK, T3D_FAN["n_elev"],
                                              T3D_FAN["n_az"], 8.0, 5.0,
                                              75.0, None)
    fk = dict(step_km=T3D_FAN["step_km"], s_max_km=T3D_FAN["s_max_km"])
    fans = {}
    for dt in (torch.float64, torch.float32):
        tag = str(dt)[6:]
        fld = run(f"build_field_3d {tag}", lambda: prt.build_field_3d(
            *[T(a, dt) for a in vol], T3D_FAN_F0))
        fans[tag] = run(f"trace_rays_3d {tag}", lambda: prt.trace_rays_3d(
            fld, T3D_LINK[0], T3D_LINK[1], T(els, dt), T(azs, dt), **fk))
        del fld
    r64 = fans["float64"]["ground_range_km"].cpu()
    r32 = fans["float32"]["ground_range_km"].double().cpu()
    both = torch.isfinite(r64) & torch.isfinite(r32)
    summary["fan f32 vs f64"] = {
        "landing_differs": int((torch.isfinite(r64) != torch.isfinite(r32))
                               .sum()),
        "landed": int(torch.isfinite(r64).sum()),
        "median_rel_range": float(((r32 - r64).abs() / r64)[both].median())}
    print(f"    fan f32 vs f64: {summary['fan f32 vs f64']}", flush=True)
    check(summary["fan f32 vs f64"]["median_rel_range"] < 1e-3,
          "fan f32 vs f64: ranges part")
    fld_c = prt.build_field_3d(*[T(a, device=cpu) for a in vol], T3D_FAN_F0)
    f_cpu = run("trace_rays_3d float64", lambda: prt.trace_rays_3d(
        fld_c, T3D_LINK[0], T3D_LINK[1], T(els, device=cpu),
        T(azs, device=cpu), **fk), cpu)
    summary["fan card vs CPU"] = close_3d(
        "trace_rays_3d card vs CPU", tensors_only(fans["float64"]),
        tensors_only(f_cpu), T3D_RTOL)
    del fans, f_cpu
    fld = prt.build_field_3d(*[T(a) for a in vol], T3D_FAN_F0)
    ray = (T3D_LINK[0], T3D_LINK[1], 20.0, az0)
    one = run("trace_ray_3d", lambda: prt.trace_ray_3d(fld, *ray, **fk))
    one_c = run("trace_ray_3d", lambda: prt.trace_ray_3d(fld_c, *ray, **fk),
                cpu)
    check(one["status"] == one_c["status"] == "ground",
          f"trace_ray_3d status {one['status']} / {one_c['status']}")
    summary["trace_ray_3d card vs CPU"] = close_3d(
        "trace_ray_3d card vs CPU", tensors_only(one), tensors_only(one_c),
        T3D_RTOL)
    ak = dict(step_km=T3D_FAN["step_km"], rtol=1e-7, atol=1e-9,
              max_step_km=10.0)
    ad = run("trace_ray_3d adaptive", lambda: prt.trace_ray_3d(
        fld, *ray, s_max_km=T3D_FAN["s_max_km"], **ak))
    check(ad["status"] == "ground" and abs(
        float(ad["ground_range_km"]) / float(one["ground_range_km"]) - 1.0)
        < 3e-3, f"adaptive ray: {ad['status']}, range "
        f"{float(ad['ground_range_km'])} vs {float(one['ground_range_km'])}")
    ad_c = prt.trace_ray_3d(fld_c, *ray, s_max_km=T3D_FAN["s_max_km"], **ak)
    summary["adaptive ray card vs CPU (not held)"] = {
        k: float(abs(float(ad[k]) / float(ad_c[k]) - 1.0)) for k in
        ("ground_range_km", "group_path_km", "group_delay_sec")}
    print(f"    the whole adaptive ray, card vs CPU (relative): "
          f"{summary['adaptive ray card vs CPU (not held)']}", flush=True)
    arcs = [prt.trace_ray_3d(f, *ray, s_max_km=T3D_ADAPTIVE_ARC, **ak)
            for f in (fld, fld_c)]
    summary["adaptive arc card vs CPU"] = close_3d(
        "adaptive arc card vs CPU", *[tensors_only(a) for a in arcs],
        T3D_RTOL)
    print(f"    single rays: fixed {float(one['ground_range_km']):.4f} km, "
          f"adaptive {float(ad['ground_range_km']):.4f} km", flush=True)
    del fld, fld_c

    # ---- 4. the anisotropic tracers ----------------------------------------
    bv = run("igrf_volume", lambda: prt.igrf_volume(T3D_ALT, T3D_LAT, T3D_LON,
                                                     device=dev))
    afld = run("build_field_3d_aniso", lambda: prt.build_field_3d_aniso(
        T3D_ALT, T3D_LAT, T3D_LON, T(den), *bv))
    afld_c = prt.build_field_3d_aniso(T3D_ALT, T3D_LAT, T3D_LON,
                                      T(den, device=cpu),
                                      *[b.cpu() for b in bv])
    close_3d("aniso tables card vs CPU",
                 {str(i): t for i, t in enumerate(afld["tables"][3:])},
                 {str(i): t for i, t in enumerate(afld_c["tables"][3:])},
                 T3D_RTOL)
    # the fans at 4-km steps (the CPU side at 2 km would take minutes)
    a4 = dict(step_km=4.0, s_max_km=T3D_FAN["s_max_km"])
    for mode in ("O", "X"):
        a = run(f"trace_rays_3d_anisotropic {mode} 4 km",
                lambda: prt.trace_rays_3d_anisotropic(
                    afld, T3D_LINK[0], T3D_LINK[1], T(els), T(azs),
                    T3D_FAN_F0, mode=mode, **a4))
        landed = float(torch.isfinite(a["ground_range_km"]).float().mean())
        check(landed > 0.2, f"aniso fan {mode}: {landed} landed")
        print(f"    {mode}: landed share {landed:.3f}", flush=True)
        if mode == "O":
            a_card = a
    a_cpu = run("trace_rays_3d_anisotropic O 4 km",
                lambda: prt.trace_rays_3d_anisotropic(
                    afld_c, T3D_LINK[0], T3D_LINK[1], T(els, device=cpu),
                    T(azs, device=cpu), T3D_FAN_F0, **a4), cpu)
    summary["aniso fan card vs CPU"] = close_3d(
        "aniso fan card vs CPU", tensors_only(a_card), tensors_only(a_cpu),
        T3D_RTOL)
    if keep is not None:
        keep.update(vol=vol, els=els, azs=azs, afld=afld, aniso_O=a_card)
    del a_card, a_cpu
    print(f"3-D: synthesize_oblique_ionogram_3d_anisotropic, "
          f"F={ANISO_F0S.size} ({ANISO_F0S[0] / 1e6}-{ANISO_F0S[-1] / 1e6} "
          f"MHz), O, {({**T3D_FAN, **a4})}", flush=True)
    ai = run("aniso ionogram", lambda:
             prt.synthesize_oblique_ionogram_3d_anisotropic(
                 T(ANISO_F0S), *T3D_LINK, afld, **{**T3D_FAN, **a4}))
    summary[f"aniso ionogram {here}"]["link_muf_mhz"] = muf(ai, ANISO_F0S)
    hit = torch.isfinite(ai["delay_low_sec"]).cpu().numpy()
    check(hit.any() and not hit.all(),
          f"aniso ionogram: low rays at {hit.sum()} of {hit.size}")
    print(f"    link MUF {summary[f'aniso ionogram {here}']['link_muf_mhz']} MHz",
          flush=True)

    def grad_of(fld_args, s_max, device):
        ne = T(den, device=device).requires_grad_(True)
        f = prt.build_field_3d_aniso(T3D_ALT, T3D_LAT, T3D_LON, ne,
                                     *fld_args)
        r = prt.trace_ray_3d_anisotropic(f, *ray, T3D_FAN_F0, step_km=4.0,
                                         s_max_km=s_max, early_exit=True)
        g, = torch.autograd.grad(r["group_delay_sec"], ne)
        return g, r

    g, r = run("field-table gradient", lambda: grad_of(
        bv, T3D_FAN["s_max_km"], dev))
    check(r["status"] == "ground" and bool(torch.isfinite(g).all())
          and bool((g != 0).any()), f"gradient: {r['status']}, finite "
          f"{bool(torch.isfinite(g).all())}, nonzero {int((g != 0).sum())}")
    summary["gradient nonzero cells"] = int((g != 0).sum())
    g_cpu, _ = run("field-table gradient", lambda: grad_of(
        [b.cpu() for b in bv], T3D_FAN["s_max_km"], cpu), cpu)
    d = (g.cpu() - g_cpu).abs()
    worst = float((d / (T3D_GRAD_RTOL * g_cpu.abs()
                        + 1e-12 * g_cpu.abs().max())).max())
    summary["gradient card vs CPU (x tol)"] = worst
    print(f"    gradient: {summary['gradient nonzero cells']} nonzero cells, "
          f"|g| max {float(g.abs().max()):.4e}; card vs CPU "
          f"{worst:.3e} of the tolerance", flush=True)
    check(worst <= 1.0 and bool((g_cpu != 0).any()),
          "gradient card vs CPU over tolerance")
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"3-D phase: {summary['phase_s']:.1f} s; {card}", flush=True)
    return summary


def layout_text(lay):
    return (f"{'block' if lay.per_block else 'warp'} per pair, "
            f"{lay.warps} warps, {lay.n_groups} groups")


def sharded_vs_unsharded(name, out, ref, bitwise, tol):
    """Identical NaN masks; every finite value equal where ``bitwise``,
    else within ``tol`` km. Returns a summary dict."""
    a, b = out.double().cpu().numpy(), ref.double().cpu().numpy()
    check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
    mis = int((np.isnan(a) != np.isnan(b)).sum())
    m = np.isfinite(a) & np.isfinite(b)
    d = np.abs(a[m] - b[m])
    row = {"max_abs_km": float(d.max()) if d.size else 0.0,
           "differing": int((d != 0).sum()), "finite": int(m.sum()),
           "nan_mask_differences": mis, "rule": "bit for bit" if bitwise
           else f"<= {tol:g} km"}
    print(f"  {name}: {row}", flush=True)
    check(mis == 0 and m.sum() > 0.1 * m.size,
          f"{name}: {mis} NaN-mask differences, {int(m.sum())} finite")
    check(row["differing"] == 0 if bitwise else row["max_abs_km"] <= tol,
          f"{name}: {row}")
    return row


def mesh_phase(torch, prt, dev, card, glob, main_prof, t3d=None):
    """Mesh sharding on the card (phase 12): the meshes; the sweep kernel
    through ``synthesize_ionograms_sharded(engine="pallas")`` on a 4 x 2
    mesh of the card, f32, counters zeroed first and read after (8
    launches a call, no plain version), against the unsharded kernel (bit
    for bit where the two launch layouts match, else <= 1e-3 km), f64
    against plain f64 and the xla engine against the kernel, timed beside
    the unsharded call; the plain-torch sharded paths in f64 against their
    unsharded forms; the host-bound LM and 3-D fans on 2 shards. ``glob``
    is the global grid (den, bmag, bpsi, alt), ``main_prof`` the O-200
    profiles (den, bmag, bpsi); ``t3d`` the 3-D phase's ``keep`` (else the
    volume and the unsharded anisotropic fan are made here). Returns
    (summary, sweep launches in the counted run)."""
    from pyrayhf_tpu_torch import parallel as par
    from pyrayhf_tpu_torch import pallas_vh as pv
    from pyrayhf_tpu_torch import profiling

    summary = {"card": card}
    t_phase = time.perf_counter()
    gden, gbmag, gbpsi, alt = glob
    den, bmag, bpsi = main_prof

    def T(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        summary[f"{name} s"] = time.perf_counter() - t0
        print(f"  {name}: {summary[f'{name} s']:.3f} s", flush=True)
        return out

    # ---- the meshes ------------------------------------------------------
    m1 = par.ionogram_mesh()
    m42 = par.ionogram_mesh([dev] * 8, batch_axis=MESH_SHAPE[0])
    m2 = par.ionogram_mesh([dev] * 2)
    check(dict(m1.shape) == {"batch": torch.cuda.device_count(), "freq": 1}
          and dict(m42.shape) == dict(zip(("batch", "freq"), MESH_SHAPE))
          and dict(m2.shape) == {"batch": 2, "freq": 1},
          f"meshes {dict(m1.shape)} {dict(m42.shape)} {dict(m2.shape)}")
    print(f"mesh phase: ionogram_mesh() {dict(m1.shape)}, 8 x {dev} "
          f"{dict(m42.shape)}, 2 x {dev} {dict(m2.shape)}; {card}",
          flush=True)

    # ---- the sweep kernel per block, f32, counted -------------------------
    # (mode, profiles, points, the f64 check's profile stride); at
    # MESH_P_SPLIT points and B=1024 the whole call takes a warp per pair
    # and a shard a block per pair (launch_shape), so the two sum each pair
    # in another order
    cases = {"global O": (1.0, (gden, gbmag, gbpsi), P_MAIN, 16),
             "global X": (-1.0, (gden, gbmag, gbpsi), P_MAIN, 16),
             "X-20k": (-1.0, (den[:B_X20K], bmag[:B_X20K], bpsi[:B_X20K]),
                       P_X20K, 1),
             f"X-{MESH_P_SPLIT} B={den.shape[0]}": (
                 -1.0, (den, bmag, bpsi), MESH_P_SPLIT, 32)}
    ins = {k: [T(a, torch.float32) for a in (MESH_FREQS, *prof, alt)]
           for k, (_, prof, _, _) in cases.items()}
    nb, nf = MESH_SHAPE
    torch.cuda.synchronize()
    pv.reset_counters()
    sh = {}
    for name, (mm, _, P, _) in cases.items():
        n0 = pv.LAUNCHES["sweep"]
        sh[name] = par.synthesize_ionograms_sharded(
            *ins[name], m42, mode="O" if mm > 0 else "X", n_points=P,
            engine="pallas")
        check(pv.LAUNCHES["sweep"] == n0 + nb * nf,
              f"{name}: {pv.LAUNCHES['sweep'] - n0} sweep launches")
    torch.cuda.synchronize()
    launches, plain = dict(pv.LAUNCHES), dict(pv.PLAIN_CALLS)
    print(f"  sharded kernel path: launches {launches}, plain-version calls "
          f"{plain}", flush=True)
    check(launches["sweep"] == nb * nf * len(cases)
          and sum(launches.values()) == launches["sweep"]
          and sum(plain.values()) == 0,
          f"mesh kernel path: launches {launches}, plain {plain}")
    summary["launches"] = launches["sweep"]

    print(f"  sharded vs unsharded ionogram_pallas (f32): bit for bit where "
          f"the launch layouts match, else <= {TOL_F32_PLAIN:g} km", flush=True)
    timing = {}
    for name, (mm, prof, P, _) in cases.items():
        fr, d, bm, bp, a = ins[name]
        B, F = d.shape[0], fr.shape[0]
        un = pv.ionogram_pallas(fr, d, bm, bp, a, mode_mult=mm, n_points=P)
        args_u = pv.prepare_kernel_args("sweep", fr, d, bm, bp, a, mm, P,
                                        None)
        blocks = [pv.prepare_kernel_args(
            "sweep", fr[j * F // nf:(j + 1) * F // nf],
            *(t[i * B // nb:(i + 1) * B // nb] for t in (d, bm, bp)), a, mm,
            P, None) for i in range(nb) for j in range(nf)]
        lay_u, lay_s = pv.kernel_layout(args_u), pv.kernel_layout(blocks[0])
        match = (lay_u.per_block, lay_u.warps) == (lay_s.per_block,
                                                   lay_s.warps)
        print(f"  {name}, [{B}, {F}] at P={P}: unsharded "
              f"{layout_text(lay_u)}; shard [{B // nb}, {F // nf}] "
              f"{layout_text(lay_s)}", flush=True)
        row = sharded_vs_unsharded(f"{name} sharded vs unsharded", sh[name],
                                   un, match, TOL_F32_PLAIN)
        row.update(layout_unsharded=layout_text(lay_u),
                   layout_shard=layout_text(lay_s))
        mode = "O" if mm > 0 else "X"

        def sharded():
            return par.synthesize_ionograms_sharded(
                fr, d, bm, bp, a, m42, mode=mode, n_points=P,
                engine="pallas")

        def unsharded():
            return pv.ionogram_pallas(fr, d, bm, bp, a, mode_mult=mm,
                                      n_points=P)

        def shard_kernels():
            return [pv.launch_kernel(b) for b in blocks]

        row.update({
            "sharded_ms": profiling.time_launch(sharded,
                                                iters=TIMING_ITERS)[0],
            "unsharded_ms": profiling.time_launch(unsharded,
                                                  iters=TIMING_ITERS)[0],
            "kernel_ms": profiling.time_launch(pv.launch_kernel, args_u,
                                               iters=TIMING_ITERS)[0],
            "shard_kernels_ms": profiling.time_launch(
                shard_kernels, iters=TIMING_ITERS)[0]})
        print(f"    {name}: sharded call {row['sharded_ms']:.4f} ms, "
              f"unsharded call {row['unsharded_ms']:.4f} ms; kernel alone "
              f"{row['kernel_ms']:.4f} ms, the {nb * nf} shard kernels "
              f"{row['shard_kernels_ms']:.4f} ms (median of {TIMING_ITERS}, "
              f"CUDA events); {card}", flush=True)
        timing[name] = row
    summary["kernel path"] = timing

    print(f"  sharded f64 vs plain f64 (tol {TOL_F64:g} km; the global grid "
          f"on every 16th profile, X-{MESH_P_SPLIT} B=1024 on every 32nd)",
          flush=True)
    f64 = {}
    for name, (mm, prof, P, stride) in cases.items():
        t = [T(a) for a in (MESH_FREQS, *prof, alt)]
        out = par.synthesize_ionograms_sharded(
            *t, m42, mode="O" if mm > 0 else "X", n_points=P,
            engine="pallas")
        rows = slice(None, None, stride)
        ref = pv.ionogram_fast_xla(t[0], *(x[rows] for x in t[1:4]), t[4],
                                   mode_mult=mm, n_points=P)
        f64[name] = compare(f"{name} sharded f64 vs plain f64", out[rows],
                            ref, TOL_F64, degenerate_rows(
                                MESH_FREQS, prof[0][rows], prof[1][rows],
                                mm), True)
    summary["f64 vs plain f64 km"] = f64
    mi = [T(a, torch.float32) for a in (MESH_FREQS, den, bmag, bpsi, alt)]
    xla, pal = (par.synthesize_ionograms_sharded(*mi, m42, n_points=P_MAIN,
                                                 engine=e)
                for e in ("xla", "pallas"))
    summary["xla vs pallas km"] = compare(
        f"engine xla vs pallas, O-200 B={den.shape[0]} F={MESH_FREQS.size} "
        "f32", xla, pal, TOL_F32_PLAIN, np.zeros((1, 1), dtype=bool), True)

    # ---- plain-torch sharded paths, f64 ------------------------------------
    freqs = MESH_FREQS[:-1]
    hin = [T(a) for a in (freqs, den[0], bmag[0], bpsi[0], alt)]
    vh_sh = timed(f"vh_height_sharded P={MESH_VH_P}", lambda:
                  par.vh_height_sharded(*hin, m42, n_points=MESH_VH_P))
    vh_un = timed(f"vertical_forward_operator P={MESH_VH_P}", lambda:
                  prt.vertical_forward_operator(*hin, n_points=MESH_VH_P))
    summary["vh_height_sharded rel"] = close_rel(
        "vh_height_sharded vs vertical_forward_operator", vh_sh, vh_un,
        MESH_SUM_RTOL)

    lm = lm_day(prt)
    B = lm["obs"].shape[0]
    theta = {"hm": lm["truth"]["hm"] * 0.95,
             "bb": lm["truth"]["B_bot"] * 1.1, "nm": lm["truth"]["Nm"]}
    aux = {"alt": T(lm["alt"]), "bmag": T(lm["bmag"][0]),
           "bpsi": T(lm["bpsi"][0]), "E": GOLDEN["E"],
           "B_top": GOLDEN["F2"]["B_top"]}
    step, loss = timed(f"retrieval_step_sharded B={B}", lambda:
                       par.retrieval_step_sharded(
                           {k: T(v) for k, v in theta.items()}, T(lm["obs"]),
                           T(lm["freqs"]), aux, m42, lr=MESH_LR))
    ref_step, ref_loss = step_reference(torch, prt, {k: T(v) for k, v in
                                                     theta.items()},
                                        T(lm["obs"]), T(lm["freqs"]), aux,
                                        MESH_LR)
    summary["retrieval step rel"] = max(
        close_rel(f"retrieval step {k}", step[k], ref_step[k], MESH_SUM_RTOL)
        for k in ("hm", "bb", "nm"))
    close_rel("retrieval step loss", loss, ref_loss, MESH_SUM_RTOL)

    dden = -MESH_DOP_V * np.gradient(gden, alt, axis=1)
    dop = timed(f"doppler_batch_sharded B={gden.shape[0]}", lambda:
                par.doppler_batch_sharded(DOP_FREQS, T(gden), T(dden),
                                          T(gbmag), T(gbpsi), T(alt), m42))
    worst = 0.0
    for i in range(0, gden.shape[0], MESH_DOP_EVERY):
        one = prt.doppler_shift_vertical(DOP_FREQS, T(gden[i]), T(dden[i]),
                                         T(gbmag[i]), T(gbpsi[i]), T(alt))
        for k in ("doppler_hz", "phase_height_km"):
            worst = max(worst, close_rel(f"doppler profile {i} {k}",
                                         dop[k][i], one[k], MESH_SUM_RTOL,
                                         quiet=True))
    fd = dop["doppler_hz"]
    check(bool((fd[torch.isfinite(fd)] < 0).all()),
          "doppler: a reflected frequency is not red-shifted by the uplift")
    summary["doppler rel"] = worst
    print(f"  doppler_batch_sharded vs doppler_shift_vertical on every "
          f"{MESH_DOP_EVERY}th profile: largest relative difference "
          f"{worst:.3e} (rtol {MESH_SUM_RTOL:g})", flush=True)

    # ---- host-bound calls on 2 shards --------------------------------------
    n = MESH_LM_B
    guess = dict(GOLDEN["F2"], hm=lm["truth"]["hm"][:n] * 0.95,
                 B_bot=lm["truth"]["B_bot"][:n] * 1.1)
    lm_in = (T(lm["freqs"]), T(lm["obs"][:n]), T(lm["alt"]),
             T(lm["bmag"][:n]), T(lm["bpsi"][:n]))
    fit_s = timed(f"retrieve_gradient_batch_sharded B={n} on 2 shards",
                  lambda: par.retrieve_gradient_batch_sharded(
                      guess, LM_F1, GOLDEN["E"], *lm_in, m2,
                      steps=MESH_LM_STEPS))[2]
    fit_u = timed(f"retrieve_gradient_batch B={n}",
                  lambda: prt.retrieve_gradient_batch(
                      guess, LM_F1, GOLDEN["E"], *lm_in,
                      steps=MESH_LM_STEPS, chunk_size=None))[2]
    summary["LM rel"] = max(
        close_rel(f"LM {k}", torch.as_tensor(fit_s[k]),
                  torch.as_tensor(fit_u[k]), MESH_LM_RTOL)
        for k in ("hm", "B_bot"))

    if t3d is None:
        t3d = mesh_3d_inputs(torch, prt, dev)
    vol = [T(a) for a in t3d["vol"]]
    els, azs = T(t3d["els"]), T(t3d["azs"])
    fld = prt.build_field_3d(*vol, T3D_FAN_F0)
    launch = (T3D_LINK[0], T3D_LINK[1], els, azs)
    f_sh = timed("trace_fan_3d_sharded on 2 shards", lambda:
                 par.trace_fan_3d_sharded(fld, *launch, m2, **MESH_FAN))
    f_un = timed("trace_rays_3d", lambda: prt.trace_rays_3d(
        fld, *launch, **MESH_FAN))
    summary["fan rel"] = close_3d(
        "trace_fan_3d_sharded vs trace_rays_3d", tensors_only(f_sh),
        {k: v.cpu() for k, v in tensors_only(f_un).items()}, MESH_FAN_RTOL)
    del fld, f_sh, f_un
    a4 = dict(step_km=4.0, s_max_km=T3D_FAN["s_max_km"])
    a_sh = timed("trace_fan_3d_aniso_sharded O on 2 shards", lambda:
                 par.trace_fan_3d_aniso_sharded(
                     t3d["afld"], *launch, T3D_FAN_F0, m2, mode="O", **a4))
    a_un = t3d.get("aniso_O")
    if a_un is None:
        a_un = timed("trace_rays_3d_anisotropic O", lambda:
                     prt.trace_rays_3d_anisotropic(
                         t3d["afld"], *launch, T3D_FAN_F0, mode="O", **a4))
    summary["aniso fan rel"] = close_3d(
        "trace_fan_3d_aniso_sharded vs trace_rays_3d_anisotropic",
        tensors_only(a_sh), {k: v.cpu() for k, v in
                             tensors_only(a_un).items()}, T3D_RTOL)
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"mesh phase: {summary['phase_s']:.1f} s; {card}", flush=True)
    return summary, launches["sweep"]


def mesh_3d_inputs(torch, prt, dev):
    """The 3-D phase's volume, fan angles and anisotropic field with its
    unsharded O-mode fan left out (the mesh phase traces it), for a mesh
    phase run on its own."""
    from pyrayhf_tpu_torch import trace3d

    inp = prt.generate_input_3D(*T3D_DATE, T3D_LAT, T3D_LON, T3D_ALT,
                                T3D_F107, device=dev)
    vol = (T3D_ALT, T3D_LAT, T3D_LON, inp["den"], inp["bmag"], inp["bpsi"])
    _, _, els, azs, _ = trace3d._home_setup(*T3D_LINK, T3D_FAN["n_elev"],
                                            T3D_FAN["n_az"], 8.0, 5.0, 75.0,
                                            None)
    bv = prt.igrf_volume(T3D_ALT, T3D_LAT, T3D_LON, device=dev)
    den = torch.as_tensor(inp["den"], dtype=torch.float64, device=dev)
    afld = prt.build_field_3d_aniso(T3D_ALT, T3D_LAT, T3D_LON, den, *bv)
    return {"vol": vol, "els": els, "azs": azs, "afld": afld}


def close_rel(name, out, ref, rtol, quiet=False):
    """Identical NaN masks, finite values within ``rtol``; returns the
    largest relative difference."""
    a = out.double().cpu().numpy()
    b = ref.double().cpu().numpy()
    check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
    check(np.array_equal(np.isnan(a), np.isnan(b)),
          f"{name}: NaN masks differ")
    m = np.isfinite(b)
    check(m.any(), f"{name}: no finite value")
    rel = float((np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                                    1e-300)).max())
    if not quiet:
        print(f"  {name}: largest relative difference {rel:.3e} (rtol "
              f"{rtol:g})", flush=True)
    check(rel <= rtol, f"{name}: relative difference {rel} over {rtol}")
    return rel


def step_reference(torch, prt, theta, obs, freq, aux, lr, n_points=64):
    """The unsharded retrieval step: theta - lr * the gradient of the
    whole batch's loss (the sharded step's model, one batch, autograd)."""
    th = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    hm, bb, nm = (th[k][:, None] for k in ("hm", "bb", "nm"))
    E = aux["E"]
    NmF1, _, hmF1, _ = prt.derive_dependent_F1_parameters(0.8, nm, hm, bb,
                                                          E["hm"])
    EDP = prt.reconstruct_density_1level(
        {"Nm": nm, "hm": hm, "B_bot": bb, "B_top": aux["B_top"]},
        {"Nm": NmF1, "hm": hmF1}, E, aux["alt"])
    B = obs.shape[0]
    vh, valid = prt.vh_and_mask(freq, EDP, aux["bmag"].expand(B, -1),
                                aux["bpsi"].expand(B, -1), aux["alt"],
                                mode_mult=1.0, n_points=n_points)
    r = torch.where(valid & torch.isfinite(obs), obs - vh, 0.0)
    loss = torch.sum(r * r)
    grads = torch.autograd.grad(loss, [th[k] for k in ("hm", "bb", "nm")])
    return ({k: (th[k] - lr * g).detach()
             for k, g in zip(("hm", "bb", "nm"), grads)}, loss.detach())


def ad_phase(torch, prt, dev, card, freqs, alt, main_prof, glob, x20k):
    """Differentiation through the kernel entry points (phase 13).

    Counters zeroed before each part and read after it: ``torch.func.jvp``
    of ``vertical_forward_operator_batch(engine="auto")`` at O-200 B=1024,
    O and X, f32 and f64 (kernels 1 and 2 launched, no plain call): the
    primal equal to the call without AD bit for bit, the tangent to
    ``torch.func.jvp`` of the plain sweep on the first AD_REF_B profiles;
    ``jacfwd`` and ``jacrev`` through kernels 1-5 in three parameters,
    f64, each against the plain sweep's, and against each other where both
    are finite; ``torch.func.vmap`` of the gather entry over the global
    grid cut 4 x 2,628 (one launch, equal to the whole call bit for bit);
    the parity engine on the global grid with every 8th profile's |B| = 0
    (rows equal to their profile alone, f64 equal to ``auto`` above 2 MHz);
    ``jacfwd`` of ``jacfwd`` through kernels 1-5 (f64; one launch each for
    the primal, no plain version; against the plain sweep's), with ``jvp``
    of ``jvp`` keeping the kernel's primal bit for bit;
    ``torch.func.vmap`` of the fan kernel over two field stacks (one
    launch, bit for bit two separate launches, f32 and f64); the fan kernel
    under forward mode, which must raise. Returns (summary, launches by
    kernel over the counted parts, ``fan_2d`` among them).
    """
    from pyrayhf_tpu_torch import pallas_vh as pv

    t_phase = time.perf_counter()
    rng = np.random.default_rng(AD_SEED)
    den, bmag, bpsi = main_prof
    gden, gbmag, gbpsi = glob
    vfo = prt.vertical_forward_operator_batch
    summary, launches = {}, dict.fromkeys(pv.KERNELS, 0)

    def T(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def counted(what, fn):
        """``fn()`` with the counters zeroed before and read after; returns
        (its output, the launches, its wall time in ms)."""
        torch.cuda.synchronize()
        pv.reset_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got, plain = dict(pv.LAUNCHES), dict(pv.PLAIN_CALLS)
        for k in launches:
            launches[k] += got[k]
        print(f"  {what}: kernel launches {got}; plain-version calls "
              f"{plain}", flush=True)
        check(sum(plain.values()) == 0, f"{what}: plain versions ran")
        check_table_launches(got, what)
        return out, got, ms

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # ---- jvp of the auto operator at the main path's width ----------------
    print(f"AD phase: torch.func.jvp of vertical_forward_operator_batch(auto)"
          f" at O-200 B={den.shape[0]} F={len(freqs)}, along a seeded (den, "
          f"|B|, psi) direction; tangents against torch.func.jvp of the "
          f"plain sweep on {AD_REF_B} profiles (rtol {AD_RTOL})", flush=True)
    dirs = (den * rng.uniform(-1.0, 1.0, den.shape),
            bmag * rng.uniform(-0.2, 0.2, bmag.shape),
            rng.uniform(-3.0, 3.0, bpsi.shape))
    jvp_ms = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        fr, d, b, p, a = (T(x, dtype) for x in (freqs, den, bmag, bpsi, alt))
        tans = tuple(T(x, dtype) for x in dirs)
        for mode, mm in (("O", 1.0), ("X", -1.0)):
            def op(dd, bb, pp):
                return vfo(fr, dd, bb, pp, a, mode=mode, n_points=P_MAIN)
            kind = "gather_osolve" if mm > 0 else "gather_xsolve"
            plain_out, fwd_ms = timed(lambda: op(d, b, p))
            (primal, tangent), got, t_ms = counted(
                f"jvp auto {mode} {dname}",
                lambda: torch.func.jvp(op, (d, b, p), tans))
            check(got[kind] == 1 and kernel_launches(got) == 1,
                  f"jvp auto {mode} {dname}: launches {got}")
            check(torch.equal(torch.nan_to_num(primal, nan=-1.0),
                              torch.nan_to_num(plain_out, nan=-1.0)),
                  f"jvp auto {mode} {dname}: primal differs from the call "
                  "without AD")
            sl = slice(0, AD_REF_B)
            _, ref = torch.func.jvp(
                lambda dd, bb, pp: pv.ionogram_fast_xla(
                    fr, dd, bb, pp, a, mode_mult=mm, n_points=P_MAIN),
                (d[sl], b[sl], p[sl]), tuple(x[sl] for x in tans))
            rel = close_rel(f"jvp auto {mode} {dname}: tangent vs the plain "
                            f"sweep's, first {AD_REF_B} profiles",
                            tangent[sl], ref, AD_RTOL[dname])
            check(bool(torch.isfinite(tangent).any()),
                  f"jvp auto {mode} {dname}: no finite tangent")
            jvp_ms[f"{mode} {dname}"] = {"forward_ms": fwd_ms,
                                        "jvp_ms": t_ms, "tangent_rel": rel}
            print(f"  jvp auto {mode} {dname}: forward alone "
                  f"{fwd_ms:.3f} ms, jvp {t_ms:.3f} ms; {card}", flush=True)
            del primal, tangent, ref, plain_out
    summary["jvp"] = jvp_ms
    spans = {"jvp_s": time.perf_counter() - t_phase}
    torch.cuda.empty_cache()

    # ---- jacfwd against jacrev through kernels 1-5 --------------------------
    print(f"AD phase: jacfwd and jacrev in (density scale, |B| scale, psi "
          f"offset), f64, through kernels 1-5 ({AD_JAC_B} profiles at "
          f"O/X-200; kernel 4 at X-20k on {AD_X20K_B} profiles, every "
          f"{AD_X20K_F_EVERY}th frequency), each against the plain sweep's "
          f"(rtol {AD_JAC_RTOL})", flush=True)
    f64 = torch.float64
    jb = slice(0, AD_JAC_B)
    small = [T(x, f64) for x in (freqs, den[jb], bmag[jb], bpsi[jb], alt)]
    xden, xbmag, xbpsi = x20k
    xf = freqs[::AD_X20K_F_EVERY]
    xs = slice(0, AD_X20K_B)
    x_in = [T(x, f64) for x in (xf, xden[xs], xbmag[xs], xbpsi[xs], alt)]
    cases = {
        "gather_osolve": (prt.ionogram_pallas_gather, 1.0, small, P_MAIN, {}),
        "gather_xsolve": (prt.ionogram_pallas_gather, -1.0, small, P_MAIN,
                          {}),
        "gather": (prt.ionogram_pallas_gather, -1.0, small, P_MAIN,
                   {"x_in_kernel_solve": False}),
        "sweep": (prt.ionogram_pallas, -1.0, x_in, P_X20K, {}),
        "mxu": (prt.ionogram_pallas_mxu, 1.0, small, P_MAIN, {}),
    }
    p0 = torch.tensor([1.0, 1.0, 0.0], dtype=f64, device=dev)

    def scalar(fn, mm, t, P, kw):
        """The sum of finite virtual heights of q = (density scale, |B|
        scale, psi offset)."""
        def f(q):
            vh = fn(t[0], q[0] * t[1], q[1] * t[2], t[3] + q[2], t[4],
                    mode_mult=mm, n_points=P, **kw)
            return torch.where(torch.isfinite(vh), vh, 0.0).sum()
        return f

    jac, refs = {}, {}
    for kind, (entry, mm, t, P, kw) in cases.items():
        f_k = scalar(entry, mm, t, P, kw)
        _, fwd_ms = timed(lambda: f_k(p0))
        fwd, got_f, jf_ms = counted(f"jacfwd through {kind}",
                                    lambda: torch.func.jacfwd(f_k)(p0))
        rev, got_r, jr_ms = counted(f"jacrev through {kind}",
                                    lambda: torch.func.jacrev(f_k)(p0))
        for got in (got_f, got_r):
            check(got[kind] == 1 and kernel_launches(got) == 1,
                  f"jacfwd/jacrev {kind}: launches {got}")
        # kernels 1 and 5, and 2 and 3, share their inputs, and so the
        # sweep's derivatives they are held to
        key = (mm, id(t), P)
        if key not in refs:
            f_ref = scalar(pv.ionogram_fast_xla, mm, t, P, {})
            refs[key] = (torch.func.jacfwd(f_ref)(p0),
                         torch.func.jacrev(f_ref)(p0))
        r_fwd, r_rev = refs[key]
        e_fwd = close_rel(f"{kind} jacfwd vs the sweep's", fwd, r_fwd,
                          AD_JAC_RTOL)
        e_rev = close_rel(f"{kind} jacrev vs the sweep's", rev, r_rev,
                          AD_JAC_RTOL)
        both = torch.isfinite(fwd) & torch.isfinite(rev)
        e_fr = close_rel(f"{kind} jacfwd vs jacrev where both are finite",
                         fwd[both], rev[both], AD_JAC_RTOL)
        n_nan = int((~torch.isfinite(rev)).sum())
        check(bool(torch.isfinite(fwd).all()) and (mm < 0 or n_nan == 0),
              f"{kind}: jacfwd {fwd.tolist()}, jacrev {rev.tolist()}")
        jac[kind] = {"jacfwd": fwd.tolist(), "jacrev": rev.tolist(),
                     "vs_sweep_fwd": e_fwd, "vs_sweep_rev": e_rev,
                     "fwd_vs_rev": e_fr, "jacrev_nan": n_nan,
                     "forward_ms": fwd_ms, "jacfwd_ms": jf_ms,
                     "jacrev_ms": jr_ms}
        print(f"  {kind}: jacfwd {fwd.tolist()}, jacrev {rev.tolist()} "
              f"({n_nan} NaN: X-mode reverse mode w.r.t. |B| and psi is "
              f"NaN in both packages); forward alone {fwd_ms:.3f} ms, "
              f"jacfwd {jf_ms:.3f} ms, jacrev {jr_ms:.3f} ms; {card}",
              flush=True)
    del refs
    summary["jac"] = jac
    spans["jac_s"] = time.perf_counter() - t_phase - sum(spans.values())
    torch.cuda.empty_cache()

    # ---- jacfwd of jacfwd through kernels 1-5 -------------------------------
    hf = freqs[np.linspace(0, len(freqs) - 1, AD_HESS_F).round().astype(int)]
    nodes = slice(None, None, AD_HESS_NODE_EVERY)
    h_alt = alt[nodes]
    print(f"AD phase: jacfwd of jacfwd in (density scale, |B| scale), f64, "
          f"through kernels 1-5 ({AD_HESS_B} profiles x {AD_HESS_F} "
          f"frequencies at O/X-{P_MAIN}; kernel 4 at X-20k on 1 profile x "
          f"{AD_HESS_X20K_F} frequencies; {len(h_alt)} nodes, every "
          f"{AD_HESS_NODE_EVERY}th), each against the plain sweep's (rtol "
          f"{AD_HESS_RTOL}); jvp of jvp keeps the kernel's primal bit for "
          "bit", flush=True)
    hb = slice(0, AD_HESS_B)
    h_small = [T(x, f64) for x in (hf, den[hb, nodes], bmag[hb, nodes],
                                   bpsi[hb, nodes], h_alt)]
    h_x = [T(x, f64) for x in (hf[::AD_HESS_F // AD_HESS_X20K_F],
                               xden[:1, nodes], xbmag[:1, nodes],
                               xbpsi[:1, nodes], h_alt)]
    h_cases = {
        "gather_osolve": (prt.ionogram_pallas_gather, 1.0, h_small, P_MAIN,
                          {}),
        "gather_xsolve": (prt.ionogram_pallas_gather, -1.0, h_small, P_MAIN,
                          {}),
        "gather": (prt.ionogram_pallas_gather, -1.0, h_small, P_MAIN,
                   {"x_in_kernel_solve": False}),
        "sweep": (prt.ionogram_pallas, -1.0, h_x, P_X20K, {}),
        "mxu": (prt.ionogram_pallas_mxu, 1.0, h_small, P_MAIN, {}),
    }
    q0 = torch.ones(2, dtype=f64, device=dev)

    def of_q(fn, mm, t, P, kw):
        """The ionogram of q = (density scale, |B| scale)."""
        def f(q):
            return fn(t[0], q[0] * t[1], q[1] * t[2], t[3], t[4],
                      mode_mult=mm, n_points=P, **kw)
        return f

    def hessian(f):
        return torch.func.jacfwd(torch.func.jacfwd(f))(q0)

    hess, refs = {}, {}
    for kind, (entry, mm, t, P, kw) in h_cases.items():
        f_k = of_q(entry, mm, t, P, kw)
        alone, fwd_ms = timed(lambda: f_k(q0))
        h, got_h, h_ms = counted(f"jacfwd of jacfwd through {kind}",
                                 lambda: hessian(f_k))
        primal, got_p, jj_ms = counted(
            f"jvp of jvp through {kind}",
            lambda: torch.func.jvp(
                lambda q: torch.func.jvp(f_k, (q,), (q0,))[0], (q0,),
                (q0,))[0])
        for what, got in (("jacfwd of jacfwd", got_h), ("jvp of jvp", got_p)):
            check(got[kind] == 1 and kernel_launches(got) == 1,
                  f"{what} {kind}: launches {got}")
        same = torch.equal(torch.nan_to_num(primal, nan=-1.0),
                           torch.nan_to_num(alone, nan=-1.0))
        check(same, f"jvp of jvp {kind}: primal differs from the call "
              "without AD")
        key = (mm, id(t), P)
        if key not in refs:
            refs[key] = hessian(of_q(pv.ionogram_fast_xla, mm, t, P, {}))
        err = close_rel(f"{kind} jacfwd of jacfwd {tuple(h.shape)} vs the "
                        "sweep's", h, refs[key], AD_HESS_RTOL)
        n_fin = int(torch.isfinite(h).sum())
        check(n_fin > 0, f"{kind}: no finite second derivative")
        hess[kind] = {"shape": list(h.shape), "finite": n_fin,
                      "vs_sweep": err, "primal_bitwise": same,
                      "forward_ms": fwd_ms, "jacfwd_jacfwd_ms": h_ms,
                      "jvp_jvp_ms": jj_ms}
        print(f"  {kind}: {n_fin} finite second derivatives of "
              f"{h.numel()}; forward alone {fwd_ms:.3f} ms, jacfwd of "
              f"jacfwd {h_ms:.3f} ms, jvp of jvp {jj_ms:.3f} ms; {card}",
              flush=True)
    del refs
    summary["jacfwd_jacfwd"] = hess
    spans["hess_s"] = time.perf_counter() - t_phase - sum(spans.values())
    torch.cuda.empty_cache()

    # ---- vmap of the gather entry over the global grid ----------------------
    n_glob = gden.shape[0]
    gi = [T(x, torch.float32) for x in (freqs, gden, gbmag, gbpsi, alt)]
    V = 4
    whole = prt.ionogram_pallas_gather(*gi, mode_mult=1.0, n_points=P_MAIN)
    cut = [x.reshape(V, n_glob // V, -1) for x in gi[1:4]]
    folded, got, _ = counted(
        f"vmap of ionogram_pallas_gather over {V} x {n_glob // V}",
        lambda: torch.func.vmap(lambda d, b, p: prt.ionogram_pallas_gather(
            gi[0], d, b, p, gi[4], mode_mult=1.0, n_points=P_MAIN))(*cut))
    check(got["gather_osolve"] == 1 and kernel_launches(got) == 1,
          f"vmap fold: launches {got}")
    same = torch.equal(torch.nan_to_num(folded.reshape(n_glob, -1),
                                        nan=-1.0),
                       torch.nan_to_num(whole, nan=-1.0))
    print(f"  vmap fold {tuple(folded.shape)}: equal to the whole call bit "
          f"for bit: {same}", flush=True)
    check(same, "vmap fold differs from the whole call")
    summary["vmap_fold_bitwise"] = same
    del whole, folded, cut, gi
    spans["vmap_s"] = time.perf_counter() - t_phase - sum(spans.values())

    # ---- the parity engine on a grid with field-free profiles ---------------
    zb = np.asarray(gbmag).copy()
    zb[::AD_B0_EVERY] = 0.0
    print(f"AD phase: parity engine on the global grid with every "
          f"{AD_B0_EVERY}th profile's |B| = 0, f64, in chunks of "
          f"{AD_PARITY_CHUNK}: rows {AD_ALONE_ROWS} against their profile "
          f"alone, the grid against auto at every frequency (tol "
          f"{TOL_F64:g} km, identical NaN masks)", flush=True)
    pin = [T(x, f64) for x in (freqs, gden, zb, gbpsi, alt)]
    par_rows = {}
    for mode, mm in (("O", 1.0), ("X", -1.0)):
        parts = [vfo(pin[0], *(x[c:c + AD_PARITY_CHUNK] for x in pin[1:4]),
                     pin[4], mode=mode, n_points=P_MAIN, engine="parity")
                 for c in range(0, n_glob, AD_PARITY_CHUNK)]
        par = torch.cat(parts)
        worst = 0.0
        for r in AD_ALONE_ROWS:
            alone = vfo(pin[0], *(x[r:r + 1] for x in pin[1:4]), pin[4],
                        mode=mode, n_points=P_MAIN, engine="parity")
            worst = max(worst, close_rel(f"parity {mode} row {r} vs alone",
                                         par[r:r + 1], alone, 1e-12,
                                         quiet=True))
        fin0 = float(torch.isfinite(par[::AD_B0_EVERY]).double().mean())
        check(fin0 > 0.15, f"parity {mode}: field-free rows {fin0} finite")
        auto = vfo(*pin, mode=mode, n_points=P_MAIN)
        excused = np.zeros((n_glob, freqs.size), dtype=bool)
        for r, f in AD_PARITY_EXCUSED[mode]:
            excused[r, int(np.argmin(np.abs(freqs - f)))] = True
        err = compare(f"parity {mode} vs auto (f64, every frequency)", par,
                      auto, AD_PARITY_EXCUSED_TOL,
                      np.zeros((1, 1), dtype=bool), True)
        over = over_tol(par, auto, TOL_F64)
        print(f"  parity {mode} vs auto: {int(over.sum())} values over "
              f"{TOL_F64:g} km, at {[tuple(x) for x in np.argwhere(over)]}"
              f" (allowed: {AD_PARITY_EXCUSED[mode]})", flush=True)
        check(not (over & ~excused).any(),
              f"parity {mode} vs auto: values over {TOL_F64} km outside "
              "the JAX package's own")
        par_rows[mode] = {"rows_vs_alone_rel": worst,
                          "field_free_finite": fin0, "vs_auto_km": err}
        print(f"  parity {mode}: rows vs alone {worst:.3e}, field-free rows "
              f"finite {fin0:.3f}", flush=True)
        del parts, par, auto
    summary["parity_field_free"] = par_rows
    del pin
    torch.cuda.empty_cache()
    spans["parity_s"] = time.perf_counter() - t_phase - sum(spans.values())

    # ---- vmap of the fan kernel over field stacks ---------------------------
    from pyrayhf_tpu_torch import oblique, pallas_ray as pr
    from pyrayhf_tpu_torch import profiling
    fz, fx, ne, babs, fpsi, nu = fan_scene("typical")
    f0s = np.linspace(4e6, 30e6, AD_FAN_F)
    n_steps = int(round(FAN_SMAX / FAN_STEP))
    print(f"AD phase: torch.func.vmap of fan_2d_pallas over 2 field stacks "
          f"(the typical {len(fz)} x {len(fx)} slice, its layer and "
          f"{AD_FAN_DENSER}x denser), F={AD_FAN_F} x E={AD_FAN_E} x "
          f"{n_steps} steps: one launch, bit for bit two separate launches",
          flush=True)
    fan_vmap = {}
    for dtype in (torch.float32, f64):
        dname = str(dtype).split(".")[-1]
        fields = [oblique._fan_fields(T(f0s, dtype), T(ne * s, dtype),
                                      T(babs, dtype), T(fpsi, dtype),
                                      T(nu, dtype), "O")
                  for s in (1.0, AD_FAN_DENSER)]
        stack = [torch.stack(fs) for fs in zip(*fields)]
        elevs = torch.linspace(5.0, 85.0, AD_FAN_E, dtype=dtype, device=dev)

        def fan(mu, mup, kap):
            return pr.fan_2d_pallas(fz, fx, mu, mup, kap, elevs, FAN_STEP,
                                    n_steps=n_steps)

        def folded():
            return torch.func.vmap(fan)(*stack)

        def separate():
            return [fan(*f) for f in fields]
        torch.cuda.synchronize()
        pr.reset_counters()
        out = folded()
        torch.cuda.synchronize()
        got = dict(pr.LAUNCHES)
        print(f"  fan vmap {dname}: fan launches {got}, plain-version calls "
              f"{dict(pr.PLAIN_CALLS)}", flush=True)
        check(got["fan_2d"] == 1 and pr.PLAIN_CALLS["fan_2d"] == 0,
              f"fan vmap {dname}: launches {got}")
        launches["fan_2d"] = launches.get("fan_2d", 0) + got["fan_2d"]
        each = separate()
        same = all(torch.equal(torch.nan_to_num(out[k][v], nan=-7.0),
                               torch.nan_to_num(each[v][k], nan=-7.0))
                   for k in pr.OUTPUTS for v in range(2))
        landed = float(torch.isfinite(out["ground_range_km"]).double().mean())
        check(same, f"fan vmap {dname}: the fold differs from two launches")
        check(0.0 < landed < 1.0, f"fan vmap {dname}: landed {landed}")
        fold_ms, _ = profiling.time_launch(folded, iters=5, warmup=1)
        sep_ms, _ = profiling.time_launch(separate, iters=5, warmup=1)
        fan_vmap[dname] = {"bitwise": same, "landed": landed,
                           "fold_ms": fold_ms, "separate_ms": sep_ms}
        print(f"  fan vmap {dname}: equal to two launches bit for bit: "
              f"{same}; landed {landed:.3f}; the fold {fold_ms:.3f} ms, two "
              f"separate calls {sep_ms:.3f} ms (CUDA events, median of 5, "
              f"each with its table packing); {card}", flush=True)
        del fields, stack, out, each
    summary["fan_vmap"] = fan_vmap
    spans["fan_vmap_s"] = time.perf_counter() - t_phase - sum(spans.values())

    # ---- the fan kernel refuses forward mode ---------------------------------
    z, x = np.linspace(0.0, 400.0, 41), np.linspace(0.0, 1000.0, 11)
    mu = torch.full((2, 41, 11), 0.9, dtype=f64, device=dev)
    fan_args = (torch.full_like(mu, 1.1), torch.zeros_like(mu),
                torch.tensor([10.0, 30.0], dtype=f64, device=dev), 10.0)

    def fan(m):
        return prt.fan_2d_pallas(z, x, m, *fan_args,
                                 n_steps=5)["ground_range_km"]
    refused = []
    for how, call in (
            ("torch.func.jvp", lambda: torch.func.jvp(
                fan, (mu,), (torch.ones_like(mu),))),
            ("forward_ad", lambda: forward_ad_call(torch, fan, mu)),
            ("vmap of torch.func.jvp", lambda: torch.func.vmap(
                lambda m: torch.func.jvp(fan, (m,), (torch.ones_like(m),)))(
                    mu[None]))):
        try:
            call()
        except ValueError as e:
            refused.append(how)
            print(f"  fan_2d_pallas under {how}: raised ({e})", flush=True)
    check(refused == ["torch.func.jvp", "forward_ad",
                      "vmap of torch.func.jvp"],
          f"fan_2d_pallas under forward mode did not raise: {refused}")
    summary["phase_s"] = time.perf_counter() - t_phase
    summary["parts_s"] = spans
    spent = ", ".join(f"{k} {v:.1f}" for k, v in spans.items())
    print(f"AD phase: {summary['phase_s']:.1f} s ({spent}); {card}",
          flush=True)
    return summary, launches


def forward_ad_call(torch, fn, x):
    """``fn`` of a forward-mode dual of ``x`` (a ones tangent)."""
    fwad = torch.autograd.forward_ad
    with fwad.dual_level():
        return fn(fwad.make_dual(x, torch.ones_like(x)))


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
            if "registers" in ln or "spill" in ln]
    print(f"build: {so.name}: nvcc {compile_s:.2f} s, build+load "
          f"{time.perf_counter() - t0:.2f} s; ptxas: "
          f"{'; '.join(sorted(set(regs)))}", flush=True)
    from tools.cuda_sass import resource_usage, sass_loops
    print("registers and stack per kernel (cuobjdump --dump-resource-usage): "
          + "; ".join(f"{name}: {use}" for name, use in resource_usage()),
          flush=True)
    sass = sass_loops()

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
    check(all(launches[k] > 0 for k in REPO_KERNELS)
          and launches["mxu"] == 0,
          f"a kernel of the path never launched: {launches}")
    check(sum(plain.values()) == 0, f"plain versions ran: {plain}")
    check_table_launches(launches, "main path")
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
    check(all(pv.LAUNCHES[k] > 0 for k in REPO_KERNELS)
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

    # every frequency, the sub-gyro X pairs below the largest gyrofrequency
    # (1.8 MHz; the cutoff exceeded at the first node) included: the
    # kernels give there what the parity operator gives, alt_min or NaN
    # (tests/test_torch_pallas_vh.py)
    print("reference: kernel path vs parity operator (f64, every "
          "frequency)", flush=True)
    sm = [T(a, torch.float64) for a in (freqs, den[:8], bmag[:8], bpsi[:8],
                                        alt)]
    for mode, mm in (("O", 1.0), ("X", -1.0)):
        first = degenerate_rows(freqs, den[:8], bmag[:8], mm)
        check(mode == "O" or first.any(),
              f"auto vs parity {mode}: no first-exceedance pair")
        compare(f"auto vs parity {mode} ({int(first.sum())} first-node "
                "pairs)", vfo(*sm, mode=mode),
                vfo(*sm, mode=mode, engine="parity"), TOL_F64,
                np.zeros_like(first), True)

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

    # kernel 2 at the cutoffs: frequencies on each razor profile's node
    # cutoffs fx_j and prefix maxima cfx_j times (1 +- n ulp), where the
    # cutoff-frequency bracket and the exact test meet
    print(f"kernel 2 at cutoffs (fx_j, cfx_j x (1 +- n ulp), n <= "
          f"{RAZOR_ULPS}, {RAZOR_NODES} nodes of each of the razor "
          f"profiles) vs plain: f64 identical NaN masks, <= {TOL_F64:g} km; "
          f"f32 identical NaN masks, <= {TOL_F32_PLAIN:g} km or 4 ulps of "
          f"vh above ~2,000 km", flush=True)
    rprof = razor_profiles(alt, den, bmag, bpsi)
    razor_err = []
    for P in (P_MAIN, 2000):
        for dtype in (torch.float64, torch.float32):
            a = razor_args(torch, pv, rprof, alt, P, dtype, dev)
            k, ref = pv.launch_kernel(a), pv.plain_ionogram(a)
            kn, rn = k.double().cpu().numpy(), ref.double().cpu().numpy()
            tol = (TOL_F64 if dtype == torch.float64
                   else razor_tol_f32(ref))
            mis = int((np.isnan(kn) != np.isnan(rn)).sum())
            m = np.isfinite(kn) & np.isfinite(rn)
            d = np.abs(np.where(m, kn - rn, 0.0))
            over = int((d > tol).sum())
            lay = pv.kernel_layout(a)
            print(f"  razor P={P} {str(dtype)[6:]} F={a.freq_hz.shape[0]} "
                  f"({'block' if lay.per_block else 'warp'} per pair): "
                  f"max|dvh| {d.max():.3e} km, {int(m.sum())} values, "
                  f"{over} over tol, NaN-mask differences {mis}", flush=True)
            check(mis == 0 and over == 0 and m.sum() > 0,
                  f"razor P={P} {dtype}: {mis} NaN-mask differences, "
                  f"{over} over tol")
            if dtype == torch.float64:
                razor_err.append(float(d.max()))

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
        n0 = kernel_launches(pv.LAUNCHES)
        with torch.no_grad():
            vp, vm = (fn(g_in[0], g_in[1] + s * FD_STEP * u_dir, *g_in[2:],
                         mode_mult=mm, n_points=P_MAIN) for s in (1.0, -1.0))
        check(kernel_launches(pv.LAUNCHES) == n0 + 2,
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
          f"launches, CUDA events; card: {card}", flush=True)
    timing = {}

    def time_kind(kind, mm, inp, P, label, plain_iters=TIMING_ITERS):
        fr, td, tb, tpsi, ta = inp
        kinv = None if kind == "sweep" else pv.uniform_inv_dalt(ta)
        a = pv.prepare_kernel_args(kind, *inp, mm, P, kinv)
        B, F = td.shape[0], fr.shape[0]
        dname = str(td.dtype).split(".")[-1]
        k_ms, _ = profiling.time_launch(pv.launch_kernel, a,
                                        iters=TIMING_ITERS)
        if kind == "sweep":
            def plain():
                return pv.ionogram_fast_xla(*inp, mode_mult=mm, n_points=P)
        else:
            def plain():
                return pv.plain_ionogram(a)
        p_ms, _ = profiling.time_launch(plain, iters=plain_iters,
                                        warmup=min(3, plain_iters))
        if kind == "sweep":
            def wrapper():
                return prt.ionogram_pallas(*inp, mode_mult=mm, n_points=P)
        else:
            def wrapper():
                return prt.ionogram_pallas_gather(
                    *inp, mode_mult=mm, n_points=P,
                    x_in_kernel_solve=(kind != "gather"))
        w_ms, _ = profiling.time_launch(wrapper, iters=TIMING_ITERS)
        N = a.n_alt
        item = a.tab.element_size()
        # the pairs the solve marks valid: the host solve's, or the
        # in-kernel solve's plain version on the same table
        if kind == "gather_osolve":
            valid = pv._osolve_plain(a)[3]
        elif kind == "gather_xsolve":
            valid = pv._xsolve_plain(a)[3]
        else:
            valid = a.valid != 0
        n_valid = int(valid.sum())
        ops = (n_valid * P * ION_OPS_POINT[kind]
               + B * F * N * ION_OPS_NODE[kind])
        nbytes = item * (a.tab.numel() + F + 3 * P + 1 + B * F)
        if kind in ("gather", "sweep"):      # the host solve's [B, F] rows
            nbytes += (3 * item + 1) * B * F
        b_ms, b_by = bound_ms(ops, nbytes, dname)
        clock = sm_clock_under(torch, lambda: pv.launch_kernel(a))
        i_ms, i_long, i_counts = issue_bound_ms(torch, pv, kind, a, valid,
                                                clock, sass)
        lay = pv.kernel_layout(a)
        layout = (f"{'block' if lay.per_block else 'warp'} per pair, "
                  f"{lay.warps} warps, {lay.n_groups} groups")
        # blocks an SM holds (the occupancy calculator), kernel_layout's input
        bps = pv.blocks_per_sm(td.device.index, int(item == 8),
                               1 if mm > 0 else -1,
                               kind in ("gather_osolve", "gather_xsolve"),
                               kinv is not None, a.tab.shape[1], N,
                               a.tab.shape[2])
        row = {"shape": f"B={B} F={F} P={P} N={ta.shape[0]} "
                        f"f{8 * item} {label}",
               "kernel_ms": k_ms, "plain_ms": p_ms, "wrapper_ms": w_ms,
               "bound_ms": b_ms, "bound_by": b_by, "issue_ms": i_ms,
               "issue_ms_longest": i_long, "issue_counts": i_counts,
               "sm_clock_mhz": clock,
               "valid_share": n_valid / (B * F), "layout": layout,
               "blocks_per_sm": bps,
               "kernel_vh_per_s": profiling.vh_evals_per_s(B, F, k_ms),
               "plain_vh_per_s": profiling.vh_evals_per_s(B, F, p_ms),
               "wrapper_vh_per_s": profiling.vh_evals_per_s(B, F, w_ms)}
        print(f"  {kind} {row['shape']}: kernel {k_ms:.4f} ms "
              f"({row['kernel_vh_per_s']:.4e} vh/s; bound {b_ms:.4f} ms, "
              f"{b_by}: {ops:.4e} ops on the {row['valid_share']:.4f} valid "
              f"share, {nbytes:.4e} bytes; issue bound {i_ms:.4f} ms "
              f"({i_long:.4f} at the longest paths) at {clock} MHz, "
              f"{i_counts}; layout {layout}, {bps} blocks an SM), wrapper "
              f"{w_ms:.4f} ms ({row['wrapper_vh_per_s']:.4e} vh/s), plain "
              f"{p_ms:.4f} ms ({row['plain_vh_per_s']:.4e} vh/s); {card}",
              flush=True)
        return row

    main64 = [T(a, torch.float64) for a in (freqs, den, bmag, bpsi, alt)]
    x64 = [T(a, torch.float64) for a in (freqs, xden, xbmag, xbpsi, alt)]
    xnu_in = [T(a[:B_X20K] if np.ndim(a) == 2 else a)
              for a in (freqs, nden, nbmag, nbpsi, alt_nu)]
    timing["gather_osolve"] = time_kind("gather_osolve", 1.0, main_in,
                                        P_MAIN, "O")
    timing["gather_xsolve"] = time_kind("gather_xsolve", -1.0, main_in,
                                        P_MAIN, "X")
    timing["gather"] = time_kind("gather", -1.0, main_in, P_MAIN, "X")
    timing["sweep"] = time_kind("sweep", -1.0, x_in, P_X20K, "X")
    # f64 rows of kernels 1 and 4, and the sweep on a grid that is really
    # non-uniform (its cursor moves at uneven steps); the plain sweep at
    # X-20k takes seconds, so it is timed once there
    extra = {"gather_osolve": {"f64": time_kind("gather_osolve", 1.0, main64,
                                                P_MAIN, "O")},
             "gather_xsolve": {"f64": time_kind("gather_xsolve", -1.0, main64,
                                                P_MAIN, "X")},
             "gather": {"f64": time_kind("gather", -1.0, main64, P_MAIN, "X"),
                        "O": time_kind("gather", 1.0, main_in, P_MAIN, "O")},
             "sweep": {"f64": time_kind("sweep", -1.0, x64, P_X20K, "X", 1),
                       "alt_nu": time_kind("sweep", -1.0, xnu_in, P_X20K,
                                           "X, non-uniform alt_nu", 1)}}
    time_kind("gather_xsolve", -1.0, x_in, P_X20K, "X")
    time_kind("sweep", 1.0, main_in, P_MAIN, "O")
    table_rows = segment_table_timing(torch, pv, profiling, dev, card,
                                      (gden, gbmag, gbpsi), alt)
    e2e_ms, _ = profiling.time_launch(
        lambda: vfo(*main_in, mode="O", n_points=P_MAIN), iters=TIMING_ITERS)
    print(f"  vertical_forward_operator_batch(auto) O B={B_MAIN} F={F_MAIN} "
          f"P={P_MAIN} f32: {e2e_ms:.4f} ms "
          f"({profiling.vh_evals_per_s(B_MAIN, F_MAIN, e2e_ms):.4e} vh/s)",
          flush=True)
    print(f"card state after timing (clocks.sm, power.draw, temp): "
          f"{card_state()}", flush=True)

    # ---- 7. the 2-D oblique fan ----------------------------------------
    fan_tables_entry, fan_entry = fan_phase(torch, prt, dev, card, sass)
    print(f"card state after the fan phase (clocks.sm, power.draw, temp): "
          f"{card_state()}", flush=True)

    # ---- 8. the tensor-core one-hot kernel ------------------------------
    mxu_entry = mxu_phase(torch, prt, dev, card, freqs, alt,
                          (den, bmag, bpsi), (cden, cbmag, cbpsi), u_dir,
                          sass)
    print(f"card state after the mxu phase (clocks.sm, power.draw, temp): "
          f"{card_state()}", flush=True)

    # ---- 9. the inversions ------------------------------------------------
    inv_summary = retrieval_phase(torch, prt, dev, card)
    print(f"inversions: {json.dumps(inv_summary)}", flush=True)

    # ---- 10. the 1-D oblique link ------------------------------------------
    link_summary, link_launches = link_phase(torch, prt, dev, card,
                                             (gden, gbmag, gbpsi, alt))
    print(f"link phase: {json.dumps(link_summary)}", flush=True)

    # ---- 11. the 3-D slice -------------------------------------------------
    keep = {}
    t3d_summary = trace3d_phase(torch, prt, dev, card, keep)
    print(f"3-D phase: {json.dumps(t3d_summary)}", flush=True)

    # ---- 12. mesh sharding -------------------------------------------------
    mesh_summary, mesh_launches = mesh_phase(
        torch, prt, dev, card, (gden, gbmag, gbpsi, alt), (den, bmag, bpsi),
        keep)
    del keep
    print(f"mesh phase: {json.dumps(mesh_summary)}", flush=True)

    # ---- 13. differentiation through the kernel entry points --------------
    torch.cuda.empty_cache()
    ad_summary, ad_launches = ad_phase(
        torch, prt, dev, card, freqs, alt, (den, bmag, bpsi),
        (gden, gbmag, gbpsi), (xden, xbmag, xbpsi))
    print(f"AD phase: {json.dumps(ad_summary)}", flush=True)
    check(all(ad_launches[k] > 0 for k in pv.KERNELS),
          f"AD phase: a kernel never launched: {ad_launches}")

    # ---- 14. result lines --------------------------------------------------
    kernels = []
    for k in REPO_KERNELS:
        row = timing[k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE,
            "replaces": REPO_KERNELS[k], "launches": launches[k],
            **({"launches_link_phase": link_launches[k]}
               if k in link_launches else {}),
            **({"launches_mesh_phase": mesh_launches}
               if k == "sweep" else {}),
            "launches_ad_phase": ad_launches[k],
            "max_abs_err": max(errs[k]), "tol": TOL_F64,
            "main_path_f32_vs_plain_f32": max(main_f32[k]),
            "tol_f32_plain": TOL_F32_PLAIN,
            "max_abs_err_f32_vs_f64": max(errs32[k]), "tol_f32": TOL_F32,
            **({"global_grid_f32_vs_f64": global_err[k]}
               if k in global_err else {}),
            **({"razor_f64_vs_plain": max(razor_err)}
               if k == "gather_xsolve" else {}),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "issue_ms": row["issue_ms"],
            "issue_ms_longest": row["issue_ms_longest"],
            "sm_clock_mhz": row["sm_clock_mhz"],
            "library_ms": None, "wrapper_ms": row["wrapper_ms"],
            "valid_share": row["valid_share"], "layout": row["layout"],
            "blocks_per_sm": row["blocks_per_sm"],
            "shape": row["shape"], **extra.get(k, {})})
    kernels.append({
        "name": "segment_table", "route": "cuda", "source": TABLE_SOURCE,
        "replaces": None, "launches": launches["segment_table"],
        "launches_ad_phase": ad_launches["segment_table"],
        "shape": f"B={n_glob} N={N_ALT}", **table_rows})
    mxu_entry["launches_ad_phase"] = ad_launches["mxu"]
    fan_entry["launches_ad_phase"] = ad_launches["fan_2d"]
    kernels.append(mxu_entry)
    kernels.append(fan_entry)
    kernels.append(fan_tables_entry)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
