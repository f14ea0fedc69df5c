// Ionogram synthesis on Hopper (sm_90a): one templated kernel for the four
// Pallas TPU kernels of pyrayhf_tpu/pallas_vh.py.
//
//   instantiation                  replaces (pyrayhf_tpu/pallas_vh.py)
//   gather_kernel<T, O, SOLVE>     _kernel_gather_osolve :701 (+ _osolve_tile :647)
//   gather_kernel<T, X, SOLVE>     _kernel_gather_xsolve :839 (+ _xsolve_tile :788)
//   gather_kernel<T, O|X, !SOLVE>  _kernel_gather :583 (solve on the host)
//   ionogram_kernel<T, O|X>        _kernel :354 (segment sweep, any grid)
//   mup_stable<T, MODE>            _mu_mup_stable_tile :229 (ionogram_common.cuh,
//                                  shared with ionogram_mxu.cu)
//
// What it computes, per (profile b, frequency f): the reflection-height
// solve on the flat-extended profile (or its result from the host), the
// stretched grid alt_p = span * mult_p, the piecewise-linear resample of
// den, |B| and psi at alt_p, the Appleton-Hartree group index mu' with the
// analytic near-reflection margin, and vh = sum_p mu'_p * dh_p + min(alt)
// (NaN where the ray escapes).
//
// Design. The TPU variants exist to get around TPU gathers (the hardware
// gather reaches one 128-lane register; VMEM tiles are large). On Hopper a
// profile's whole segment table (C x N values, 22 KB at N = 620 in f32,
// 45 KB in f64) sits in shared memory, where an indexed load costs the same
// as any other. One block handles one profile and one group of
// frequencies, dealt interleaved (group g of n_groups takes g, g +
// n_groups, ...), so that the valid frequencies, a profile's lowest ones,
// spread over every group. Two layouts, chosen on the host from (B, F, P,
// the SM count and the blocks an SM holds, pyrayhf_ionogram_blocks_per_sm):
//
//   * a warp per (profile, frequency) (short grids, P = 200, or many
//     pairs): each warp takes the group's frequencies in turn, strides its
//     lanes over the P grid points and warp-reduces sum mu' dh;
//   * a block per (profile, frequency) (long grids with few pairs, X-20k
//     at B = 32): every
//     warp takes a contiguous chunk of the pair's points, and the block
//     adds the warps' sums in warp order through shared memory
//     (deterministic, no atomics).
//
// A pair whose ray escapes (the solve marks it invalid) writes NaN and
// does no resample and no mu'; a block of the host-solve kernels none of
// whose pairs is valid does not even load its table. The segment index is
// floor(alt_p / dalt) on a uniform grid; otherwise upper_bound(alt, x) - 1,
// found by a cursor that each lane carries from its last point (the points
// of a lane are 32 apart and x = span * mult_p is monotone in p, so the
// cursor almost always stays in its segment or moves a few nodes; a move
// gallops, then bisects). The cursor returns exactly the binary search's
// index for any x, NaN included, on a non-decreasing altitude table (the
// flat extension repeats the top node).
//
// Bound: the arithmetic of mu' (about 100 flops, 2 sqrt, 1 sin/cos pair
// and 8 IEEE divisions per grid point of a valid pair); the table is read
// from device memory once per block and the output is [B, F]. Built
// without fast math and with -fmad=false, so each expression rounds as the
// plain PyTorch version's does. In the warp layout a pair's sum is one
// warp's tree, in the same order whatever the warps and groups of the
// launch; the block layout adds in another order (f64 agreement ~1e-12
// relative).
//
// Kernels 1-3 (uniform grid: O-mode solve, X-mode solve or host solve)
// run gather_kernel, kernel 4 (the sweep) ionogram_kernel. gather_kernel:
//
//   * the O solve reads the running maximum dmax of den (row 8 of kernel
//     1's table, non-decreasing): a pair whose ray escapes (dmax at the
//     top node below its cutoff) reads no other node, and a valid pair's
//     count of nodes below the cutoff is a 32-way search of the row in
//     place of a count over every node;
//   * the X solve reads a table of each node's cutoff frequency fx_j (the
//     f at which s_j = X_j + Y_j = 1) as its prefix maximum cfx_j, built
//     once per (profile, group) in shared memory: a pair with f above
//     cfx_{N-1} (by a margin) escapes with no node read, and the first
//     exceedance of a valid pair is searched by 32-node ballots from the
//     first node whose cfx reaches f (binary search), not from node 0;
//     k, f0, f1 and r0 stay the exact s of the two-scan solve;
//   * the table arrives by one TMA bulk copy (cp.async.bulk completing on
//     an mbarrier) at a row stride `ld` the host pads to 16 bytes, in
//     place of a loop of loads by every thread.
//
// Timed and not kept (tools/ionogram_attribution.py): copying only the
// channels a kernel reads, mult, 1 - mult and dmult staged in shared
// memory, a persistent grid whose blocks copy the next item's table
// while they work on the current one, and f64 registers capped for 5
// blocks an SM (48 a thread) in place of 4.

#include "ionogram_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
struct Params {
  const T* tab;       // [B, C, ld] channel-major segment table
  int C, N, ld;       // channels, altitude nodes, row stride
  const T* mult;      // [P] stretched-grid multiplier
  const T* omm;       // [P] 1 - mult (formed in f64 on the host)
  const T* dmult;     // [P] mult[p+1] - mult[p], 0 at the end
  int P;
  const T* freq;      // [F] Hz
  int F, n_groups;    // group g takes frequencies g, g + n_groups, ...
  int per_block;      // 1: a block per pair; 0: a warp per pair
  const T* span;      // [B, F] host solve (when !SOLVE)
  const T* slope;
  const T* emax;
  const uint8_t* valid;
  const T* alt_min;   // [1]
  T inv_dalt;         // 1/dalt (when UNIFORM)
  T* out;             // [B, F]
};

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    T w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

template <typename T>
struct Solve {
  T span, slope, emax;
  bool valid;
  bool first;  // the cutoff is already exceeded at the first node
};

// crossing geometry in the relative-altitude frame (pallas_vh._crossing);
// alt0 is the grid's first altitude
template <typename T>
__device__ __forceinline__ Solve<T> crossing(T f0, T f1, T a0, T a1, T r0,
                                             bool first_exceeds, bool valid,
                                             T alt0) {
  const T t = (f1 != f0) ? (T(1) - f0) / (f1 - f0) : T(0);
  T crit = a0 + clip01(t) * (a1 - a0);
  const T da = a1 - a0;
  T slope = (da > T(0) && f1 > f0) ? (f1 - f0) / da : T(0);
  T em = slope * (crit - a0);
  em = em < T(0) ? T(0) : em;
  // a cummax-shadowed lower node (E-peak above a valley) disables the
  // analytic margin: genuine = r0 == f0
  T emax = (r0 == f0) ? em : T(0);
  // cutoff already exceeded at the first node: the zero-span grid
  // evaluates mu' directly, as the upstream does (emax = 0 would take the
  // analytic branch at eps = 0 and give mu = 0, so no sample), on the span
  // of the absolute frame, whose rounding leaves sum(dh) != 0 (-kDH
  // exactly would leave a sum that rounds to 0 on some pairs)
  if (first_exceeds) {
    emax = T(-1);
    crit = (alt0 - T(kDH)) - alt0;
  } else {
    crit = (valid ? crit : T(0)) - T(kDH);
  }
  if (!valid) {
    slope = T(0);
    emax = T(0);
  }
  return {crit, slope, emax, valid, first_exceeds};
}

// #{j < N : row[j] < thr} for a non-decreasing row (a running maximum:
// a NaN, once there, stays to the end), where the test holds on a prefix:
// rounds of one ballot of 32 nodes evenly spaced over the bracket, each
// narrowing it 32-fold (2 rounds at N <= 1,024). The linear count's value
// for every thr, NaN included.
template <typename T>
__device__ __forceinline__ int count_below(const T* row, int N, T thr,
                                           int lane) {
  int lo = 0, hi = N;  // row[j] < thr for j < lo, not for j >= hi
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
}

// O mode (_osolve_tile) on the running maximum dmax of den: a pair whose
// ray escapes reads no node but dmax[N-1]; a valid pair counts dmax <
// f^2/cp^2 (count_below), then takes the X-space +-1 razor correction, 2
// steps each way.
template <typename T>
__device__ Solve<T> osolve_table(const T* alt, const T* den, const T* dmax,
                                 int N, T f, int lane, T alt0) {
  const T cp2 = T(kCP * kCP);
  const T inv_f2 = T(1) / (f * f);
  if (!(dmax[N - 1] * cp2 * inv_f2 >= T(1)))
    return {T(0), T(0), T(0), false};
  int k = min(max(count_below(dmax, N, (f * f) / cp2, lane), 1), N - 1);
  for (int it = 0; it < 2; ++it)
    if (dmax[k - 1] * cp2 * inv_f2 >= T(1) && k > 1) k -= 1;
  for (int it = 0; it < 2; ++it)
    if (dmax[k] * cp2 * inv_f2 < T(1) && k < N - 1) k += 1;
  const T f0 = dmax[k - 1] * cp2 * inv_f2;
  const T f1 = dmax[k] * cp2 * inv_f2;
  const T r0 = den[k - 1] * cp2 * inv_f2;  // un-cummaxed X at k-1
  const bool first_exceeds = (dmax[0] * cp2) * inv_f2 >= T(1);
  return crossing(f0, f1, alt[k - 1], alt[k], r0, first_exceeds, true,
                  alt0);
}

template <typename T>
__device__ __forceinline__ T cutoff_x(const T* den, const T* bm, int j,
                                      T cp2, T inv_f2, T gp, T f) {
  // same op ORDER as the host path: (den*cp2)*inv_f2 + (|B|*gp)/f
  return den[j] * cp2 * inv_f2 + bm[j] * gp / f;
}

// The margin of the cutoff-frequency bracket, relative in f. For f > 0,
// s(f) = fp^2/f^2 + fH/f with fp^2 = den*cp2 >= 0 and fH = |B|*gp >= 0
// falls with f at a log-slope between -2 and -1, so s(f) <= fx/f above
// the root fx = (fH + sqrt(fH^2 + 4 fp^2))/2. The computed s (five
// roundings of positive terms: (den*cp2)*(1/(f*f)) + (|B|*gp)/f) is
// within about 5 ulp of s, the computed fx (fH, fH^2, fp^2, the sum, the
// root, the add) within about 5 ulp of fx. So a computed s >= 1 needs
// f <= fx(1 + 5u)/(1 - 5u) ~ fx(1 + 10u): a node whose computed fx is
// below f(1 - delta) cannot exceed once delta > 10u (6e-7 in f32, 1.1e-15
// in f64, u the unit roundoff). delta = 1e-5 (f32), 1e-12 (f64) keeps a
// factor of 16 (f32) and ~900 (f64) over that; the host's
// pallas_vh.cutoff_table is the same table.
template <typename T>
struct Margin {
  static constexpr double delta = sizeof(T) == 4 ? 1e-5 : 1e-12;
};

// cfx_j = max_{i <= j} fx_i over the block's profile, fx as above; a node
// outside the analysis (den or |B| negative or NaN) gets fx = +inf, so it
// is never passed over. A block-wide scan: each thread takes a run of
// consecutive nodes, then the warps' maxima. Ends with __syncthreads.
template <typename T>
__device__ void cutoff_table(const T* den, const T* bm, int N, T* cfx,
                             T* part) {
  const T cp2 = T(kCP * kCP);
  const T gp = T(kGP);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int j0 = min(N, (int)threadIdx.x * per), j1 = min(N, j0 + per);
  T run = T(-INFINITY);
  for (int j = j0; j < j1; ++j) {
    const T d = den[j], b = bm[j];
    const T fh = b * gp;
    T fx = (fh + sqrt(fh * fh + T(4) * (d * cp2))) * T(0.5);
    if (!(d >= T(0) && b >= T(0))) fx = T(INFINITY);
    run = fx > run ? fx : run;
    cfx[j] = run;
  }
  for (int o = 1; o < 32; o <<= 1) {
    const T w = __shfl_up_sync(kFull, run, o);
    if (lane >= o && w > run) run = w;
  }
  if (lane == 31) part[warp] = run;
  __syncthreads();
  T carry = __shfl_up_sync(kFull, run, 1);
  if (lane == 0) carry = T(-INFINITY);
  for (int w = 0; w < warp; ++w) carry = part[w] > carry ? part[w] : carry;
  for (int j = j0; j < j1; ++j)
    if (carry > cfx[j]) cfx[j] = carry;
  __syncthreads();
}

// X mode (_xsolve_tile) on the cutoff table: the first exceedance of the
// raw s = X + Y, searched from j_lo = the first node with cfx >= f(1 -
// delta) (no node below can exceed), 32 nodes a ballot; f0 and f1 are
// prefix maxima of the same s values, r0 is the raw s at k-1. An escaped
// pair (no node with cfx >= f(1 - delta)) reads no node.
template <typename T>
__device__ Solve<T> xsolve_table(const T* alt, const T* den, const T* bm,
                                 const T* cfx, int N, T f, int lane,
                                 T alt0) {
  const T cp2 = T(kCP * kCP);
  const T gp = T(kGP);
  int jlo = 0;
  if (f > T(0) && f < T(INFINITY)) {
    const T fl = f * T(1.0 - Margin<T>::delta);
    if (cfx[N - 1] < fl) return {T(0), T(0), T(0), false};
    int h = N - 1;
    while (jlo < h) {
      const int mid = (jlo + h) >> 1;
      if (cfx[mid] >= fl) h = mid; else jlo = mid + 1;
    }
  }
  const T inv_f2 = T(1) / (f * f);
  int kf = N;
  for (int j0 = jlo; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < N && cutoff_x(den, bm, j, cp2, inv_f2, gp, f) >= T(1);
    const unsigned m = __ballot_sync(kFull, hit);
    if (m) {
      kf = j0 + __ffs(m) - 1;
      break;
    }
  }
  if (kf == N) return {T(0), T(0), T(0), false};
  const int k = max(kf, 1);
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
  return crossing(f0, f1, alt[k - 1], alt[k], r0, first_exceeds, true,
                  alt0);
}

// The lane's place in the altitude table: lo = upper_bound(alt, x) of its
// last point x, with alt[lo - 1] and alt[lo] (-inf / +inf past the ends).
template <typename T>
struct Cursor {
  int lo;
  T below, above;
};

// Move the cursor to upper_bound(alt, x) for a non-decreasing alt[0..N):
// no load while x stays in [alt[lo-1], alt[lo]); upwards a gallop, then a
// bisection; downwards (or x NaN) a bisection of [0, lo - 1). Equal to the
// binary search over [0, N) for every x.
template <typename T>
__device__ __forceinline__ void seek(const T* alt, int N, T x, Cursor<T>& c) {
  if (c.below <= x && x < c.above) return;
  int l, h;
  if (c.below <= x) {            // alt[lo] <= x
    l = min(c.lo + 1, N);
    h = l;
    for (int step = 1; h < N && alt[h] <= x; step <<= 1) {
      l = h + 1;
      h += step;
    }
    h = min(h, N);
  } else {                       // x < alt[lo - 1], or NaN
    l = 0;
    h = c.lo - 1;
  }
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (alt[mid] <= x) l = mid + 1; else h = mid;
  }
  c.lo = l;
  c.below = l > 0 ? alt[l - 1] : T(-INFINITY);
  c.above = l < N ? alt[l] : T(INFINITY);
}

// A first-exceedance pair's vh is alt0 where mu' at the first node is
// valid, NaN where it is not. Below the gyrofrequency in X mode, X is
// nearly 0 there and mu lies just above 1: f64 finds it not valid where
// f32 rounds mu to 1. So the f32 kernels take the verdict of mu' on the
// node's values promoted to f64 (pallas_vh._first_node_valid).
template <int MODE, typename T>
__device__ bool first_node_ok(T d, T bm, T bp, T f) {
  const double fd = f;
  bool ok;
  mup_stable<double, MODE>(double(d) * (kCP * kCP) / (fd * fd),
                           double(bm) * kGP / fd, double(bp), 1.0, -1.0, ok);
  return ok;
}

// Kernel 4 (host solve, any grid: the segment sweep).
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    ionogram_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int N = p.N;
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int G = p.n_groups;
  T* const out = p.out + (size_t)b * p.F;

  {  // no valid pair in the group: NaN out, and the table stays unread
    const int t0 = g + (int)threadIdx.x * G, t_step = (int)blockDim.x * G;
    int any = 0;
    for (int fi = t0; fi < p.F; fi += t_step)
      any |= p.valid[(size_t)b * p.F + fi];
    if (!__syncthreads_or(any)) {
      for (int fi = t0; fi < p.F; fi += t_step) out[fi] = T(NAN);
      return;
    }
  }

  const int tab_len = p.C * N;
  const T* tb = p.tab + (size_t)b * tab_len;
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) s[i] = tb[i];
  __syncthreads();

  const T* alt = s;          // altitude relative to alt[0]
  const T* inv = s + N;      // 1/dalt per segment (0 on flat segments)
  const T* den = s + 2 * N;
  const T* dden = s + 3 * N;
  const T* bmg = s + 4 * N;
  const T* dbm = s + 5 * N;
  const T* bps = s + 6 * N;
  const T* dbp = s + 7 * N;
  T* part = s + tab_len;     // the warps' sums (block layout)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T amin = *p.alt_min;
  // warp layout: warp w takes the group's frequencies w, w + nwarps, ...
  // and all P points; block layout: every warp takes every frequency and
  // its own chunk of the points
  int slot = warp, slot_step = nwarps, q_begin = 0, q_end = p.P;
  if (p.per_block) {
    const int chunk = (p.P + 32 * nwarps - 1) / (32 * nwarps) * 32;
    slot = 0;
    slot_step = 1;
    q_begin = min(p.P, warp * chunk);
    q_end = min(p.P, q_begin + chunk);
  }
  const bool lead = lane == 0 && (!p.per_block || warp == 0);

  for (int fi = g + slot * G; fi < p.F; fi += slot_step * G) {
    const T f = p.freq[fi];
    const size_t o = (size_t)b * p.F + fi;
    const Solve<T> sv = {p.span[o], p.slope[o], p.emax[o], p.valid[o] != 0};
    if (!sv.valid) {  // the ray escapes: vh is NaN, no resample, no mu'
      if (lead) out[fi] = T(NAN);
      continue;
    }
    const T span = sv.span;
    const T ff = f * f;
    Cursor<T> cur{0, T(-INFINITY), alt[0]};
    T acc = T(0);
    for (int q = q_begin + lane; q < q_end; q += 32) {
      // upper_bound(alt, x) - 1, clamped to a segment [0, N-2]
      const T x = span * p.mult[q];
      seek(alt, N, x, cur);
      const int i0 = min(max(cur.lo - 1, 0), N - 2);
      const T frac = clip01((x - alt[i0]) * inv[i0]);
      const T d = den[i0] + frac * dden[i0];
      const T bmv = bmg[i0] + frac * dbm[i0];
      const T bpv = bps[i0] + frac * dbp[i0];
      acc += quad_term<T, MODE>(d, bmv, bpv, span, sv.slope, sv.emax, f, ff,
                                p.dmult[q], p.omm[q], q, p.P);
    }
    acc = warp_sum(acc);
    if (p.per_block) {
      if (lane == 0) part[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        acc = part[0];
        for (int w = 1; w < nwarps; ++w) acc += part[w];
      }
      __syncthreads();
    }
    if (lead) out[fi] = acc != T(0) ? acc + amin : T(NAN);
  }
}

// ---- kernels 1-3 --------------------------------------------------------

// rows of the table in shared memory: all 8 channels (kernel 1 copies the
// running maximum of den as a 9th row)
constexpr int kRows = 8;
// bytes ahead of the table: the mbarrier, the valid-pair flag, 8 warp
// sums, the block layout's shared solve
constexpr size_t kHead = 128;

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Arm the barrier for `bytes` of bulk copies (the one arrival it waits for).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The in-kernel solve of kernel 1 (O, on dmax) or 2 (X, on cfx): `row8`
// is the table's 9th row in shared memory.
template <typename T, int MODE>
__device__ __forceinline__ Solve<T> solve_pair(const T* alt, const T* den,
                                               const T* bm, const T* row8,
                                               int N, T f, int lane,
                                               T alt0) {
  if constexpr (MODE > 0) {
    return osolve_table(alt, den, row8, N, f, lane, alt0);
  } else {
    return xsolve_table(alt, den, bm, row8, N, f, lane, alt0);
  }
}

// Kernels 1 (O solve), 2 (X solve) and 3 (host solve), on a uniform grid:
// block (b, g) takes profile b's frequencies g, g + n_groups, ... Warp 0
// checks that the group has a valid pair (kernel 3) and copies the table
// into shared memory by TMA. In f64 the registers are capped for 4 blocks
// an SM (64 a thread; 80-97 uncapped, 2-3 blocks): the tail's chains of
// dependent f64 divisions want the warps more than the registers.
template <typename T, int MODE, bool SOLVE>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 8 ? 4 : 1)
    gather_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* has = reinterpret_cast<int*>(smem_raw + 16);
  T* part = reinterpret_cast<T*>(smem_raw + 32);
  Solve<T>* solved = reinterpret_cast<Solve<T>*>(smem_raw + 96);
  T* const tb = reinterpret_cast<T*>(smem_raw + kHead);
  const int N = p.N, ld = p.ld, G = p.n_groups, P = p.P;
  // row 8: kernel 1's dmax, copied with the table; kernel 2's cutoff table
  T* cfx = tb + kRows * ld;
  constexpr int rows = (SOLVE && MODE > 0) ? kRows + 1 : kRows;
  const int b = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T* const out = p.out + (size_t)b * p.F;

  if (threadIdx.x == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    int any = 1;
    if constexpr (!SOLVE) {
      any = 0;
      for (int fi = g + lane * G; fi < p.F; fi += 32 * G)
        any |= p.valid[(size_t)b * p.F + fi];
      any = __any_sync(kFull, any);
    }
    if (lane == 0) {
      *has = any;
      if (any) {
        const unsigned bytes = (unsigned)(rows * ld * sizeof(T));
        mbar_expect(bar, bytes);
        bulk_copy(tb, p.tab + (size_t)b * p.C * ld, bytes, bar);
      }
    }
  }
  __syncthreads();
  if (!*has) {  // no valid pair in the group: NaN out, no table copied
    for (int fi = g + (int)threadIdx.x * G; fi < p.F;
         fi += (int)blockDim.x * G)
      out[fi] = T(NAN);
    return;
  }
  mbar_wait(bar, 0);
  const T* alt = tb;
  const T* den = tb + 2 * ld;
  const T* dden = tb + 3 * ld;
  const T* bmg = tb + 4 * ld;
  const T* dbm = tb + 5 * ld;
  const T* bps = tb + 6 * ld;
  const T* dbp = tb + 7 * ld;
  if constexpr (SOLVE && MODE < 0) cutoff_table(den, bmg, N, cfx, part);

  // warp layout: warp w takes the group's frequencies w, w + nwarps, ...
  // and all P points; block layout: every warp takes every frequency and
  // its own chunk of the points
  int slot = warp, slot_step = nwarps, q_begin = 0, q_end = P;
  if (p.per_block) {
    const int chunk = (P + 32 * nwarps - 1) / (32 * nwarps) * 32;
    slot = 0;
    slot_step = 1;
    q_begin = min(P, warp * chunk);
    q_end = min(P, q_begin + chunk);
  }
  const bool lead = lane == 0 && (!p.per_block || warp == 0);
  const T amin = *p.alt_min;

  for (int fi = g + slot * G; fi < p.F; fi += slot_step * G) {
    const T f = p.freq[fi];
    const size_t o = (size_t)b * p.F + fi;
    Solve<T> sv;
    if constexpr (SOLVE) {
      if (p.per_block) {  // one warp solves, the block reads it
        if (warp == 0) {
          sv = solve_pair<T, MODE>(alt, den, bmg, cfx, N, f, lane, amin);
          if (lane == 0) *solved = sv;
        }
        __syncthreads();
        sv = *solved;
        __syncthreads();
      } else {
        sv = solve_pair<T, MODE>(alt, den, bmg, cfx, N, f, lane, amin);
      }
      if (sizeof(T) == 4 && sv.first && sv.valid)
        sv.valid = first_node_ok<MODE>(den[0], bmg[0], bps[0], f);
    } else {
      sv = {p.span[o], p.slope[o], p.emax[o], p.valid[o] != 0};
    }
    if (!sv.valid) {  // the ray escapes: vh is NaN, no resample, no mu'
      if (lead) out[fi] = T(NAN);
      continue;
    }
    const T span = sv.span;
    const T ff = f * f;
    T acc = T(0);
    for (int q = q_begin + lane; q < q_end; q += 32) {
      T frac;
      const int i0 = uniform_index(span * (p.mult[q] * p.inv_dalt), N, frac);
      const T d = den[i0] + frac * dden[i0];
      const T bmv = bmg[i0] + frac * dbm[i0];
      const T bpv = bps[i0] + frac * dbp[i0];
      acc += quad_term<T, MODE>(d, bmv, bpv, span, sv.slope, sv.emax, f, ff,
                                p.dmult[q], p.omm[q], q, P);
    }
    acc = warp_sum(acc);
    if (p.per_block) {
      if (lane == 0) part[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        acc = part[0];
        for (int w = 1; w < nwarps; ++w) acc += part[w];
      }
      __syncthreads();
    }
    if (lead) out[fi] = acc != T(0) ? acc + amin : T(NAN);
  }
}

// ---- launch --------------------------------------------------------------

// Dynamic shared memory of one ionogram_kernel block: the [C, N] table and
// 8 warp sums.
template <typename T>
size_t smem_of(int C, int N) {
  return sizeof(T) * ((size_t)C * N + kMaxThreads / 32);
}

// ... of one gather_kernel block: the head, the table and its 9th row
// (kernel 1's dmax, kernel 2's cutoff table).
template <typename T, bool SOLVE>
size_t gather_smem(int ld) {
  size_t n = (size_t)kRows * ld;
  if (SOLVE) n += ld;
  return kHead + sizeof(T) * n;
}

// Lets the kernel take `smem` bytes of dynamic shared memory (above the
// default 48 KB only by opting in).
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The kernel of an instantiation and its dynamic shared memory: kernels
// 1-3 (uniform grid) gather_kernel, kernel 4 ionogram_kernel.
template <typename T, int MODE, bool SOLVE, bool UNIFORM>
struct Kernel {
  using type = T;
  static constexpr bool gather = UNIFORM;
  static void (*fn())(const Params<T>) {
    if constexpr (gather) {
      return gather_kernel<T, MODE, SOLVE>;
    } else {
      return ionogram_kernel<T, MODE>;
    }
  }
  static size_t smem(int C, int N, int ld) {
    if constexpr (gather) {
      return gather_smem<T, SOLVE>(ld);
    } else {
      return smem_of<T>(C, N);
    }
  }
};

// The one place where the C entries' flags become an instantiation:
// f(Kernel<T, MODE, SOLVE, UNIFORM>{}) for dtype (0 float, 1 double), mode
// (+1 O, -1 X), solve and uniform; solve takes the uniform-grid kernel
// (the entries refuse solve without uniform). `bad` for another dtype.
template <typename T, typename F>
int with_flags(int mode, int solve, int uniform, F& f) {
  if (mode > 0) {
    if (solve) return f(Kernel<T, 1, true, true>{});
    if (uniform) return f(Kernel<T, 1, false, true>{});
    return f(Kernel<T, 1, false, false>{});
  }
  if (solve) return f(Kernel<T, -1, true, true>{});
  if (uniform) return f(Kernel<T, -1, false, true>{});
  return f(Kernel<T, -1, false, false>{});
}

template <typename F>
int with_kernel(int dtype, int mode, int solve, int uniform, int bad, F f) {
  if (dtype == 0) return with_flags<float>(mode, solve, uniform, f);
  if (dtype == 1) return with_flags<double>(mode, solve, uniform, f);
  return bad;
}

template <typename K, typename T = typename K::type>
int launch(const Params<T>& p, int B, int warps, cudaStream_t stream) {
  const size_t smem = K::smem(p.C, p.N, p.ld);
  auto kern = K::fn();
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B, p.n_groups), warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename K>
int blocks_of(int C, int N, int ld, int warps) {
  const size_t smem = K::smem(C, N, ld);
  auto kern = K::fn();
  cudaError_t e = allow_smem(kern, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, warps * 32,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename K, typename T = typename K::type>
int dispatch(int mode, int solve, int uniform, const void* tab, int C, int B,
             int N, int ld, const void* mult, const void* omm,
             const void* dmult, int P, const void* freq, int F, int n_groups,
             int warps, int per_block, const void* span,
             const void* slope, const void* emax, const void* valid,
             const void* alt_min, double inv_dalt, void* out,
             cudaStream_t stream) {
  // gather_kernel's bulk copies: rows of a multiple of 16 bytes, a
  // 16-byte-aligned table; ionogram_kernel reads rows of N
  const bool rows_ok =
      uniform ? (ld >= N && (ld * sizeof(T)) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(tab) % 16 == 0)
             : ld == N;
  if (warps < 1 || warps * 32 > kMaxThreads || n_groups < 1 ||
      n_groups > 65535 || N < 2 || !rows_ok ||
      B < 1 || F < 1 || P < 1 || C < 8 || (solve && !uniform) ||
      (solve && mode > 0 && C < 9) || (!solve && !(span && slope && emax &&
                                                   valid)))
    return (int)cudaErrorInvalidValue;
  Params<T> p{static_cast<const T*>(tab), C, N, ld,
              static_cast<const T*>(mult), static_cast<const T*>(omm),
              static_cast<const T*>(dmult), P,
              static_cast<const T*>(freq), F, n_groups, per_block,
              static_cast<const T*>(span), static_cast<const T*>(slope),
              static_cast<const T*>(emax),
              static_cast<const uint8_t*>(valid),
              static_cast<const T*>(alt_min), T(inv_dalt),
              static_cast<T*>(out)};
  return launch<K>(p, B, warps, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. mode: +1 O, -1 X. solve: reflection solve
// in the kernel (needs uniform). uniform: arithmetic index with inv_dalt.
// tab [B, C, ld]: ld = N for kernel 4, a multiple of 16 bytes >= N for
// kernels 1-3. n_groups frequency groups per profile
// (interleaved), warps per block, per_block: a block per (profile,
// frequency) instead of a warp.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int pyrayhf_ionogram(int dtype, int mode, int solve, int uniform,
                     const void* tab, int C, int B, int N, int ld,
                     const void* mult, const void* omm, const void* dmult,
                     int P, const void* freq, int F, int n_groups, int warps,
                     int per_block, const void* span,
                     const void* slope, const void* emax, const void* valid,
                     const void* alt_min, double inv_dalt, void* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto k) {
    return dispatch<decltype(k)>(mode, solve, uniform, tab, C, B, N, ld, mult,
                                 omm, dmult, P, freq, F, n_groups, warps,
                                 per_block, span, slope, emax, valid, alt_min,
                                 inv_dalt, out, st);
  };
  return with_kernel(dtype, mode, solve, uniform,
                     (int)cudaErrorInvalidValue, go);
}

// Blocks of `warps` warps of one instantiation that one SM of the current
// device holds at once with a [C, N] table of row stride ld (the CUDA
// occupancy calculator, from the registers ptxas allotted and the shared
// memory), or minus a cudaError_t.
int pyrayhf_ionogram_blocks_per_sm(int dtype, int mode, int solve,
                                   int uniform, int C, int N, int ld,
                                   int warps) {
  const int bad = -(int)cudaErrorInvalidValue;
  if ((solve && !uniform) || warps < 1 || warps * 32 > kMaxThreads ||
      C < 1 || N < 1 || ld < N)
    return bad;
  auto go = [&](auto k) { return blocks_of<decltype(k)>(C, N, ld, warps); };
  return with_kernel(dtype, mode, solve, uniform, bad, go);
}

const char* pyrayhf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
