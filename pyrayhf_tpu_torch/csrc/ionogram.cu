// Ionogram synthesis on Hopper (sm_90a): one templated kernel for the four
// Pallas TPU kernels of pyrayhf_tpu/pallas_vh.py.
//
//   instantiation                  replaces (pyrayhf_tpu/pallas_vh.py)
//   <T, O, SOLVE, UNIFORM>         _kernel_gather_osolve :701 (+ _osolve_tile :647)
//   <T, X, SOLVE, UNIFORM>         _kernel_gather_xsolve :839 (+ _xsolve_tile :788)
//   <T, O|X, !SOLVE, UNIFORM>      _kernel_gather :583 (solve on the host)
//   <T, O|X, !SOLVE, !UNIFORM>     _kernel :354 (segment sweep, any grid)
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

#include "ionogram_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
struct Params {
  const T* tab;       // [B, C, N] channel-major segment table
  int C, N;
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
};

// crossing geometry in the relative-altitude frame (pallas_vh :682-697)
template <typename T>
__device__ __forceinline__ Solve<T> crossing(T f0, T f1, T a0, T a1, T r0,
                                             bool first_exceeds,
                                             bool valid) {
  const T t = (f1 != f0) ? (T(1) - f0) / (f1 - f0) : T(0);
  T crit = a0 + clip01(t) * (a1 - a0);
  const T da = a1 - a0;
  T slope = (da > T(0) && f1 > f0) ? (f1 - f0) / da : T(0);
  T em = slope * (crit - a0);
  em = em < T(0) ? T(0) : em;
  // a cummax-shadowed lower node (E-peak above a valley) disables the
  // analytic margin: genuine = r0 == f0
  T emax = (r0 == f0) ? em : T(0);
  if (first_exceeds) crit = T(0);
  crit = (valid ? crit : T(0)) - T(kDH);
  if (!valid) {
    slope = T(0);
    emax = T(0);
  }
  return {crit, slope, emax, valid};
}

// O mode (_osolve_tile): count cummax(den) < f^2/cp^2, then the X-space
// +-1 razor correction, 2 steps each way.
template <typename T>
__device__ Solve<T> osolve(const T* alt, const T* den, const T* dmax, int N,
                           T f, int lane) {
  const T cp2 = T(kCP * kCP);
  const T inv_f2 = T(1) / (f * f);
  const T thr = (f * f) / cp2;
  int cnt = 0;
  for (int j = lane; j < N; j += 32) cnt += dmax[j] < thr ? 1 : 0;
  cnt = __reduce_add_sync(kFull, cnt);
  int k = min(max(cnt, 1), N - 1);
  for (int it = 0; it < 2; ++it)
    if (dmax[k - 1] * cp2 * inv_f2 >= T(1) && k > 1) k -= 1;
  for (int it = 0; it < 2; ++it)
    if (dmax[k] * cp2 * inv_f2 < T(1) && k < N - 1) k += 1;
  const T f0 = dmax[k - 1] * cp2 * inv_f2;
  const T f1 = dmax[k] * cp2 * inv_f2;
  const T r0 = den[k - 1] * cp2 * inv_f2;  // un-cummaxed X at k-1
  const bool first_exceeds = (dmax[0] * cp2) * inv_f2 >= T(1);
  const bool valid = dmax[N - 1] * cp2 * inv_f2 >= T(1);
  return crossing(f0, f1, alt[k - 1], alt[k], r0, first_exceeds, valid);
}

template <typename T>
__device__ __forceinline__ T cutoff_x(const T* den, const T* bm, int j,
                                      T cp2, T inv_f2, T gp, T f) {
  // same op ORDER as the host path: (den*cp2)*inv_f2 + (|B|*gp)/f
  return den[j] * cp2 * inv_f2 + bm[j] * gp / f;
}

// X mode (_xsolve_tile): first exceedance of the raw s = X + Y; f0 and f1
// are prefix maxima of the same s values, r0 is the raw s at k-1.
template <typename T>
__device__ Solve<T> xsolve(const T* alt, const T* den, const T* bm, int N,
                           T f, int lane) {
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
  return crossing(f0, f1, alt[k - 1], alt[k], r0, first_exceeds, valid);
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

template <typename T, int MODE, bool SOLVE, bool UNIFORM>
__global__ void __launch_bounds__(kMaxThreads)
    ionogram_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int N = p.N;
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int G = p.n_groups;
  T* const out = p.out + (size_t)b * p.F;

  if constexpr (!SOLVE) {
    // no valid pair in the group: NaN out, and the table stays unread
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
    Solve<T> sv;
    if constexpr (SOLVE) {
      if constexpr (MODE > 0) {
        sv = osolve(alt, den, s + 8 * N, N, f, lane);
      } else {
        sv = xsolve(alt, den, bmg, N, f, lane);
      }
    } else {
      sv = {p.span[o], p.slope[o], p.emax[o], p.valid[o] != 0};
    }
    if (!sv.valid) {  // the ray escapes: vh is NaN, no resample, no mu'
      if (lead) out[fi] = T(NAN);
      continue;
    }
    const T span = sv.span;
    const T ff = f * f;
    Cursor<T> cur{0, T(-INFINITY), alt[0]};
    T acc = T(0);
    for (int q = q_begin + lane; q < q_end; q += 32) {
      int i0;
      T frac;
      if constexpr (UNIFORM) {
        i0 = uniform_index(span * (p.mult[q] * p.inv_dalt), N, frac);
      } else {
        // upper_bound(alt, x) - 1, clamped to a segment [0, N-2]
        const T x = span * p.mult[q];
        seek(alt, N, x, cur);
        i0 = min(max(cur.lo - 1, 0), N - 2);
        frac = clip01((x - alt[i0]) * inv[i0]);
      }
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

// Dynamic shared memory of one block: the [C, N] table and 8 warp sums.
template <typename T>
size_t smem_of(int C, int N) {
  return sizeof(T) * ((size_t)C * N + kMaxThreads / 32);
}

// Lets the kernel take `smem` bytes of dynamic shared memory (above the
// default 48 KB only by opting in).
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int MODE, bool SOLVE, bool UNIFORM>
int launch(const Params<T>& p, int B, int warps, cudaStream_t stream) {
  const size_t smem = smem_of<T>(p.C, p.N);
  auto kern = ionogram_kernel<T, MODE, SOLVE, UNIFORM>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, p.n_groups);
  kern<<<grid, warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, bool SOLVE, bool UNIFORM>
int blocks_of(int C, int N, int warps) {
  const size_t smem = smem_of<T>(C, N);
  auto kern = ionogram_kernel<T, MODE, SOLVE, UNIFORM>;
  cudaError_t e = allow_smem(kern, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, warps * 32,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int blocks_dispatch(int mode, int solve, int uniform, int C, int N,
                    int warps) {
  if ((solve && !uniform) || warps < 1 || warps * 32 > kMaxThreads ||
      C < 1 || N < 1)
    return -(int)cudaErrorInvalidValue;
  if (mode > 0) {
    if (solve) return blocks_of<T, 1, true, true>(C, N, warps);
    if (uniform) return blocks_of<T, 1, false, true>(C, N, warps);
    return blocks_of<T, 1, false, false>(C, N, warps);
  }
  if (solve) return blocks_of<T, -1, true, true>(C, N, warps);
  if (uniform) return blocks_of<T, -1, false, true>(C, N, warps);
  return blocks_of<T, -1, false, false>(C, N, warps);
}

template <typename T>
int dispatch(int mode, int solve, int uniform, const void* tab, int C, int B,
             int N, const void* mult, const void* omm, const void* dmult,
             int P, const void* freq, int F, int n_groups, int warps,
             int per_block, const void* span, const void* slope,
             const void* emax, const void* valid, const void* alt_min,
             double inv_dalt, void* out, cudaStream_t stream) {
  if (warps < 1 || warps * 32 > kMaxThreads || n_groups < 1 ||
      n_groups > 65535 || N < 2 ||
      B < 1 || F < 1 || P < 1 || C < 8 || (solve && !uniform) ||
      (solve && mode > 0 && C < 9) || (!solve && !(span && slope && emax &&
                                                   valid)))
    return (int)cudaErrorInvalidValue;
  Params<T> p{static_cast<const T*>(tab), C, N,
              static_cast<const T*>(mult), static_cast<const T*>(omm),
              static_cast<const T*>(dmult), P,
              static_cast<const T*>(freq), F, n_groups, per_block,
              static_cast<const T*>(span), static_cast<const T*>(slope),
              static_cast<const T*>(emax),
              static_cast<const uint8_t*>(valid),
              static_cast<const T*>(alt_min), T(inv_dalt),
              static_cast<T*>(out)};
  if (mode > 0) {
    if (solve) return launch<T, 1, true, true>(p, B, warps, stream);
    if (uniform) return launch<T, 1, false, true>(p, B, warps, stream);
    return launch<T, 1, false, false>(p, B, warps, stream);
  }
  if (solve) return launch<T, -1, true, true>(p, B, warps, stream);
  if (uniform) return launch<T, -1, false, true>(p, B, warps, stream);
  return launch<T, -1, false, false>(p, B, warps, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. mode: +1 O, -1 X. solve: reflection solve
// in the kernel (needs uniform). uniform: arithmetic index with inv_dalt.
// n_groups frequency groups per profile (interleaved), warps per block,
// per_block: a block per (profile, frequency) instead of a warp.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int pyrayhf_ionogram(int dtype, int mode, int solve, int uniform,
                     const void* tab, int C, int B, int N, const void* mult,
                     const void* omm, const void* dmult, int P,
                     const void* freq, int F, int n_groups, int warps,
                     int per_block, const void* span, const void* slope,
                     const void* emax, const void* valid,
                     const void* alt_min, double inv_dalt, void* out,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(mode, solve, uniform, tab, C, B, N, mult, omm,
                           dmult, P, freq, F, n_groups, warps, per_block,
                           span, slope, emax, valid, alt_min, inv_dalt, out,
                           st);
  if (dtype == 1)
    return dispatch<double>(mode, solve, uniform, tab, C, B, N, mult, omm,
                            dmult, P, freq, F, n_groups, warps, per_block,
                            span, slope, emax, valid, alt_min, inv_dalt, out,
                            st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of `warps` warps of one instantiation that one SM of the current
// device holds at once with a [C, N] table (the CUDA occupancy calculator,
// from the registers ptxas allotted and the shared memory), or minus a
// cudaError_t.
int pyrayhf_ionogram_blocks_per_sm(int dtype, int mode, int solve,
                                   int uniform, int C, int N, int warps) {
  if (dtype == 0)
    return blocks_dispatch<float>(mode, solve, uniform, C, N, warps);
  if (dtype == 1)
    return blocks_dispatch<double>(mode, solve, uniform, C, N, warps);
  return -(int)cudaErrorInvalidValue;
}

const char* pyrayhf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
