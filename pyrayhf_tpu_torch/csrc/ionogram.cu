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
// as any other: the index is floor(alt_p / dalt) on a uniform grid and a
// binary search over the node altitudes otherwise. One block handles one
// profile and a group of frequencies; each warp takes one frequency at a
// time, solves its reflection height (lanes split the N nodes, warp
// reductions combine), strides its lanes over the P grid points, and
// warp-reduces sum mu' dh. No tiling, padding or chunk revisiting carries
// over from the TPU.
//
// Bound: the arithmetic of mu' (about 100 flops, 2 sqrt, 1 sin/cos pair
// and 8 IEEE divisions per grid point); the table is read from device
// memory once per block and the output is [B, F]. Built without fast math
// and with -fmad=false, so each expression rounds as the plain PyTorch
// version's does; sums are warp trees, so f64 agreement is to ~1e-12
// relative, not bitwise.

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
  int F, f_group;
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

template <typename T, int MODE, bool SOLVE, bool UNIFORM>
__global__ void __launch_bounds__(kMaxThreads)
    ionogram_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int N = p.N;
  const int b = blockIdx.x;
  const int f_begin = blockIdx.y * p.f_group;
  const int f_end = min(p.F, f_begin + p.f_group);

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

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const T amin = *p.alt_min;

  for (int fi = f_begin + (threadIdx.x >> 5); fi < f_end; fi += nwarps) {
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
    const T span = sv.span;
    const T ff = f * f;
    T acc = T(0);
    for (int q = lane; q < p.P; q += 32) {
      int i0;
      T frac;
      if constexpr (UNIFORM) {
        i0 = uniform_index(span * (p.mult[q] * p.inv_dalt), N, frac);
      } else {
        // upper_bound(alt, x) - 1, clamped to a segment [0, N-2]
        const T x = span * p.mult[q];
        int lo = 0, hi = N;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (alt[mid] <= x) lo = mid + 1; else hi = mid;
        }
        i0 = min(max(lo - 1, 0), N - 2);
        frac = clip01((x - alt[i0]) * inv[i0]);
      }
      const T d = den[i0] + frac * dden[i0];
      const T bmv = bmg[i0] + frac * dbm[i0];
      const T bpv = bps[i0] + frac * dbp[i0];
      acc += quad_term<T, MODE>(d, bmv, bpv, span, sv.slope, sv.emax, f, ff,
                                p.dmult[q], p.omm[q], q, p.P);
    }
    acc = warp_sum(acc);
    if (lane == 0) p.out[o] = (sv.valid && acc != T(0)) ? acc + amin : T(NAN);
  }
}

template <typename T, int MODE, bool SOLVE, bool UNIFORM>
int launch(const Params<T>& p, int B, int warps, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)p.C * p.N;
  auto kern = ionogram_kernel<T, MODE, SOLVE, UNIFORM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, (p.F + p.f_group - 1) / p.f_group);
  kern<<<grid, warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, int solve, int uniform, const void* tab, int C, int B,
             int N, const void* mult, const void* omm, const void* dmult,
             int P, const void* freq, int F, int f_group, int warps,
             const void* span, const void* slope, const void* emax,
             const void* valid, const void* alt_min, double inv_dalt,
             void* out, cudaStream_t stream) {
  if (warps < 1 || warps * 32 > kMaxThreads || f_group < 1 || N < 2 ||
      B < 1 || F < 1 || P < 1 || C < 8 || (solve && !uniform) ||
      (solve && mode > 0 && C < 9) || (!solve && !(span && slope && emax &&
                                                   valid)))
    return (int)cudaErrorInvalidValue;
  Params<T> p{static_cast<const T*>(tab), C, N,
              static_cast<const T*>(mult), static_cast<const T*>(omm),
              static_cast<const T*>(dmult), P,
              static_cast<const T*>(freq), F, f_group,
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
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int pyrayhf_ionogram(int dtype, int mode, int solve, int uniform,
                     const void* tab, int C, int B, int N, const void* mult,
                     const void* omm, const void* dmult, int P,
                     const void* freq, int F, int f_group, int warps,
                     const void* span, const void* slope, const void* emax,
                     const void* valid, const void* alt_min, double inv_dalt,
                     void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(mode, solve, uniform, tab, C, B, N, mult, omm,
                           dmult, P, freq, F, f_group, warps, span, slope,
                           emax, valid, alt_min, inv_dalt, out, st);
  if (dtype == 1)
    return dispatch<double>(mode, solve, uniform, tab, C, B, N, mult, omm,
                            dmult, P, freq, F, f_group, warps, span, slope,
                            emax, valid, alt_min, inv_dalt, out, st);
  return (int)cudaErrorInvalidValue;
}

const char* pyrayhf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
