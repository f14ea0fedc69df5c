// Ionogram synthesis with the resample as one-hot matrix products on the
// Hopper tensor cores (sm_90a, warp-level mma.sync).
//
// Replaces pyrayhf_tpu/pallas_vh.py:456 _kernel_mxu (pallas_call at :1232):
// the host-solve, uniform-grid ionogram whose piecewise-linear resample is a
// gather written as factorised one-hot matmuls on the TPU's matrix unit.
//
// What it computes, per (profile b, frequency f, grid point p), exactly as
// pallas_vh.py:477-538 on the host-solve tables:
//   pos = span[b,f] * (mult[p] * inv_dalt), i0 = clamp(floor(pos), 0, N-2),
//   frac = clip(pos - i0, 0, 1), i0 = a*16 + bb (K2 = 16, K1 = ceil(N/16));
//   U = T[b] . onehot(a), T[b] the [K2*8 = 128, K1] table of 8-channel
//   segment rows (Tt[q, a] = seg[a*16 + q/8, q%8]); the bb-th 8-row group of
//   U is seg[i0, 0..7]; d = c2 + frac*c3, bm = c4 + frac*c5,
//   bp = c6 + frac*c7; then the mu'/quadrature tail of the other ionogram
//   kernels (quad_term, mup_stable: ionogram_common.cuh), and
//   vh = sum_p mu'_p dh_p + min(alt), NaN where the ray escapes.
//
// Design. One block per (profile, frequency group) and one warp per
// frequency, as in ionogram.cu. The profile's table sits in shared memory
// (row stride K1P + 4, K1P = K1 rounded up to 8, zeros beyond K1). A warp
// resamples 32 grid points at a time. The one-hot operand is built in
// registers from each point's index, never read from memory; it is the A
// operand (points are the M dimension), the table the B operand (its 128
// rows are 16 N-tiles of 8, one per segment offset bb, each tile holding
// the 8 channels), and K runs over a. The fold is a register select: a
// thread keeps the accumulator tile whose N-tile index equals its point's
// bb, so the four threads of a quad hold channels 0..7 of the point's
// segment row. Threads 1..3 of each quad put channels 2..7 into the warp's
// shared scratch and each lane finishes one point, in the lane-strided
// order of ionogram.cu, so the sums add in the same order as kernel 3's.
//
//   f64: mma.sync m8n8k4 (DMMA), one pass; IEEE products and sums, and the
//        one-hot makes each output equal to the table entry exactly.
//   f32: mma.sync m16n8k8 TF32 on the table split into three exact TF32
//        parts (hi, mid, lo: truncations to 10 explicit mantissa bits of the
//        value and of its remainders). Each part goes through its own
//        accumulator, so every tensor-core sum is one exact product plus
//        zeros, and (hi + mid) + lo restores the f32 entry exactly (the
//        TPU's Precision.HIGHEST splits into bf16 parts to the same end).
//   Shared memory: 128 x 44 x 4 B x 3 = 66 KB (f32), 44 KB (f64) at
//   N = 620, plus 6 x 32 values of scratch per warp.
//
// Bound. The tensor-core work of the one-hot products as implemented: per
// 32 points, 16 N-tiles x K1P/8 K-steps x 2 M-tiles x 3 parts m16n8k8 TF32
// (30,720 flops a point at K1P = 40) or 16 x K1P/4 x 4 m8n8k4 DMMA (10,240
// flops a point). At O-200 (B = 1024, F = 175, P = 200) that is ~1.2e12
// TF32 flops (2.5 ms at 495 TFLOP/s) or ~4.1e11 f64 flops (6.1 ms at
// 67 TFLOP/s), against 0.65 ms for kernel 3's direct shared-memory load of
// the same rows: a gather is one useful multiply-add per output element,
// and the products spend the other 127 of every 128 on zeros. The design
// keeps the table loads out of the inner loop over M-tiles and builds the
// one-hot in registers; it does not use wgmma or TMA. Built without fast
// math and with -fmad=false.

#include "ionogram_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK2 = 16;           // segment offsets per one-hot column
constexpr int kRows = kK2 * 8;    // table rows: 16 offsets x 8 channels
constexpr int kPad = 4;           // row padding of the shared table (banks)
constexpr int kScratch = 6 * 32;  // channels 2..7 of 32 points, per warp
constexpr uint32_t kOne = 0x3f800000u;  // 1.0f, an exact TF32 value

template <typename T>
struct MxuParams {
  const T* tab;       // [B, 128, K1] one-hot table
  int N, K1, K1P;     // nodes, table columns, K1 rounded up to 8
  const T* mult;      // [P] stretched-grid multiplier
  const T* omm;       // [P] 1 - mult (formed in f64 on the host)
  const T* dmult;     // [P] mult[p+1] - mult[p], 0 at the end
  int P;
  const T* freq;      // [F] Hz
  int F, f_group;
  const T* span;      // [B, F] host solve
  const T* slope;
  const T* emax;
  const uint8_t* valid;
  const T* alt_min;   // [1]
  T inv_dalt;         // 1/dalt of the uniform grid
  T* out;             // [B, F]
};

template <typename T>
__host__ __device__ constexpr int n_parts() { return sizeof(T) == 4 ? 3 : 1; }

size_t smem_bytes(size_t elt, int parts, int K1P, int warps) {
  return elt * ((size_t)parts * kRows * (K1P + kPad) +
                (size_t)warps * kScratch);
}

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// table entry -> shared memory: f32 as three exact TF32 parts in three
// planes, f64 as it is
__device__ __forceinline__ void store_entry(float* s, int idx, int plane,
                                            float v) {
  const float hi = tf32_trunc(v);
  const float r = v - hi;
  const float mid = tf32_trunc(r);
  s[idx] = hi;
  s[idx + plane] = mid;
  s[idx + 2 * plane] = r - mid;
}

__device__ __forceinline__ void store_entry(double* s, int idx, int plane,
                                            double v) {
  (void)plane;
  s[idx] = v;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// one-hot column a and segment offset bb of grid point q (-1 past P)
template <typename T>
__device__ __forceinline__ void point_index(T span, const T* mult,
                                            T inv_dalt, int N, int q, int P,
                                            int& a, int& bb) {
  if (q < P) {
    T frac;
    const int i0 = uniform_index(span * (mult[q] * inv_dalt), N, frac);
    a = i0 / kK2;
    bb = i0 - a * kK2;
  } else {
    a = -1;
    bb = -1;
  }
}

// f32: resample grid points c0 .. c0+31 of one frequency (two m16 tiles of
// points); writes channels 2..7 of each point's segment row to
// scr[(c - 2) * 32 + j].
__device__ void onehot_chunk(const float* st, int S, int K1P, int N,
                             float span, const float* mult, float inv_dalt,
                             int c0, int P, float* scr, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const int plane = kRows * S;
  int ai[2][2], bi[2][2];  // [M-tile][row gid / gid + 8]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      point_index(span, mult, inv_dalt, N, c0 + mt * 16 + h * 8 + gid, P,
                  ai[mt][h], bi[mt][h]);
  float keep[2][4] = {};
  for (int nt = 0; nt < kK2; ++nt) {
    float acc[3][2][4] = {};
    const int row = (nt * 8 + gid) * S + tig;
    for (int k0 = 0; k0 < K1P; k0 += 8) {
      uint32_t b[3][2];
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        b[part][0] = __float_as_uint(st[part * plane + row + k0]);
        b[part][1] = __float_as_uint(st[part * plane + row + k0 + 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t a[4] = {k0 + tig == ai[mt][0] ? kOne : 0u,
                               k0 + tig == ai[mt][1] ? kOne : 0u,
                               k0 + tig + 4 == ai[mt][0] ? kOne : 0u,
                               k0 + tig + 4 == ai[mt][1] ? kOne : 0u};
#pragma unroll
        for (int part = 0; part < 3; ++part)
          mma_tf32(acc[part][mt], a, b[part][0], b[part][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (bi[mt][h] == nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 2 * h + c;
            keep[mt][i] = (acc[0][mt][i] + acc[1][mt][i]) + acc[2][mt][i];
          }
        }
  }
  if (tig > 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = mt * 16 + h * 8 + gid;
        scr[(2 * tig - 2) * 32 + j] = keep[mt][2 * h];
        scr[(2 * tig - 1) * 32 + j] = keep[mt][2 * h + 1];
      }
  }
}

// f64: the same with four m8 tiles of points and one DMMA pass
__device__ void onehot_chunk(const double* st, int S, int K1P, int N,
                             double span, const double* mult,
                             double inv_dalt, int c0, int P, double* scr,
                             int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  int ai[4], bi[4];  // [M-tile], row gid
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
    point_index(span, mult, inv_dalt, N, c0 + mt * 8 + gid, P, ai[mt],
                bi[mt]);
  double keep[4][2] = {};
  for (int nt = 0; nt < kK2; ++nt) {
    double acc[4][2] = {};
    const int row = (nt * 8 + gid) * S + tig;
    for (int k0 = 0; k0 < K1P; k0 += 4) {
      const double b = st[row + k0];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        mma_f64(acc[mt], k0 + tig == ai[mt] ? 1.0 : 0.0, b);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      if (bi[mt] == nt) {
        keep[mt][0] = acc[mt][0];
        keep[mt][1] = acc[mt][1];
      }
  }
  if (tig > 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int j = mt * 8 + gid;
      scr[(2 * tig - 2) * 32 + j] = keep[mt][0];
      scr[(2 * tig - 1) * 32 + j] = keep[mt][1];
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    ionogram_mxu_kernel(const MxuParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);
  const int S = p.K1P + kPad;
  const int plane = kRows * S;
  const int b = blockIdx.x;
  const int f_begin = blockIdx.y * p.f_group;
  const int f_end = min(p.F, f_begin + p.f_group);

  // the profile's table: columns a < K1 from device memory, zeros up to
  // K1P (a one-hot column never selects them, and 0 * 0 stays 0)
  const T* tb = p.tab + (size_t)b * kRows * p.K1;
  for (int i = threadIdx.x; i < kRows * p.K1P; i += blockDim.x) {
    const int q = i / p.K1P;
    const int k = i - q * p.K1P;
    store_entry(st, q * S + k, plane, k < p.K1 ? tb[q * p.K1 + k] : T(0));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  T* scr = st + n_parts<T>() * plane + (threadIdx.x >> 5) * kScratch;
  const T amin = *p.alt_min;

  for (int fi = f_begin + (threadIdx.x >> 5); fi < f_end; fi += nwarps) {
    const T f = p.freq[fi];
    const size_t o = (size_t)b * p.F + fi;
    const T span = p.span[o];
    const T slope = p.slope[o];
    const T emax = p.emax[o];
    const T ff = f * f;
    T acc = T(0);
    for (int c0 = 0; c0 < p.P; c0 += 32) {
      onehot_chunk(st, S, p.K1P, p.N, span, p.mult, p.inv_dalt, c0, p.P, scr,
                   lane);
      __syncwarp();
      const int q = c0 + lane;
      if (q < p.P) {
        T frac;
        uniform_index(span * (p.mult[q] * p.inv_dalt), p.N, frac);
        const T d = scr[lane] + frac * scr[32 + lane];
        const T bmv = scr[64 + lane] + frac * scr[96 + lane];
        const T bpv = scr[128 + lane] + frac * scr[160 + lane];
        acc += quad_term<T, MODE>(d, bmv, bpv, span, slope, emax, f, ff,
                                  p.dmult[q], p.omm[q], q, p.P);
      }
      __syncwarp();
    }
    acc = warp_sum(acc);
    if (lane == 0)
      p.out[o] = (p.valid[o] != 0 && acc != T(0)) ? acc + amin : T(NAN);
  }
}

template <typename T, int MODE>
int launch(const MxuParams<T>& p, int B, int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), n_parts<T>(), p.K1P, warps);
  auto kern = ionogram_mxu_kernel<T, MODE>;
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
int dispatch(int mode, const void* tab, int B, int N, int K1,
             const void* mult, const void* omm, const void* dmult, int P,
             const void* freq, int F, int f_group, int warps,
             const void* span, const void* slope, const void* emax,
             const void* valid, const void* alt_min, double inv_dalt,
             void* out, cudaStream_t stream) {
  const int K1P = (K1 + 7) / 8 * 8;
  if (warps < 1 || warps * 32 > kThreads || f_group < 1 || N < 2 ||
      B < 1 || F < 1 || P < 1 || K1 != (N + kK2 - 1) / kK2 ||
      !(span && slope && emax && valid) ||
      smem_bytes(sizeof(T), n_parts<T>(), K1P, warps) > 232448)
    return (int)cudaErrorInvalidValue;
  MxuParams<T> p{static_cast<const T*>(tab), N, K1, K1P,
                 static_cast<const T*>(mult), static_cast<const T*>(omm),
                 static_cast<const T*>(dmult), P,
                 static_cast<const T*>(freq), F, f_group,
                 static_cast<const T*>(span), static_cast<const T*>(slope),
                 static_cast<const T*>(emax),
                 static_cast<const uint8_t*>(valid),
                 static_cast<const T*>(alt_min), T(inv_dalt),
                 static_cast<T*>(out)};
  if (mode > 0) return launch<T, 1>(p, B, warps, stream);
  return launch<T, -1>(p, B, warps, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. mode: +1 O, -1 X. tab: [B, 128, K1] with
// K1 = ceil(N / 16). Returns the launch's cudaError_t (0 on success); does
// not synchronise.
int pyrayhf_ionogram_mxu(int dtype, int mode, const void* tab, int B, int N,
                         int K1, const void* mult, const void* omm,
                         const void* dmult, int P, const void* freq, int F,
                         int f_group, int warps, const void* span,
                         const void* slope, const void* emax,
                         const void* valid, const void* alt_min,
                         double inv_dalt, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(mode, tab, B, N, K1, mult, omm, dmult, P, freq, F,
                           f_group, warps, span, slope, emax, valid, alt_min,
                           inv_dalt, out, st);
  if (dtype == 1)
    return dispatch<double>(mode, tab, B, N, K1, mult, omm, dmult, P, freq,
                            F, f_group, warps, span, slope, emax, valid,
                            alt_min, inv_dalt, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
