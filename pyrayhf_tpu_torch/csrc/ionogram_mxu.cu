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
// What bounds it. The function is kernel 3's (ionogram.cu with the host
// solve on a uniform grid): the mu' tail, ~115 scalar operations a grid
// point, bounds both. A one-hot product is a gather at one useful
// multiply-add in 128, so products taken over the whole table (all 16
// N-tiles, all K-steps, for every 32 points, as this kernel's first form
// took them) needed 2.5 ms of TF32 tensor-core time alone at O-200
// (B = 1024, F = 175, P = 200) and made the kernel ~11x kernel 3. But a
// tile of consecutive grid points of one frequency selects a narrow band
// of the table: i0 never decreases along p (mult increases), and the
// stretched grid crowds the points near the reflection height, so most
// tiles span one or two one-hot columns and a few offsets.
//
// Design. One block per (profile, frequency group) and one warp per
// frequency, as in ionogram.cu. The profile's table sits in shared memory
// (row stride K1P + 4, K1P = K1 rounded up to 8, zeros beyond K1). A
// frequency the host solve marks invalid writes NaN and does nothing else
// (vh is NaN there whatever the sum). A warp resamples 32 grid points at a
// time; each lane forms its own point's i0 and frac once. Per tile of
// kTile consecutive points the warp reduces the one-hot columns a_lo..a_hi
// its points select and the set of their offsets bb (__reduce_min/max/
// or_sync; points past P take no part), and issues products only for the
// K-steps that hold a_lo..a_hi and the N-tiles (one per offset bb, each
// holding the 8 channels) of the offsets present. The band comes from the
// indices themselves, not from their monotonicity: any span, NaN
// included, gives indices in [0, N-2] and a band that holds them. The
// one-hot operand is built in registers (points are the M dimension, K
// runs over a), never read from memory. The fold is a register select: a
// thread keeps the accumulator tile whose N-tile index equals its point's
// bb, so the four threads of a quad hold channels 0..7 of the point's
// segment row. Threads 1..3 of each quad put channels 2..7 into the warp's
// shared scratch and each lane finishes its point, in the lane-strided
// order of ionogram.cu, so the sums add in the same order as kernel 3's.
// On the O-200 inputs (chip_smoke.py counts them) the products left are
// 4.3e6 (N-tile, K-step) pairs against 1.0e8, 0.054 ms of TF32 tensor-core
// time against 2.49. Bands of 16 points beat bands of 32 (three mma a pair
// against six outweigh twice the reductions). What bounds the kernel now
// is kernel 3's work on the valid frequencies, the index and the mu' tail,
// and the products' per-pair overhead (shared loads, one-hot selects):
// ~0.32 of ~0.95 ms in f32, hidden by the tail in f64 (NVIDIA H100 80GB
// HBM3, 700 W; tools/mxu_attribution.py). mma.sync, not wgmma: a band
// issues a handful of m16n8k8 whose N-tiles vary from band to band, while
// a wgmma tile is 64 points (a wider band) with N fixed at compile time.
//
//   f64: mma.sync m8n8k4 (DMMA) over m8 tiles of points, K-steps of 4; IEEE
//        products and sums, and the one-hot makes each output equal to the
//        table entry exactly.
//   f32: mma.sync m16n8k8 TF32 over m16 tiles, K-steps of 8, on the table
//        split into three exact TF32 parts (hi, mid, lo: truncations to 10
//        explicit mantissa bits of the value and of its remainders). Each
//        part goes through its own accumulator, so every tensor-core sum is
//        one exact product plus zeros, and (hi + mid) + lo restores the f32
//        entry exactly (the TPU's Precision.HIGHEST splits into bf16 parts
//        to the same end). A skipped product is 0 times a table entry, so
//        the outputs stay kernel 3's bit for bit.
//   Shared memory: 128 x 44 x 4 B x 3 = 66 KB (f32), 44 KB (f64) at
//   N = 620, plus 6 x 32 values of scratch per warp.
//
// Built without fast math and with -fmad=false. tools/mxu_attribution.py
// times this kernel against its first form, by parts of the design.

#include "ionogram_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK2 = 16;           // segment offsets per one-hot column
constexpr int kRows = kK2 * 8;    // table rows: 16 offsets x 8 channels
constexpr int kPad = 4;           // row padding of the shared table (banks)
constexpr int kScratch = 6 * 32;  // channels 2..7 of 32 points, per warp
constexpr int kTile = 16;         // points per band: 16 or 32
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

// The band of tile t of a chunk: the one-hot columns lo..hi its points
// select and the offsets among them (bit bb of nmask), reduced over the
// warp from each lane's own segment i0 (-1 past P: no part). An empty
// tile gives lo > hi and nmask 0.
struct Band {
  int lo, hi;
  unsigned nmask;
};

__device__ __forceinline__ Band tile_band(int i0, int lane, int t) {
  const bool mine = i0 >= 0 && lane / kTile == t;
  Band b;
  b.lo = __reduce_min_sync(kFull, mine ? i0 / kK2 : 0x7fffffff);
  b.hi = __reduce_max_sync(kFull, mine ? i0 / kK2 : -1);
  b.nmask = __reduce_or_sync(kFull, mine ? 1u << (i0 % kK2) : 0u);
  return b;
}

// one-hot column a and offset bb of the point in the lane's row ``src``
// (a = -1, bb = -1 past P: a zero one-hot row, kept by no N-tile)
__device__ __forceinline__ void row_index(int i0, int src, int& a, int& bb) {
  const int i = __shfl_sync(kFull, i0, src);
  a = i >= 0 ? i / kK2 : -1;
  bb = i >= 0 ? i % kK2 : -1;
}

// f32: the segment rows of grid points c0 .. c0+31 of one frequency (two
// m16 tiles of points), i0 the lane's own point's segment; writes channels
// 2..7 of each point's row to scr[(c - 2) * 32 + j].
__device__ void onehot_chunk(const float* st, int S, int i0, float* scr,
                             int lane) {
  constexpr int kM = kTile / 16;  // m16 tiles per band
  const int gid = lane >> 2, tig = lane & 3;
  const int plane = kRows * S;
  int ai[2][2], bi[2][2];  // [m16 tile][row gid / gid + 8]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_index(i0, mt * 16 + h * 8 + gid, ai[mt][h], bi[mt][h]);
  float keep[2][4] = {};
#pragma unroll
  for (int t = 0; t < 32 / kTile; ++t) {
    const Band band = tile_band(i0, lane, t);
    const int k_end = band.hi & ~7;
    for (unsigned m = band.nmask; m != 0u; m &= m - 1u) {
      const int nt = __ffs(m) - 1;
      float acc[3][kM][4] = {};
      const int row = (nt * 8 + gid) * S + tig;
      for (int k0 = band.lo & ~7; k0 <= k_end; k0 += 8) {
        uint32_t b[3][2];
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          b[part][0] = __float_as_uint(st[part * plane + row + k0]);
          b[part][1] = __float_as_uint(st[part * plane + row + k0 + 4]);
        }
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          const int mt = t * kM + j;
          const uint32_t a[4] = {k0 + tig == ai[mt][0] ? kOne : 0u,
                                 k0 + tig == ai[mt][1] ? kOne : 0u,
                                 k0 + tig + 4 == ai[mt][0] ? kOne : 0u,
                                 k0 + tig + 4 == ai[mt][1] ? kOne : 0u};
#pragma unroll
          for (int part = 0; part < 3; ++part)
            mma_tf32(acc[part][j], a, b[part][0], b[part][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kM; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (bi[t * kM + j][h] == nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 2 * h + c;
              keep[t * kM + j][i] =
                  (acc[0][j][i] + acc[1][j][i]) + acc[2][j][i];
            }
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

// f64: the same with four m8 tiles of points, K-steps of 4, one DMMA pass
__device__ void onehot_chunk(const double* st, int S, int i0, double* scr,
                             int lane) {
  constexpr int kM = kTile / 8;  // m8 tiles per band
  const int gid = lane >> 2, tig = lane & 3;
  int ai[4], bi[4];  // [m8 tile], row gid
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) row_index(i0, mt * 8 + gid, ai[mt], bi[mt]);
  double keep[4][2] = {};
#pragma unroll
  for (int t = 0; t < 32 / kTile; ++t) {
    const Band band = tile_band(i0, lane, t);
    const int k_end = band.hi & ~3;
    for (unsigned m = band.nmask; m != 0u; m &= m - 1u) {
      const int nt = __ffs(m) - 1;
      double acc[kM][2] = {};
      const int row = (nt * 8 + gid) * S + tig;
      for (int k0 = band.lo & ~3; k0 <= k_end; k0 += 4) {
        const double b = st[row + k0];
#pragma unroll
        for (int j = 0; j < kM; ++j)
          mma_f64(acc[j], k0 + tig == ai[t * kM + j] ? 1.0 : 0.0, b);
      }
#pragma unroll
      for (int j = 0; j < kM; ++j)
        if (bi[t * kM + j] == nt) {
          keep[t * kM + j][0] = acc[j][0];
          keep[t * kM + j][1] = acc[j][1];
        }
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
    const size_t o = (size_t)b * p.F + fi;
    const bool valid = p.valid[o] != 0;
    if (!valid) {  // the ray escapes: vh is NaN, no products, no tail
      if (lane == 0) p.out[o] = T(NAN);
      continue;
    }
    const T f = p.freq[fi];
    const T span = p.span[o];
    const T slope = p.slope[o];
    const T emax = p.emax[o];
    const T ff = f * f;
    T acc = T(0);
    for (int c0 = 0; c0 < p.P; c0 += 32) {
      const int q = c0 + lane;
      T frac = T(0);
      const int i0 =
          q < p.P ? uniform_index(span * (p.mult[q] * p.inv_dalt), p.N, frac)
                  : -1;
      onehot_chunk(st, S, i0, scr, lane);
      __syncwarp();
      if (q < p.P) {
        const T d = scr[lane] + frac * scr[32 + lane];
        const T bmv = scr[64 + lane] + frac * scr[96 + lane];
        const T bpv = scr[128 + lane] + frac * scr[160 + lane];
        acc += quad_term<T, MODE>(d, bmv, bpv, span, slope, emax, f, ff,
                                  p.dmult[q], p.omm[q], q, p.P);
      }
      __syncwarp();
    }
    acc = warp_sum(acc);
    if (lane == 0) p.out[o] = (valid && acc != T(0)) ? acc + amin : T(NAN);
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
