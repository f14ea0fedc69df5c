// Segment table of the in-kernel-solve ionogram kernels (1 and 2) on Hopper
// (sm_90a): one pass from the profiles to the table those kernels read.
//
// Replaces no TPU kernel. The JAX package leaves this table to XLA
// (pyrayhf_tpu/pallas_vh.py:994-1009 for O, :1026-1037 for X: _flat_extend,
// _pack_segment_table, cummax, concatenate, transpose). The port built it
// with ~35 PyTorch ops: the flat extension's argmax, gathers and wheres, the
// differences, pads and a [B, N, 8] stack, then a cat of the stack's
// transpose (read at a stride of 8 elements) with the running maximum. That
// composition stays as the plain version (pallas_vh.plain_segment_table),
// which CPU tensors take.
//
// What it writes, per profile b and node j < N, into tab [B, C, ld]
// (channel-major). x_t is x flat-extended at the first argmax m of den_b,
// as _flat_extend does: x_t[j] = x[j] for j < m, else x[max(m - 1, 0)].
// D x_t[j] = x_t[j + 1] - x_t[j], the last node repeating the one before.
//   0  alt_t[j] - alt_t[0]      1  1 / D alt_t[j], 0 unless D alt_t[j] > 0
//   2  den_t[j]    3  D den_t[j]     4  bmag_t[j]    5  D bmag_t[j]
//   6  bpsi_t[j]   7  D bpsi_t[j]    8  running maximum of den_t (C = 9)
// Nodes N <= j < ld (the 16-byte row padding of the bulk copies) are
// 0 in every channel. The argmax and the running maximum keep torch's
// semantics: NaN above every number and the first index among equal maxima;
// a NaN stays in the running maximum, and an element equal to it replaces
// it (of +0 and -0 the later one's sign is kept). Every value is a copy, an
// IEEE subtraction or an IEEE division (no fast math, -fmad=false), so the
// table is the plain version's bit for bit.
//
// Bound: memory. It reads den, bmag, bpsi [B, N] and alt [N] once and writes
// [B, C, ld] once: itemsize * (3 B N + N + B C ld) bytes, 0.626 GB at the
// global grid's B = 10,512, N = 620, C = 9 in f64, 0.187 ms at 3.35 TB/s.
// The plain version also writes and reads back ~1 GB of intermediates.
//
// Design. One block per profile, of the fewest warps that cover the row in
// as many chunks as 256 threads would (short rows: one warp). The block
// finds m by a warp-shuffle reduction of (value, index) and a pass over the
// warps' results in shared memory. Then it walks the row in chunks of
// blockDim nodes: thread t takes node j0 + t, reads x_t at j and at the two
// nodes of its difference (those reads hit L1: a neighbouring thread read
// the same nodes), and writes each channel as a run of consecutive nodes,
// so reads and writes are coalesced. The running maximum is a block scan
// per chunk (a warp-shuffle scan, the warps' totals in shared memory),
// carried from chunk to chunk. Nothing but the table reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// torch.argmax's order: whether (a, ia) comes before (b, ib), b a real
// element
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  return a == b ? ia < ib : a > b;
}

// fold the candidate (w, k) into the maximum (v, i); index -1 is no element
template <typename T>
__device__ __forceinline__ void take_max(T& v, int& i, T w, int k) {
  if (k >= 0 && (i < 0 || before(w, k, v, i))) {
    v = w;
    i = k;
  }
}

// torch.cummax's step from the running maximum acc to the next element x;
// it is associative, so a scan of it in any grouping gives the same bits
template <typename T>
__device__ __forceinline__ T run_max(T acc, T x) {
  return (isnan(x) || (!isnan(acc) && x >= acc)) ? x : acc;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
segment_table_pack(const T* __restrict__ den, long long sden,
                   const T* __restrict__ bmag, long long sbmag,
                   const T* __restrict__ bpsi, long long sbpsi,
                   const T* __restrict__ alt, int N, int C, int ld,
                   T* __restrict__ tab) {
  __shared__ T s_v[kMaxWarps];
  __shared__ int s_i[kMaxWarps];
  __shared__ T s_carry;
  __shared__ int s_m;
  const long long b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  den += b * sden;
  bmag += b * sbmag;
  bpsi += b * sbpsi;
  tab += b * C * ld;

  // m = argmax den
  T v = T(0);
  int i = -1;
  for (int j = t; j < N; j += nt) take_max(v, i, den[j], j);
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_down_sync(kAll, v, o);
    const int k = __shfl_down_sync(kAll, i, o);
    take_max(v, i, w, k);
  }
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < nw; ++w) take_max(v, i, s_v[w], s_i[w]);
    s_m = i;
    s_carry = den[0];   // den_t[0] = den[0] whatever m is
  }
  __syncthreads();
  const int m = s_m, last = m > 0 ? m - 1 : 0;
  const T alt0 = alt[0];

  for (int j0 = 0; j0 < ld; j0 += nt) {
    const int j = j0 + t;
    T c[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    T x = T(-INFINITY);   // adds nothing to a running maximum
    if (j < N) {
      const int lo = j < N - 1 ? j : N - 2;
      const int k = j < m ? j : last;
      const int k0 = lo < m ? lo : last;
      const int k1 = lo + 1 < m ? lo + 1 : last;
      const T dalt = alt[k1] - alt[k0];
      c[0] = alt[k] - alt0;
      c[1] = dalt > T(0) ? T(1) / dalt : T(0);
      c[2] = den[k];
      c[3] = den[k1] - den[k0];
      c[4] = bmag[k];
      c[5] = bmag[k1] - bmag[k0];
      c[6] = bpsi[k];
      c[7] = bpsi[k1] - bpsi[k0];
      x = c[2];
    }
    if (C > 8) {
      T s = x;
      for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(kAll, s, o);
        if (lane >= o) s = run_max(y, s);
      }
      if (lane == 31) s_v[warp] = s;
      __syncthreads();
      T acc = s_carry;
      for (int w = 0; w < warp; ++w) acc = run_max(acc, s_v[w]);
      s = run_max(acc, s);
      __syncthreads();             // every thread has read s_v and s_carry
      if (t == nt - 1) s_carry = s;
      if (j < N) c[8] = s;
    }
    if (j < ld) {
#pragma unroll
      for (int ch = 0; ch < 9; ++ch)
        if (ch < C) tab[(long long)ch * ld + j] = c[ch];
    }
  }
}

template <typename T>
int launch(const void* den, long long sden, const void* bmag,
           long long sbmag, const void* bpsi, long long sbpsi,
           const void* alt, int B, int N, int C, int ld, void* tab,
           cudaStream_t stream) {
  // the chunks 256 threads would take, over the fewest warps that do it
  const int chunks = (N + kMaxThreads - 1) / kMaxThreads;
  const int warps = (N + 32 * chunks - 1) / (32 * chunks);
  segment_table_pack<T><<<B, warps * 32, 0, stream>>>(
      static_cast<const T*>(den), sden, static_cast<const T*>(bmag), sbmag,
      static_cast<const T*>(bpsi), sbpsi, static_cast<const T*>(alt), N, C,
      ld, static_cast<T*>(tab));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. den, bmag, bpsi: B rows of N elements at
// unit stride, row strides sden, sbmag, sbpsi in elements (0: one row for
// every profile); alt [N] at unit stride. C: 9 (kernel 1's table, with the
// running maximum) or 8 (kernel 2's); tab [B, C, ld], ld >= N.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
int pyrayhf_segment_table(int dtype, const void* den, long long sden,
                          const void* bmag, long long sbmag,
                          const void* bpsi, long long sbpsi, const void* alt,
                          int B, int N, int C, int ld, void* tab,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 2 || (C != 8 && C != 9) || ld < N || sden < 0 ||
      sbmag < 0 || sbpsi < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(den, sden, bmag, sbmag, bpsi, sbpsi, alt, B, N, C,
                         ld, tab, st);
  if (dtype == 1)
    return launch<double>(den, sden, bmag, sbmag, bpsi, sbpsi, alt, B, N, C,
                          ld, tab, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
