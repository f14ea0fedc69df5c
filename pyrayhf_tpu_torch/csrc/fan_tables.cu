// The 2-D fan's tables on Hopper (sm_90a): from the slice (Ne, |B|, psi,
// nu) straight to the node-major records csrc/fan2d.cu reads.
//
// Replaces no TPU kernel. The JAX package leaves the fields and the tables
// to XLA (pyrayhf_tpu/oblique.py:303-330, the broadcast Appleton-Hartree
// fields; pyrayhf_tpu/pallas_ray.py:373-395, the gradients and the stack).
// The port built them with ~444 PyTorch ops: oblique._fan_fields (X, Y,
// mu, mu', kappa over [F, nz, nx], ~200 elementwise ops) and
// pallas_ray.pack_tables (gradient_ord2's narrows and cat, the stack of the
// records, the copy of the kappa plane). That composition stays as the
// plain version (pallas_ray.fan_tables on CPU tensors).
//
// What it writes, for frequency q and node (i, j) of the [nz, nx] slice,
// into tab: the record [F, nz, nx, 4] (mu, dmu/dc0, dmu/dc1, mu'), then the
// kappa plane [F, nz, nx], pallas_ray.table_views' layout. mu and mu' are
// magnetoionic._find_mu_mup's (the O mode by the cancellation-free branch,
// its Xm1 == 0 residue included; X by the naive D; mu > 1 is NaN; mu' by
// the analytic derivatives, unsanitised), kappa is absorption_coefficient's
// with nu(z) along x, 0 where not finite. The unmagnetised branch is
// decided once over the whole [F, nz, nx] Y, NaN aside, as
// _nanmax_abs_below decides it: fan_tables_unmag reads |B| and the
// frequencies and sets a flag on the card (bit 0: some |Y| is a number, bit
// 1: some |Y| >= y_tol) that the table kernel reads; no Y is stored. The
// gradients are gradient_ord2's stencils on the axes rebuilt in the
// working type, c_k = o + k / inv_d: second-order central differences
// inside, second-order one-sided ones on the four edges with the third
// node clamped as grad_axis_ord2 clamps it. Every expression keeps the
// plain version's order and every quotient and root is the IEEE one (no
// fast math, -fmad=false); the Python constants arrive as the doubles
// Python forms and are cast to the working type as torch casts a scalar.
// So the table is the plain version's bit for bit.
//
// Bound. The output: 5 F nz nx elements, 1.27 GB at the benchmark's 64 x
// 621 x 800 in f64, 0.38 ms at 3.35 TB/s (the slice's inputs are 12 MB).
// The arithmetic: 31.8 M node-frequencies of ~96 operations each, every
// add, multiply, division, root and comparison as one (X and Y 2, mu ~26,
// mu' ~35, kappa ~12, the two gradients ~12, mu on the tile's halo ~9:
// chip_smoke.py's FAN_TABLE_OPS), 0.09 ms at 34 TFLOP/s. Issued as f64
// instructions they are ~250 a node-frequency, as each of the ~14 IEEE
// divisions and roots is a MUFU seed, ~8-10 DFMA refinements and a
// range-check branch: ~0.5 ms at 132 SMs x 64 f64 lanes x 1.98 GHz. So
// the bytes bound it, the f64 issue close behind. The plain version
// writes and reads back ~35 GB of intermediates.
//
// Design. A block takes a tile of kTz x kTx nodes (a warp per tile row, so
// loads and stores run along x) and a chunk of the frequencies. It forms
// each node's frequency-free terms once ((sqrt(Ne) CP)^2, G_P |B|, sin and
// cos psi, omega_p^2 nu, omega_L, nu^2) and keeps them in registers across
// its frequencies. Per frequency, each thread computes mu, mu' and kappa at
// its node and mu at one node of the tile's halo (the row above and below,
// the column left and right; a second one beside a last edge tile one node
// deep), into a double-buffered shared tile, then, after one barrier, its
// two gradients from the shared tile, and stores its record as two 16-byte
// vectors (one in f32), neighbouring threads on neighbouring nodes, and its
// kappa. No [F, nz, nx] intermediate reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kTx = 32;                 // tile width (x), one warp
constexpr int kTz = 8;                  // tile height (z), warps a block
constexpr int kThreads = kTx * kTz;
constexpr int kSw = kTx + 4;            // shared tile row: a 2-node halo
constexpr int kSh = kTz + 4;
constexpr int kTargetBlocks = 4096;     // frequency chunks fill the card
constexpr int kFlagBlocks = 264;

// the Python constants, as the plain version's expressions form them
// (scalars[4..12] of the C entry), in the working type
template <typename T>
struct Consts {
  T cp, gp, deg2rad, two_pi, k_p, k_l, c2, db, y_tol;
};

// the frequency-free terms of a node that mu needs
template <typename T>
struct Terms {
  T s2, gb, sinp, cosp;
};

template <typename T>
__device__ __forceinline__ Terms<T> terms(T ne, T babs, T bpsi,
                                          const Consts<T>& k) {
  const T s = sqrt(ne) * k.cp;
  const T psi = bpsi * k.deg2rad;
  return {s * s, k.gp * babs, sin(psi), cos(psi)};
}

// magnetoionic._find_mu_mup at one node and frequency (f2 = f * f); with
// kMup also mu' into *mup
template <typename T, bool kX, bool kMup>
__device__ __forceinline__ T mu_mup(const Terms<T>& n, T f, T f2,
                                    bool unmag, T* mup) {
  const T nan = T(NAN);
  const T X = n.s2 / f2;
  if (unmag) {
    const T mu2 = T(1) - X;
    const T mu = mu2 > T(0) ? sqrt(mu2) : nan;
    if (kMup) *mup = isfinite(mu) && mu > T(0) ? T(1) / mu : nan;
    return mu;
  }
  const T Y = n.gb / f;
  const T YT = Y * n.sinp, YL = Y * n.cosp, Xm1 = T(1) - X;
  const T yt2 = YT * YT, yl2 = YL * YL, xm2 = Xm1 * Xm1;
  const T alpha = T(0.25) * (yt2 * yt2) + yl2 * xm2;
  const T beta = sqrt(alpha);
  T Ds, under;
  if (!kX) {
    // cancellation-free O branch: D = (1 - X) + s, s = YL^2 (1-X)^2 /
    // (beta + YT^2 / 2); at Xm1 == 0 the naive form's residue
    const T bsum = beta + T(0.5) * yt2;
    const T s = bsum > T(0) ? yl2 * xm2 / bsum : T(0);
    const T D = Xm1 == T(0) ? (Xm1 - T(0.5) * yt2) + beta : Xm1 + s;
    const bool d_ok = D != T(0);
    Ds = d_ok ? D : T(1);
    under = Xm1 == T(0) ? T(1) - X * Xm1 / Ds : (xm2 + s) / Ds;
    if (!d_ok) under = nan;
  } else {
    Ds = (Xm1 - T(0.5) * yt2) - beta;
    under = T(1) - X * Xm1 / Ds;
  }
  T mu = sqrt(under < T(0) ? nan : under);
  if (mu > T(1)) mu = nan;
  if (kMup) {
    const T dbetadX = -yl2 * Xm1 / beta;
    const T dDdX = (kX ? -dbetadX : dbetadX) + T(-1);
    const T dalphadY = YT * yt2 * n.sinp + T(2) * YL * xm2 * n.cosp;
    const T dbetadY = T(0.5) * dalphadY / beta;
    const T dDdY = -YT * n.sinp + (kX ? -dbetadY : dbetadY);
    const T dmudY = X * Xm1 * dDdY / (T(2) * mu * (Ds * Ds));
    const T dmudX = T(1) / (T(2) * mu * Ds)
                    * (T(2) * X - T(1) + X * Xm1 / Ds * dDdX);
    *mup = mu - (T(2) * X * dmudX + Y * dmudY);
  }
  return mu;
}

// grad_axis_ord2's stencil at node k of an n-node axis c_k = o + k / inv_d:
// the weights, the interior's divisor, the three nodes' offsets
template <typename T>
struct Stencil {
  T w0, w1, w2, den;
  int a, b, c;
};

template <typename T>
__device__ Stencil<T> stencil(int k, int n, T o, T inv_d) {
  auto c = [&](int m) { return o + T(m) / inv_d; };
  if (k > 0 && k < n - 1) {
    const T hs = c(k) - c(k - 1), hd = c(k + 1) - c(k);
    return {hs * hs, hs * hs - hd * hd, hd * hd, hs * hd * (hs + hd),
            1, 0, -1};
  }
  if (k == 0) {
    const T h0 = c(1) - c(0), h1 = n > 2 ? c(2) - c(1) : h0;
    return {-(T(2) * h0 + h1) / (h0 * (h0 + h1)), (h0 + h1) / (h0 * h1),
            -h0 / (h1 * (h0 + h1)), T(1), 0, 1, n > 2 ? 2 : 1};
  }
  const T hm1 = c(n - 1) - c(n - 2), hm2 = n > 2 ? c(n - 2) - c(n - 3) : hm1;
  return {(T(2) * hm1 + hm2) / (hm1 * (hm1 + hm2)),
          -(hm1 + hm2) / (hm1 * hm2), hm1 / (hm2 * (hm1 + hm2)), T(1), 0, -1,
          n > 2 ? -2 : -1};
}

// the gradient at shared-tile index p along a stride of `step` elements:
// interior ((w0 f+ - w1 f0) - w2 f-) / den, edges (w0 fa + w1 fb) + w2 fc
template <typename T>
__device__ __forceinline__ T gradient(const Stencil<T>& s, const T* m, int p,
                                      int step) {
  const T fa = m[p + s.a * step], fb = m[p + s.b * step],
          fc = m[p + s.c * step];
  if (s.b == 0) return (s.w0 * fa - s.w1 * fb - s.w2 * fc) / s.den;
  return s.w0 * fa + s.w1 * fb + s.w2 * fc;
}

template <typename T>
__device__ __forceinline__ void store_record(T* p, T a, T b, T c, T d);

template <>
__device__ __forceinline__ void store_record<double>(double* p, double a,
                                                     double b, double c,
                                                     double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

template <>
__device__ __forceinline__ void store_record<float>(float* p, float a,
                                                    float b, float c,
                                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// the halo node (i, j) thread t computes mu at: the row above and the row
// below the tile's columns, the column left and right of its rows, and the
// second row (column) beside a last edge tile one node deep, whose
// one-sided stencil reaches two nodes back
__device__ bool halo_node(int t, int r0, int r1, int c0, int c1, int nz,
                          int nx, int& i, int& j) {
  const int nr = r1 - r0, nc = c1 - c0;
  const int runs[6][2] = {
      {r0 > 0 ? nc : 0, 0}, {r1 < nz ? nc : 0, 1},
      {c0 > 0 ? nr : 0, 2}, {c1 < nx ? nr : 0, 3},
      {nr == 1 && r1 == nz && nz > 2 ? nc : 0, 4},
      {nc == 1 && c1 == nx && nx > 2 ? nr : 0, 5}};
  for (const auto& run : runs) {
    if (t >= run[0]) {
      t -= run[0];
      continue;
    }
    switch (run[1]) {
      case 0: i = r0 - 1; j = c0 + t; break;
      case 1: i = r1; j = c0 + t; break;
      case 2: i = r0 + t; j = c0 - 1; break;
      case 3: i = r0 + t; j = c1; break;
      case 4: i = r0 - 2; j = c0 + t; break;
      default: i = r0 + t; j = c0 - 2; break;
    }
    return true;
  }
  return false;
}

// the unmagnetised branch's flag over every (frequency, node): bit 0 some
// |G_P |B| / f| is a number, bit 1 some is >= y_tol (then the branch is
// the magnetised one whatever else is seen, and every warp stops)
template <typename T>
__global__ void __launch_bounds__(kThreads)
fan_tables_unmag(const T* __restrict__ babs, long long n,
                 const T* __restrict__ f0s, int F, T gp, T y_tol,
                 int* flag) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    int seen = lane == 0 ? *reinterpret_cast<volatile int*>(flag) : 0;
    if (__shfl_sync(kAll, seen, 0) & 2) return;
    const long long k = base + threadIdx.x;
    int bits = 0;
    if (k < n) {
      const T gb = gp * babs[k];
      for (int q = 0; q < F && !(bits & 2); ++q) {
        const T a = fabs(gb / f0s[q]);
        if (!isnan(a)) bits |= a >= y_tol ? 3 : 1;
      }
    }
    const unsigned any = __ballot_sync(kAll, bits & 1);
    const unsigned big = __ballot_sync(kAll, bits & 2);
    if (lane == 0 && any) atomicOr(flag, big ? 3 : 1);
  }
}

template <typename T, bool kX>
__global__ void __launch_bounds__(kThreads)
fan_tables_kernel(const T* __restrict__ ne, const T* __restrict__ babs,
                  const T* __restrict__ bpsi, const T* __restrict__ nu,
                  const T* __restrict__ f0s, int F, int f_chunk, int nz,
                  int nx, int tiles_x, T o0, T inv_d0, T o1, T inv_d1,
                  Consts<T> k, const int* __restrict__ flag,
                  T* __restrict__ tab) {
  __shared__ T s_mu[2][kSh * kSw];
  const int t = threadIdx.x, tx = t % kTx, tz = t / kTx;
  const int r0 = (blockIdx.x / tiles_x) * kTz;
  const int c0 = (blockIdx.x % tiles_x) * kTx;
  const int r1 = min(r0 + kTz, nz), c1 = min(c0 + kTx, nx);
  const int q0 = blockIdx.y * f_chunk, q1 = min(q0 + f_chunk, F);
  const bool unmag = *flag == 1;

  const int i = r0 + tz, j = c0 + tx;
  const bool own = i < nz && j < nx;
  const int p = (tz + 2) * kSw + tx + 2;
  Terms<T> me{};
  T onu = T(0), omega_l = T(0), nu2 = T(0);
  Stencil<T> g0s{}, g1s{};
  if (own) {
    const long long v = (long long)i * nx + j;
    const T b = babs[v], nu_i = nu[i];
    me = terms(ne[v], b, bpsi[v], k);
    onu = k.k_p * ne[v] * nu_i;
    omega_l = k.k_l * b * fabs(me.cosp);
    nu2 = nu_i * nu_i;
    g0s = stencil(i, nz, o0, inv_d0);
    g1s = stencil(j, nx, o1, inv_d1);
  }
  int hi, hj;
  const bool halo = halo_node(t, r0, r1, c0, c1, nz, nx, hi, hj);
  Terms<T> ht{};
  int hp = 0;
  if (halo) {
    const long long v = (long long)hi * nx + hj;
    ht = terms(ne[v], babs[v], bpsi[v], k);
    hp = (hi - r0 + 2) * kSw + hj - c0 + 2;
  }

  const long long plane = (long long)nz * nx;
  T* kap = tab + 4 * plane * F;
  for (int q = q0; q < q1; ++q) {
    T* m = s_mu[q & 1];
    const T f = f0s[q], f2 = f * f;
    T mu, mup, kappa;
    if (own) {
      mu = mu_mup<T, kX, true>(me, f, f2, unmag, &mup);
      const T omega = k.two_pi * f;
      const T mu_s = mu > T(0) ? mu : T(NAN);
      const T w = omega + (kX ? -omega_l : omega_l);
      kappa = onu / (k.c2 * mu_s * (w * w + nu2)) * T(1e3) * k.db;
      if (!isfinite(kappa)) kappa = T(0);
      m[p] = mu;
    }
    if (halo) m[hp] = mu_mup<T, kX, false>(ht, f, f2, unmag, nullptr);
    __syncthreads();
    if (own) {
      const long long v = q * plane + (long long)i * nx + j;
      store_record(tab + 4 * v, mu, gradient(g0s, m, p, kSw),
                   gradient(g1s, m, p, 1), mup);
      kap[v] = kappa;
    }
  }
}

template <typename T>
int launch(int x_mode, const void* ne, const void* babs, const void* bpsi,
           const void* nu, const void* f0s, int F, int nz, int nx,
           const double* s, int* flag, void* tab, cudaStream_t st) {
  const Consts<T> k{T(s[4]), T(s[5]),  T(s[6]),  T(s[7]), T(s[8]),
                    T(s[9]), T(s[10]), T(s[11]), T(s[12])};
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nz * nx;
  const long long flag_blocks = (n + kThreads - 1) / kThreads;
  fan_tables_unmag<T><<<(int)(flag_blocks < kFlagBlocks ? flag_blocks
                                                         : kFlagBlocks),
                         kThreads, 0, st>>>(
      static_cast<const T*>(babs), n, static_cast<const T*>(f0s), F, k.gp,
      k.y_tol, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (nx + kTx - 1) / kTx;
  const long long tiles = (long long)tiles_x * ((nz + kTz - 1) / kTz);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long chunks = (kTargetBlocks + tiles - 1) / tiles;
  if (chunks > F) chunks = F;
  const int f_chunk = (int)((F + chunks - 1) / chunks);
  const dim3 grid((unsigned)tiles, (unsigned)((F + f_chunk - 1) / f_chunk));
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(ne), static_cast<const T*>(babs),
        static_cast<const T*>(bpsi), static_cast<const T*>(nu),
        static_cast<const T*>(f0s), F, f_chunk, nz, nx, tiles_x, T(s[0]),
        T(s[1]), T(s[2]), T(s[3]), k, flag, static_cast<T*>(tab));
  };
  if (x_mode)
    go(fan_tables_kernel<T, true>);
  else
    go(fan_tables_kernel<T, false>);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64. x_mode: 0 O, 1 X. ne, babs, bpsi [nz, nx]
// and nu [nz], f0s [F], contiguous. scalars: 13 doubles (o0, inv_d0, o1,
// inv_d1, CP, G_P, deg2rad, 2 pi, (2 pi CP)^2, 2 pi G_P, 2 c [m/s], dB per
// neper, y_tol), cast to the working type in the kernel. flag: one int of
// scratch on the card. tab: 5 F nz nx elements, 16-byte aligned. Launches
// a memset, the flag kernel and the table kernel on `stream`; returns the
// first cudaError_t (0 on success); does not synchronise.
int pyrayhf_fan_tables(int dtype, int x_mode, const void* ne,
                       const void* babs, const void* bpsi, const void* nu,
                       const void* f0s, int F, int nz, int nx,
                       const double* scalars, void* flag, void* tab,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || nz < 2 || nx < 2) return (int)cudaErrorInvalidValue;
  int* fl = static_cast<int*>(flag);
  if (dtype == 0)
    return launch<float>(x_mode, ne, babs, bpsi, nu, f0s, F, nz, nx, scalars,
                         fl, tab, st);
  if (dtype == 1)
    return launch<double>(x_mode, ne, babs, bpsi, nu, f0s, F, nz, nx,
                          scalars, fl, tab, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
