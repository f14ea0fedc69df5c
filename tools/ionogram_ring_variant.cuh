// The persistent-grid variant of gather_kernel (csrc/ionogram.cu) that
// tools/ionogram_attribution.py times as "ring": a grid of (SMs x the
// blocks an SM holds) blocks walks the (profile, group) items, two table
// slots, the next item's table copied by TMA while the block works on the
// current one. Measured slower than a block per item (occupancy falls with
// the second slot, and every item ends in a block-wide barrier), so not
// kept in the kernel. The tool puts this text in place of gather_kernel.

// Kernels 2 (X solve, uniform) and 3 (host solve, uniform). Work items
// are (profile b, group g), item = b * n_groups + g; a persistent grid:
// block i takes items i, i + gridDim.x, ... Warp 0 copies an item's table
// into one of two slots (kernel 3: only if the item has a valid pair),
// the next item's while the block works on the current one.
template <typename T, int MODE, bool SOLVE>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 8 ? 4 : 1)
    gather_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* has = reinterpret_cast<int*>(smem_raw + 16);
  T* part = reinterpret_cast<T*>(smem_raw + 32);
  Solve<T>* solved = reinterpret_cast<Solve<T>*>(smem_raw + 96);
  T* const slots = reinterpret_cast<T*>(smem_raw + kHead);
  const int N = p.N, ld = p.ld, G = p.n_groups, P = p.P;
  const size_t slot_len = (size_t)kRows * ld;
  T* cfx = slots + 2 * slot_len;
  const int n_items = p.B * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp 0: copy item `item`'s table into slot `s`
  auto issue = [&](int item, int s) {
    const int b = item / G, g = item % G;
    int any = 1;
    if constexpr (!SOLVE) {
      any = 0;
      for (int fi = g + lane * G; fi < p.F; fi += 32 * G)
        any |= p.valid[(size_t)b * p.F + fi];
      any = __any_sync(kFull, any);
    }
    if (lane == 0) {
      has[s] = any;
      if (any) {
        T* dst = slots + s * slot_len;
        const T* src = p.tab + (size_t)b * p.C * ld;
        const unsigned bytes = (unsigned)(kRows * ld * sizeof(T));
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect(&bar[s], bytes);
        bulk_copy(dst, src, bytes, &bar[s]);
      }
    }
  };

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
  unsigned phase = 0;  // bit s: the parity slot s completes next

  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    const int s = it & 1;
    const int next = item + gridDim.x;
    if (warp == 0) {
      if (it == 0) issue(item, s);
      if (next < n_items) issue(next, s ^ 1);
    }
    __syncthreads();
    const int b = item / G, g = item % G;
    T* const out = p.out + (size_t)b * p.F;
    if (!has[s]) {  // no valid pair: NaN out, and no table was copied
      for (int fi = g + (int)threadIdx.x * G; fi < p.F;
           fi += (int)blockDim.x * G)
        out[fi] = T(NAN);
    } else {
      mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
      const T* tb = slots + s * slot_len;
      const T* alt = tb;
      const T* den = tb + 2 * ld;
      const T* dden = tb + 3 * ld;
      const T* bmg = tb + 4 * ld;
      const T* dbm = tb + 5 * ld;
      const T* bps = tb + 6 * ld;
      const T* dbp = tb + 7 * ld;
      if constexpr (SOLVE) cutoff_table(den, bmg, N, cfx, part);

      for (int fi = g + slot * G; fi < p.F; fi += slot_step * G) {
        const T f = p.freq[fi];
        const size_t o = (size_t)b * p.F + fi;
        Solve<T> sv;
        if constexpr (SOLVE) {
          if (p.per_block) {  // one warp solves, the block reads it
            if (warp == 0) {
              sv = xsolve_table(alt, den, bmg, cfx, N, f, lane, amin);
              if (lane == 0) *solved = sv;
            }
            __syncthreads();
            sv = *solved;
            __syncthreads();
          } else {
            sv = xsolve_table(alt, den, bmg, cfx, N, f, lane, amin);
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
          const int i0 = uniform_index(span * (p.mult[q] * p.inv_dalt), N,
                                       frac);
          const T d = den[i0] + frac * dden[i0];
          const T bmv = bmg[i0] + frac * dbm[i0];
          const T bpv = bps[i0] + frac * dbp[i0];
          acc += quad_term<T, MODE>(d, bmv, bpv, span, sv.slope, sv.emax, f,
                                    ff, p.dmult[q], p.omm[q], q, P);
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
    __syncthreads();  // the slot and the warp sums are free again
  }
}

