// Multi-hop pair advance (Alg. 2 UpdateWalk) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `pair_advance_kernel` in
// src/repro/kernels/pair_advance.py (wrapper `fused_advance_pair`), and is
// held bit for bit against the plain PyTorch version
// `repro_torch.engines.step.pair_advance_ref`.
//
// What bounds it on an H100: neither the bytes it must move nor its
// operations.  Each hop of a lane is a chain of dependent random gathers
// into the resident pair (remap binary search -> indptr -> proposal ->
// alias -> neighbour -> membership binary search), so it is bound by memory
// latency.  The pair (two blocks, up to a few MB) does not fit in one
// block's shared memory the way the TPU kernel pinned it in VMEM, so it is
// read from global memory through L2 (50 MB holds a whole pair).
//
// Design, simple and correct first:
//  * One thread per walk lane; the thread loops over hops and exits as soon
//    as its lane stops being resident.  That is exact: a frozen lane keeps
//    its cur and alive, so it never becomes resident again.  The TPU tile's
//    masked while-loop (`any(resident)`) becomes a per-thread early exit,
//    and many warps in flight hide the gather latency.
//  * Rejection rounds stop at the first accepted proposal, the membership
//    search is skipped where the bias does not depend on it (hop 0, z ==
//    prev), and a search stops once its range is empty; none of these
//    change a result.
//  * Threefry-2x32 in native uint32, keyed (base, walk id, hop, round).
//  * Every gather clamps its index to [0, len-1], as jnp indexing does.
//  * No division on the device: the three acceptance thresholds come in as
//    float32 computed on the host exactly as the reference rounds them.
//    Built without --use_fast_math so nothing is contracted or approximated.
//  * The wrapper pre-fills the [N, max_len+1] trace with -1; frozen lanes
//    write nothing (the TPU kernel's dump column is not needed).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: the reference's repro/kernels/rng.py.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                                             uint32_t& out0, uint32_t& out1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const int inject[5][3] = {{1, 2, 1}, {2, 0, 2}, {0, 1, 3}, {1, 2, 4}, {2, 0, 5}};
  uint32_t y0 = x0 + ks[0];
  uint32_t y1 = x1 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y0 += y1;
      y1 = rotl(y1, rot[g & 1][i]) ^ y0;
    }
    y0 += ks[inject[g][0]];
    y1 += ks[inject[g][1]] + (uint32_t)inject[g][2];
  }
  out0 = y0;
  out1 = y1;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ int clampi(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// Lower bound of z in sorted flat[lo:hi] with at most `iters` halvings, the
// reference's fixed-iteration search (mid = (lo+hi)/2, guarded by lo < hi).
__device__ __forceinline__ int lower_bound(const int* __restrict__ flat, int n, int lo, int hi,
                                           int z, int iters, bool& found) {
  const int hi0 = hi;
  for (int t = 0; t < iters && lo < hi; ++t) {
    const int mid = (lo + hi) / 2;
    if (__ldg(flat + clampi(mid, n)) < z) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  found = (lo < hi0) && (__ldg(flat + clampi(lo, n)) == z);
  return lo;
}

struct Pair {
  const int* vids;
  const int* indptr;
  const int* indices;
  const int* alias_j;
  const float* alias_q;
  int sv, sp, se, sa;
  int nv0, nv1, vb0, vb1, pb0, pb1, ib0, ib1;
};

// Global vertex -> (slot, compact row, found) through the two vids remaps;
// a miss falls back to slot 1 at its insertion row, clamped at 0.
__device__ __forceinline__ bool locate(const Pair& P, int v, int v_iters, int& slot, int& row) {
  bool f0, f1 = false;
  const int r0 = lower_bound(P.vids, P.sv, P.vb0, P.vb0 + P.nv0, v, v_iters, f0);
  if (f0) {
    slot = 0;
    row = r0 - P.vb0;
  } else {
    const int r1 = lower_bound(P.vids, P.sv, P.vb1, P.vb1 + P.nv1, v, v_iters, f1);
    slot = 1;
    row = r1 - P.vb1;
  }
  row = row < 0 ? 0 : row;
  return f0 || f1;
}

template <int ORDER, bool HAS_ALIAS>
__global__ void __launch_bounds__(256) pair_advance_kernel(
    Pair P, const int* __restrict__ nverts, const int* __restrict__ vid_base,
    const int* __restrict__ ptr_base, const int* __restrict__ ind_base,
    const int* __restrict__ wid_in, const int* __restrict__ prev_in, const int* __restrict__ cur_in,
    const int* __restrict__ hop_in, const bool* __restrict__ alive_in, int* __restrict__ prev_out,
    int* __restrict__ cur_out, int* __restrict__ hop_out, bool* __restrict__ alive_out,
    int* __restrict__ trace, int* __restrict__ steps, int n, uint32_t key0, uint32_t key1,
    int length, float decay, float acc_ret, float acc_nbr, float acc_away, int k_max, int n_iters,
    int v_iters, int record, int max_len, int max_hops) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int delta = 0;
  if (lane < n) {
    P.nv0 = nverts[0];
    P.nv1 = nverts[1];
    P.vb0 = vid_base[0];
    P.vb1 = vid_base[1];
    P.pb0 = ptr_base[0];
    P.pb1 = ptr_base[1];
    P.ib0 = ind_base[0];
    P.ib1 = ind_base[1];
    int prev = prev_in[lane];
    int cur = cur_in[lane];
    int hop = hop_in[lane];
    const int hop0 = hop;
    bool alive = alive_in[lane];
    uint32_t kwid0, kwid1;
    threefry2x32(key0, key1, 0u, (uint32_t)wid_in[lane], kwid0, kwid1);
    int slot = 0, row = 0;
    bool resident = alive && locate(P, cur, v_iters, slot, row);
    int* trace_row = record ? trace + (size_t)lane * (size_t)(max_len + 1) : nullptr;

    for (int it = 0; it < max_hops && resident; ++it) {
      uint32_t kw0, kw1;
      threefry2x32(kwid0, kwid1, 0u, (uint32_t)hop, kw0, kw1);
      const int pslot = slot == 0 ? P.pb0 : P.pb1;
      const int row_start = __ldg(P.indptr + clampi(pslot + row, P.sp));
      const int deg = __ldg(P.indptr + clampi(pslot + row + 1, P.sp)) - row_start;
      if (deg <= 0) {  // dead end: the walk terminates where it stands
        alive = false;
        break;
      }
      const int base = (slot == 0 ? P.ib0 : P.ib1) + row_start;

      int ulo = 0, uhi = 0;
      if (ORDER == 2) {
        int uslot, urow;
        locate(P, prev, v_iters, uslot, urow);
        const int pu = uslot == 0 ? P.pb0 : P.pb1;
        const int u_start = __ldg(P.indptr + clampi(pu + urow, P.sp));
        ulo = (uslot == 0 ? P.ib0 : P.ib1) + u_start;
        uhi = ulo + (__ldg(P.indptr + clampi(pu + urow + 1, P.sp)) - u_start);
      }

      // ---- proposal + rejection: the first accepted of k_max rounds -------
      int z = cur;
      for (int kk = 0; kk < k_max; ++kk) {
        uint32_t r0, r1, a0, a1, b0 = 0u, unused;
        threefry2x32(kw0, kw1, 0u, (uint32_t)kk, r0, r1);
        threefry2x32(r0, r1, 0u, 2u, a0, a1);
        if (HAS_ALIAS) threefry2x32(r0, r1, 1u, 0u, b0, unused);
        const float u1 = bits_to_unit(a0);
        const float u3 = bits_to_unit(a1);
        int kloc = (int)__fmul_rn(u1, (float)deg);
        kloc = kloc < deg - 1 ? kloc : deg - 1;
        int idx = base + kloc;
        if (HAS_ALIAS) {
          const float u2 = bits_to_unit(b0);
          if (u2 >= __ldg(P.alias_q + clampi(idx, P.sa))) {
            kloc = __ldg(P.alias_j + clampi(idx, P.sa));
            idx = base + kloc;
          }
        }
        const int zk = __ldg(P.indices + clampi(idx, P.se));
        bool take = kk == k_max - 1;
        if (ORDER == 2) {
          float acc = 1.0f;
          if (hop != 0) {
            if (zk == prev) {
              acc = acc_ret;
            } else {
              bool memb;
              lower_bound(P.indices, P.se, ulo, uhi, zk, n_iters, memb);
              acc = memb ? acc_nbr : acc_away;
            }
          }
          take = take || (u3 < acc);
        } else {
          take = take || (u3 < 1.0f);
        }
        if (take) {
          z = zk;
          break;
        }
      }

      // ---- commit -----------------------------------------------------------
      uint32_t t0, t1, b0, unused;
      threefry2x32(kw0, kw1, 0u, (uint32_t)k_max, t0, t1);
      threefry2x32(t0, t1, 0u, 0u, b0, unused);
      const float u_term = bits_to_unit(b0);
      prev = cur;
      cur = z;
      hop += 1;
      if (record) trace_row[hop < max_len ? hop : max_len] = cur;
      if (hop >= length || u_term >= decay) {
        alive = false;
        break;
      }
      resident = locate(P, cur, v_iters, slot, row);
    }
    prev_out[lane] = prev;
    cur_out[lane] = cur;
    hop_out[lane] = hop;
    alive_out[lane] = alive;
    delta = hop - hop0;
  }
  // steps = sum(hop_out - hop_in): one atomic per warp
  for (int off = 16; off > 0; off >>= 1) delta += __shfl_down_sync(0xffffffffu, delta, off);
  if ((threadIdx.x & 31) == 0 && delta != 0) atomicAdd(steps, delta);
}

template <int ORDER, bool HAS_ALIAS>
void launch(int grid, cudaStream_t stream, const Pair& P, const int* nverts, const int* vid_base,
            const int* ptr_base, const int* ind_base, const int* wid, const int* prev,
            const int* cur, const int* hop, const bool* alive, int* prev_out, int* cur_out,
            int* hop_out, bool* alive_out, int* trace, int* steps, int n, uint32_t key0,
            uint32_t key1, int length, float decay, float acc_ret, float acc_nbr, float acc_away,
            int k_max, int n_iters, int v_iters, int record, int max_len, int max_hops) {
  pair_advance_kernel<ORDER, HAS_ALIAS><<<grid, 256, 0, stream>>>(
      P, nverts, vid_base, ptr_base, ind_base, wid, prev, cur, hop, alive, prev_out, cur_out,
      hop_out, alive_out, trace, steps, n, key0, key1, length, decay, acc_ret, acc_nbr, acc_away,
      k_max, n_iters, v_iters, record, max_len, max_hops);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError().
extern "C" int pair_advance_launch(
    const void* vids, int sv, const void* nverts, const void* vid_base, const void* indptr,
    int sp, const void* ptr_base, const void* indices, int se, const void* ind_base,
    const void* alias_j, const void* alias_q, int sa, const void* wid, const void* prev,
    const void* cur, const void* hop, const void* alive, void* prev_out, void* cur_out,
    void* hop_out, void* alive_out, void* trace, void* steps, int n, unsigned int key0,
    unsigned int key1, int length, float decay, float acc_ret, float acc_nbr, float acc_away,
    int order, int k_max, int n_iters, int v_iters, int record, int has_alias, int max_len,
    int max_hops, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Pair P;
  P.vids = static_cast<const int*>(vids);
  P.indptr = static_cast<const int*>(indptr);
  P.indices = static_cast<const int*>(indices);
  P.alias_j = static_cast<const int*>(alias_j);
  P.alias_q = static_cast<const float*>(alias_q);
  P.sv = sv;
  P.sp = sp;
  P.se = se;
  P.sa = sa;
  P.nv0 = P.nv1 = P.vb0 = P.vb1 = P.pb0 = P.pb1 = P.ib0 = P.ib1 = 0;
  const int grid = (n + 255) / 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                                                \
  grid, s, P, static_cast<const int*>(nverts), static_cast<const int*>(vid_base),              \
      static_cast<const int*>(ptr_base), static_cast<const int*>(ind_base),                    \
      static_cast<const int*>(wid), static_cast<const int*>(prev), static_cast<const int*>(cur), \
      static_cast<const int*>(hop), static_cast<const bool*>(alive),                           \
      static_cast<int*>(prev_out), static_cast<int*>(cur_out), static_cast<int*>(hop_out),     \
      static_cast<bool*>(alive_out), static_cast<int*>(trace), static_cast<int*>(steps), n,    \
      key0, key1, length, decay, acc_ret, acc_nbr, acc_away, k_max, n_iters, v_iters, record,  \
      max_len, max_hops
  if (order == 2) {
    if (has_alias) launch<2, true>(PA_ARGS); else launch<2, false>(PA_ARGS);
  } else {
    if (has_alias) launch<1, true>(PA_ARGS); else launch<1, false>(PA_ARGS);
  }
#undef PA_ARGS
  return (int)cudaGetLastError();
}
