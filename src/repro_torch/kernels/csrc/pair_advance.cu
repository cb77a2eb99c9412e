// Multi-hop pair advance (Alg. 2 UpdateWalk) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `pair_advance_kernel` in
// src/repro/kernels/pair_advance.py (wrapper `fused_advance_pair`), and is
// held bit for bit against the plain PyTorch version
// `repro_torch.engines.step.pair_advance_ref`.
//
// What bounds it on an H100: neither the bytes it must move nor its
// operations.  Each hop of a lane is a chain of dependent random gathers
// into the resident pair (remap -> indptr -> proposal -> alias -> neighbour
// -> membership search), so it is bound by memory latency, and at 65,536
// lanes (two blocks of 256 threads per SM) few warps are in flight to hide
// it.  The design cuts links out of that chain; each cut is exact, for any
// input, by the argument given with it.
//
//  * One thread per walk lane; the thread loops over hops and exits as soon
//    as its lane stops being resident.  A frozen lane keeps its cur and
//    alive, so it never becomes resident again: the TPU tile's masked
//    while-loop (`any(resident)`) becomes a per-thread early exit.
//
//  * Slot metadata once per block.  Two threads read nverts, vid_base,
//    ptr_base, ind_base, the slot's contiguity flag and its first vertex
//    into shared memory; no thread reloads them per lane.
//
//  * O(1) remap on contiguous slots.  The reference locates v in slot s
//    by a lower bound over vids[vb, vb+nv) with v_iters guarded halvings
//    (`lower_bound` below).  Each halving leaves at most floor(size/2)
//    candidates, so once 2^v_iters > nv the search ends with lo == hi, and
//    on a sorted segment that is the exact lower bound.  If moreover
//    vids[vb+i] == vids[vb] + i for every i < nv (one contiguous run of
//    ids: sorted, no repeats, no gaps), the lower bound is
//    vb + clamp(v - vids[vb], 0, nv) and `found` is 0 <= v - vids[vb] < nv.
//    The kernel takes neither condition from its caller:
//    `slot_check_kernel` runs first on the same stream and sets
//    slot_flags[s] for a slot with nv <= 0, a segment outside vids,
//    nv >= 2^v_iters, end points that are not nv - 1 apart, or any entry
//    off the run; a flagged slot keeps the search.  A full block's view makes the run
//    (BlockView.from_resident: vids = start + arange(nv), core/graph.py),
//    and so does the oracle's single slot (vids = arange(V),
//    engines/inmemory.py; at 1,000,000 vertices v_iters =
//    remap_search_iters(V) = 21 and 2^21 > 1,000,000).  A slot 1 with slot
//    0's segment (the deduped pair, the oracle) takes slot 0's flag, and
//    the advance copies it into slot_flags[1].
//    Misses are unchanged: slot 0 first, then slot 1 at its insertion row,
//    clamped at 0.
//
//  * prev's row carried from hop to hop (order 2).  On the first hop of a
//    launch, prev is located by search: it may lie outside the pair.  From
//    then on, prev is the cur of the hop before, which was resident, so
//    `locate` (a pure function of the vertex) found it at (slot, row) and
//    its membership range [ulo, uhi) is exactly that hop's
//    [base, base + deg).  On hop 0 of a walk the bias is 1 and prev is not
//    located at all.
//
//  * Membership by the reference's fixed search, whether prev was found or
//    not (a missed prev's clamped range may span rows and padding, where
//    only that search gives the reference's answer).  A carried row was
//    just read by the proposal and is left to L1.
//
//  * Unchanged from the first port: rejection rounds stop at the first
//    accepted proposal; the membership search is skipped where the bias
//    does not depend on it (hop 0, z == prev); Threefry-2x32 in native
//    uint32, keyed (base, walk id, hop, round); every gather clamps its
//    index to [0, len-1], as jnp indexing does; no division on the device
//    (the three acceptance thresholds come in as float32 computed on the
//    host), `__fmul_rn` for kloc and no --use_fast_math; a dead end kills
//    the lane with its hop not advanced; the wrapper pre-fills the trace
//    with -1 and frozen lanes write nothing; one atomic per warp for
//    `steps`.  A hop's draws are pure functions of its key, so they are
//    computed after its first gathers are issued, while those are in flight.
//
//  * The record store goes to one of two places.  With corpus_rows == 0,
//    `trace` is the call's own [n, max_len + 1] trace, one row per lane.
//    With corpus_rows > 0, `trace` is the engine's whole corpus,
//    [corpus_rows, max_len + 1], and a lane writes the row of its walk id,
//    so the corpus stays on the card and nothing is copied back or
//    scattered per call.  Walk ids are unique within a call, so no cell is
//    written twice; a lane whose id is outside the corpus writes nothing.
//
// `steps` (one int) and `slot_flags` (two ints, 1 where slot s keeps the
// search) are zeroed by the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
};

struct Slot {
  int nv, vb, pb, ib;
  int contiguous;  // the O(1) remap is exact for this slot
  int vfirst;      // vids[vb] when contiguous
};

// True when v_iters guarded halvings end the search over [vb, vb+nv), a
// segment inside vids, with lo == hi.
__device__ __forceinline__ bool search_is_exact(int nv, int vb, int sv, int v_iters) {
  return nv > 0 && vb >= 0 && (long long)vb + nv <= sv &&
         (v_iters >= 31 || (v_iters >= 0 && (nv >> v_iters) == 0));
}

// Flags (bad[s] = 1) each slot whose remap must keep the search; grid row
// s checks slot s.  Slot 1 with slot 0's segment is left to slot 0's flag.
__global__ void __launch_bounds__(kThreads) slot_check_kernel(const int* __restrict__ vids, int sv,
                                                              const int* __restrict__ nverts,
                                                              const int* __restrict__ vid_base,
                                                              int v_iters, int* bad) {
  const int s = blockIdx.y;
  const int nv = nverts[s], vb = vid_base[s];
  if (s == 1 && nv == nverts[0] && vb == vid_base[0]) return;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (!search_is_exact(nv, vb, sv, v_iters)) {
    if (lead) bad[s] = 1;
    return;
  }
  const long long first = __ldg(vids + vb);
  if (__ldg(vids + vb + nv - 1) - first != nv - 1) {
    if (lead) bad[s] = 1;
    return;
  }
  const int stride = gridDim.x * blockDim.x;
  bool off = false;
#pragma unroll 4
  for (int i = blockIdx.x * blockDim.x + threadIdx.x + 1; i < nv - 1; i += stride) {
    off |= __ldg(vids + vb + i) != first + i;
  }
  if (off) bad[s] = 1;
}

// Global vertex -> (slot, compact row, found) through the two vids remaps;
// a miss falls back to slot 1 at its insertion row, clamped at 0.
__device__ __forceinline__ bool locate_in(const Pair& P, const Slot& m, int v, int v_iters,
                                          int& row) {
  if (m.contiguous) {
    const long long d = (long long)v - m.vfirst;
    row = d < 0 ? 0 : (d > m.nv ? m.nv : (int)d);
    return d >= 0 && d < m.nv;
  }
  bool f;
  row = lower_bound(P.vids, P.sv, m.vb, m.vb + m.nv, v, v_iters, f) - m.vb;
  return f;
}

__device__ __forceinline__ bool locate(const Pair& P, const Slot* S, int v, int v_iters,
                                       int& slot, int& row) {
  bool found = locate_in(P, S[0], v, v_iters, row);
  slot = 0;
  if (!found) {
    found = locate_in(P, S[1], v, v_iters, row);
    slot = 1;
  }
  row = row < 0 ? 0 : row;
  return found;
}

// The three uniforms of proposal round kk: u1 picks the slot, u2 the alias
// coin, u3 the acceptance.
template <bool HAS_ALIAS>
__device__ __forceinline__ void round_draws(uint32_t kw0, uint32_t kw1, int kk, float& u1,
                                            float& u2, float& u3) {
  uint32_t r0, r1, a0, a1, b0 = 0u, unused;
  threefry2x32(kw0, kw1, 0u, (uint32_t)kk, r0, r1);
  threefry2x32(r0, r1, 0u, 2u, a0, a1);
  if (HAS_ALIAS) threefry2x32(r0, r1, 1u, 0u, b0, unused);
  u1 = bits_to_unit(a0);
  u2 = bits_to_unit(b0);
  u3 = bits_to_unit(a1);
}

template <int ORDER, bool HAS_ALIAS>
__global__ void __launch_bounds__(kThreads) pair_advance_kernel(
    Pair P, const int* __restrict__ nverts, const int* __restrict__ vid_base,
    const int* __restrict__ ptr_base, const int* __restrict__ ind_base,
    const int* __restrict__ wid_in, const int* __restrict__ prev_in, const int* __restrict__ cur_in,
    const int* __restrict__ hop_in, const bool* __restrict__ alive_in, int* __restrict__ prev_out,
    int* __restrict__ cur_out, int* __restrict__ hop_out, bool* __restrict__ alive_out,
    int* __restrict__ trace, int* __restrict__ steps, int* slot_flags, int n, uint32_t key0,
    uint32_t key1, int length, float decay, float acc_ret, float acc_nbr, float acc_away,
    int k_max, int n_iters, int v_iters, int record, int corpus_rows, int max_len, int max_hops) {
  __shared__ Slot S[2];
  if (threadIdx.x < 2) {
    const int s = threadIdx.x;
    Slot m;
    m.nv = nverts[s];
    m.vb = vid_base[s];
    m.pb = ptr_base[s];
    m.ib = ind_base[s];
    const bool same = s == 1 && m.nv == nverts[0] && m.vb == vid_base[0];
    const int bad = slot_flags[same ? 0 : s];
    // no block reads slot_flags[1] when slot 1 shares slot 0's segment
    if (same && blockIdx.x == 0) slot_flags[1] = bad;
    m.contiguous = bad == 0;
    m.vfirst = m.contiguous ? __ldg(P.vids + m.vb) : 0;
    S[s] = m;
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int delta = 0;
  if (lane < n) {
    int prev = prev_in[lane];
    int cur = cur_in[lane];
    int hop = hop_in[lane];
    const int hop0 = hop;
    bool alive = alive_in[lane];
    const int wid = wid_in[lane];
    uint32_t kwid0, kwid1;
    threefry2x32(key0, key1, 0u, (uint32_t)wid, kwid0, kwid1);
    int slot = 0, row = 0;
    bool resident = alive && locate(P, S, cur, v_iters, slot, row);
    // the record row: the lane's own trace row, or its walk's corpus row
    const size_t trace_at = corpus_rows > 0 ? (size_t)(unsigned)wid : (size_t)lane;
    const bool store = record && (corpus_rows == 0 || (unsigned)wid < (unsigned)corpus_rows);
    int* trace_row = store ? trace + trace_at * (size_t)(max_len + 1) : nullptr;
    // order 2: prev's membership range, and whether it is known (carried
    // from the hop before)
    bool have_u = false;
    int ulo = 0, uhi = 0;

    for (int it = 0; it < max_hops && resident; ++it) {
      const int pidx = (slot == 0 ? S[0].pb : S[1].pb) + row;
      const int row_start = __ldg(P.indptr + clampi(pidx, P.sp));
      const int row_end = __ldg(P.indptr + clampi(pidx + 1, P.sp));
      if (ORDER == 2 && !have_u && hop != 0) {
        int uslot, urow;
        locate(P, S, prev, v_iters, uslot, urow);
        const int pu = (uslot == 0 ? S[0].pb : S[1].pb) + urow;
        const int u_start = __ldg(P.indptr + clampi(pu, P.sp));
        ulo = (uslot == 0 ? S[0].ib : S[1].ib) + u_start;
        uhi = ulo + (__ldg(P.indptr + clampi(pu + 1, P.sp)) - u_start);
        have_u = true;
      }

      // the hop's draws: its key, round 0 and the termination draw
      uint32_t kw0, kw1;
      threefry2x32(kwid0, kwid1, 0u, (uint32_t)hop, kw0, kw1);
      float u1, u2, u3;
      round_draws<HAS_ALIAS>(kw0, kw1, 0, u1, u2, u3);
      uint32_t t0, t1, tb, unused;
      threefry2x32(kw0, kw1, 0u, (uint32_t)k_max, t0, t1);
      threefry2x32(t0, t1, 0u, 0u, tb, unused);
      const float u_term = bits_to_unit(tb);

      const int deg = row_end - row_start;
      if (deg <= 0) {  // dead end: the walk terminates where it stands
        alive = false;
        break;
      }
      const int base = (slot == 0 ? S[0].ib : S[1].ib) + row_start;

      // ---- proposal + rejection: the first accepted of k_max rounds -------
      int z = cur;
      for (int kk = 0;;) {
        int kloc = (int)__fmul_rn(u1, (float)deg);
        kloc = kloc < deg - 1 ? kloc : deg - 1;
        int idx = base + kloc;
        if (HAS_ALIAS) {
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
        round_draws<HAS_ALIAS>(kw0, kw1, ++kk, u1, u2, u3);
      }

      // ---- commit -----------------------------------------------------------
      if (ORDER == 2) {  // the next prev is this cur: its row is [base, base + deg)
        ulo = base;
        uhi = base + deg;
        have_u = true;
      }
      prev = cur;
      cur = z;
      hop += 1;
      if (store) trace_row[hop < max_len ? hop : max_len] = cur;
      if (hop >= length || u_term >= decay) {
        alive = false;
        break;
      }
      resident = locate(P, S, cur, v_iters, slot, row);
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
            int* hop_out, bool* alive_out, int* trace, int* steps, int* slot_flags, int n,
            uint32_t key0, uint32_t key1, int length, float decay, float acc_ret, float acc_nbr,
            float acc_away, int k_max, int n_iters, int v_iters, int record, int corpus_rows,
            int max_len, int max_hops) {
  pair_advance_kernel<ORDER, HAS_ALIAS><<<grid, kThreads, 0, stream>>>(
      P, nverts, vid_base, ptr_base, ind_base, wid, prev, cur, hop, alive, prev_out, cur_out,
      hop_out, alive_out, trace, steps, slot_flags, n, key0, key1, length, decay, acc_ret,
      acc_nbr, acc_away, k_max, n_iters, v_iters, record, corpus_rows, max_len, max_hops);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `steps` points at one int and
// `slot_flags` at two, all zeroed by the caller.  `trace` is the call's
// trace (corpus_rows 0) or the corpus of corpus_rows walks.  Launches the
// slot check, then the advance.
// Returns cudaGetLastError().
extern "C" int pair_advance_launch(
    const void* vids, int sv, const void* nverts, const void* vid_base, const void* indptr,
    int sp, const void* ptr_base, const void* indices, int se, const void* ind_base,
    const void* alias_j, const void* alias_q, int sa, const void* wid, const void* prev,
    const void* cur, const void* hop, const void* alive, void* prev_out, void* cur_out,
    void* hop_out, void* alive_out, void* trace, void* steps, void* slot_flags, int n,
    unsigned int key0, unsigned int key1, int length, float decay, float acc_ret, float acc_nbr,
    float acc_away, int order, int k_max, int n_iters, int v_iters, int record, int has_alias,
    int corpus_rows, int max_len, int max_hops, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* flags = static_cast<int*>(slot_flags);
  // one grid row per slot, about four vids per thread, at most 264 blocks a row
  int check_grid = (sv + 8 * kThreads - 1) / (8 * kThreads);
  check_grid = check_grid < 1 ? 1 : (check_grid > 264 ? 264 : check_grid);
  slot_check_kernel<<<dim3(check_grid, 2), kThreads, 0, s>>>(
      P.vids, sv, static_cast<const int*>(nverts), static_cast<const int*>(vid_base), v_iters,
      flags);
  const int grid = (n + kThreads - 1) / kThreads;
#define PA_ARGS                                                                                \
  grid, s, P, static_cast<const int*>(nverts), static_cast<const int*>(vid_base),              \
      static_cast<const int*>(ptr_base), static_cast<const int*>(ind_base),                    \
      static_cast<const int*>(wid), static_cast<const int*>(prev), static_cast<const int*>(cur), \
      static_cast<const int*>(hop), static_cast<const bool*>(alive),                           \
      static_cast<int*>(prev_out), static_cast<int*>(cur_out), static_cast<int*>(hop_out),     \
      static_cast<bool*>(alive_out), static_cast<int*>(trace), static_cast<int*>(steps), flags, \
      n, key0, key1, length, decay, acc_ret, acc_nbr, acc_away, k_max, n_iters, v_iters, record,  \
      corpus_rows, max_len, max_hops
  if (order == 2) {
    if (has_alias) launch<2, true>(PA_ARGS); else launch<2, false>(PA_ARGS);
  } else {
    if (has_alias) launch<1, true>(PA_ARGS); else launch<1, false>(PA_ARGS);
  }
#undef PA_ARGS
  return (int)cudaGetLastError();
}
