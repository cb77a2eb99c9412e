// Bucket histogram (valid walks per bucket id) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/bucket_hist.py (wrapper `bucket_hist_kernel`), and is
// held bit for bit against the plain PyTorch version
// `repro_torch.kernels.bucket_hist.bucket_hist_ref`.
//
// What bounds it on an H100: bytes.  Each lane is read once (a 4-byte id
// and a 1-byte valid flag) and each bin written once, N*5 + NB*4 bytes
// over 3.35 TB/s; it does no arithmetic worth counting.  The TPU kernel
// made the count a one-hot [T, NB] matrix summed by a ones-vector matmul
// on the MXU; on a GPU that is NB times the work, so this kernel is a
// histogram instead.  What stands between it and the bound is where the
// increments land, which depends on the bucket count, so the wrapper's
// host plan (`bucket_hist.plan`, resolved once per shape from N, NB and
// the card) picks a path, its bin ranges and its grid:
//
//  * every path reads a thread's lanes four at a time, one 16-byte load of
//    ids and one 4-byte load of valid flags (N is a multiple of 1024; the
//    wrapper refuses a base that is not 16- and 4-byte aligned), two steps
//    in flight per thread over a grid-strided loop;
//  * block (NB up to a few thousand): one private copy of the bins per
//    block of 1,024 threads in shared memory, one shared-memory atomic per
//    counted lane, one global atomic per non-zero bin at the end; two
//    blocks per SM where two fit and each copy still counts enough lanes
//    per bin, else one;
//  * range (NB up to tens of thousands): a copy's bins are split into 2 or
//    4 contiguous ranges (the kernel takes any count), one block each, and
//    every block of a copy reads the copy's lanes and counts those in its
//    range.  Re-reading the lanes (from L2) costs less than flushing
//    large, sparse copies: fewer bins per block, fewer copies, fewer
//    global atomics;
//  * global (past that): every counted lane adds straight into the output
//    in L2.
//  * Integer adds are exact and order-free, so every path gives the plain
//    version's counts bitwise.  `out` is added into; the C entry zeroes it
//    first when asked (one memset on the stream, no separate fill kernel).
//  * Per-device work (the SM count, the shared memory and threads a block
//    and an SM hold, and the shared path's dynamic shared-memory attribute)
//    is done once, by `bucket_hist_setup`; a launch makes no device query.
//    The launch makes the tensors' device current around itself (a
//    thread-local switch in the runtime), so the wrapper needs no Python
//    device guard.
//  * Tried and dropped, by `chip_smoke.py --hist-sweep` (see PERF.md): one
//    column of counters per thread or one copy of the bins per warp at
//    small NB, and one copy spread over a thread block cluster with adds
//    over distributed shared memory (`red.shared::cluster`) at large NB;
//    each measured slower than the paths above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// path codes shared with kernels/bucket_hist.py (`_PATHS`)
enum Path { kShared = 0, kGlobal = 1 };

// four lanes: their ids (16 bytes) and valid flags (one byte each)
struct Quad {
  int4 id;
  uint32_t ok;
};

__device__ __forceinline__ Quad load_quad(const int4* __restrict__ ids,
                                          const uint32_t* __restrict__ valid, int v) {
  return Quad{__ldg(ids + v), __ldg(valid + v)};
}

// f(id - lo) for each lane of q that is valid with id in [lo, lo + cnt);
// unsigned arithmetic, so a negative id wraps out of range
template <class F>
__device__ __forceinline__ void for_counted(const Quad& q, int lo, int cnt, F& f) {
  const int id[4] = {q.id.x, q.id.y, q.id.z, q.id.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned slot = (unsigned)id[k] - (unsigned)lo;
    if (((q.ok >> (8 * k)) & 0xffu) != 0u && slot < (unsigned)cnt) f((int)slot);
  }
}

// the walk over quads first, first + stride, ... below n4, two loads in
// flight per thread
template <class F>
__device__ __forceinline__ void for_quads(const int4* __restrict__ ids,
                                          const uint32_t* __restrict__ valid, int n4, int first,
                                          int stride, int lo, int cnt, F f) {
  int v = first;
  for (; v + stride < n4; v += 2 * stride) {
    const Quad a = load_quad(ids, valid, v);
    const Quad b = load_quad(ids, valid, v + stride);
    for_counted(a, lo, cnt, f);
    for_counted(b, lo, cnt, f);
  }
  if (v < n4) for_counted(load_quad(ids, valid, v), lo, cnt, f);
}

// Private copies of the bins in shared memory, on a grid of (copies,
// ranges) blocks.  Block (c, r) counts the lanes of copy c whose ids fall
// in bin range r, [r * per, r * per + per): one shared-memory atomic per
// counted lane, then one global atomic per non-zero bin.  More ranges let
// a copy's bins exceed one block's shared memory, and let more copies run
// at once, at the price of reading the copy's lanes once per range.
// Everything a block needs is an argument or a special register, so its
// first loads issue without a division ahead of them.
__global__ void __launch_bounds__(kMaxThreads)
    bucket_hist_shared(const int4* __restrict__ ids, const uint32_t* __restrict__ valid, int n4,
                       int nb, int* __restrict__ out, int per) {
  extern __shared__ int bins[];
  const int lo = (int)blockIdx.y * per, cnt = max(0, min(per, nb - lo));
  for (int s = threadIdx.x; s < cnt; s += blockDim.x) bins[s] = 0;
  __syncthreads();
  for_quads(ids, valid, n4, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x, lo,
            cnt, [&](int slot) { atomicAdd(bins + slot, 1); });
  __syncthreads();
  for (int s = threadIdx.x; s < cnt; s += blockDim.x) {
    const int c = bins[s];
    if (c != 0) atomicAdd(out + lo + s, c);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    bucket_hist_global(const int4* __restrict__ ids, const uint32_t* __restrict__ valid, int n4,
                       int nb, int* __restrict__ out) {
  for_quads(ids, valid, n4, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x, 0, nb,
            [&](int id) { atomicAdd(out + id, 1); });
}

}  // namespace

// Once per device, with that device current: the card's properties the
// host plan reads (`bucket_hist.Card`, in this order: SM count, opt-in shared
// memory per block, shared memory per SM, shared memory the runtime reserves
// per block, threads per SM), and the shared path's dynamic shared-memory
// limit raised to the opt-in limit.
extern "C" int bucket_hist_setup(int* card) {
  static const cudaDeviceAttr kAttrs[5] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxThreadsPerMultiProcessor};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  for (int k = 0; k < 5 && err == cudaSuccess; ++k)
    err = cudaDeviceGetAttribute(card + k, kAttrs[k], dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bucket_hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               card[1]);
  return (int)err;
}

namespace {

// Adds the counts into `out` on `stream`, with the right device current.
cudaError_t launch(const int4* ids, const uint32_t* valid, int n4, int nb, int* out, int path,
                   int ranges, int grid, int threads, int zero_out, cudaStream_t s) {
  if (zero_out) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)nb * sizeof(int), s);
    if (err != cudaSuccess) return err;
  }
  if (path == kShared) {
    const int per = (nb + ranges - 1) / ranges;
    bucket_hist_shared<<<dim3(grid / ranges, ranges), threads, (size_t)per * sizeof(int), s>>>(
        ids, valid, n4, nb, out, per);
  } else {
    bucket_hist_global<<<grid, threads, 0, s>>>(ids, valid, n4, nb, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Adds the counts into `out`
// ([nb] int32) on `device`, zeroing it first when zero_out is set.  path,
// ranges (1 on the global path), grid (all blocks) and threads come from
// the host plan; a plan the card cannot run (too much shared memory for its
// bins) fails with the launch's error.  The caller's current device is
// restored.  Returns the launch's error (or the first failing runtime
// call's).
extern "C" int bucket_hist_launch(int device, const void* ids, const void* valid, int n, int nb,
                                  void* out, int path, int ranges, int grid, int threads,
                                  int zero_out, void* stream) {
  if (n <= 0 || nb <= 0) return (int)cudaSuccess;
  const bool shape_ok = path == kShared ? ranges >= 1 && ranges <= nb && grid % ranges == 0
                                        : path == kGlobal && ranges == 1;
  if (n % 4 != 0 || reinterpret_cast<uintptr_t>(ids) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(valid) % 4 != 0 || grid <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || !shape_ok)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch(static_cast<const int4*>(ids), static_cast<const uint32_t*>(valid), n / 4, nb,
               static_cast<int*>(out), path, ranges, grid, threads, zero_out,
               static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
