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
// histogram instead.
//
// Design, simple and correct first:
//  * Shared-memory path (NB bins fit in a block's shared memory): each
//    block zeroes NB private int32 bins in dynamic shared memory, walks a
//    grid-strided share of the lanes, adds one per lane with
//    valid && 0 <= id < NB by shared-memory atomicAdd, then flushes its
//    non-zero bins into the output with global atomicAdd.  The grid is
//    as many blocks as fit on the card at once, capped by the lane count.
//  * Global path (NB too large for shared memory): every lane adds
//    straight into the output with global atomicAdd.
//  * Integer atomics are exact and order-free, so both paths give the
//    plain version's counts bitwise.  The wrapper zeroes the output and
//    picks the path; the kernel allocates nothing.
//  * Contention on small NB (16 bins under 256 threads), warp-aggregated
//    adds and a persistent grid are left to a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bucket_hist_shared(const int* __restrict__ ids, const uint8_t* __restrict__ valid, int n,
                       int nb, int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int id = __ldg(ids + i);
    if (__ldg(valid + i) != 0 && id >= 0 && id < nb) atomicAdd(bins + id, 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = bins[b];
    if (c != 0) atomicAdd(out + b, c);
  }
}

__global__ void __launch_bounds__(kThreads)
    bucket_hist_global(const int* __restrict__ ids, const uint8_t* __restrict__ valid, int n,
                       int nb, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = __ldg(ids + i);
  if (__ldg(valid + i) != 0 && id >= 0 && id < nb) atomicAdd(out + id, 1);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `out` must hold nb zeroed
// int32 bins.  use_shared selects the shared-memory path; it fails with
// cudaErrorInvalidValue when nb bins exceed the block's opt-in limit.
// Returns cudaGetLastError() (or the first failing runtime call's error).
extern "C" int bucket_hist_launch(const void* ids, const void* valid, int n, int nb, void* out,
                                  int use_shared, void* stream) {
  if (n <= 0 || nb <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids_p = static_cast<const int*>(ids);
  const uint8_t* valid_p = static_cast<const uint8_t*>(valid);
  int* out_p = static_cast<int*>(out);
  const int lane_blocks = (n + kThreads - 1) / kThreads;
  if (!use_shared) {
    bucket_hist_global<<<lane_blocks, kThreads, 0, s>>>(ids_p, valid_p, n, nb, out_p);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)nb * sizeof(int);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bucket_hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_hist_shared, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = lane_blocks < resident ? lane_blocks : resident;
  bucket_hist_shared<<<grid, kThreads, smem, s>>>(ids_p, valid_p, n, nb, out_p);
  return (int)cudaGetLastError();
}
