// Fail count of the sharded verification programs, and its cross-shard sum.
//
// Replaces the on-device part of the JAX shard_map programs in
// tendermint_tpu/parallel/sharded_verify.py: each shard's
// `jnp.sum(jnp.where(ok, 0, 1))` (:46 sharded_verify_fn, :114
// sharded_cached_verify_fn, :211 sharded_rlc_fn) and the sum of the
// per-shard counts that `psum` takes over ICI, on one controller.
//
// Two modes of one entry point, each writing one int32:
//   mode 0: the number of zero bytes of a (n,) bool/uint8 bitmap (n = 1
//           for an RLC verdict);
//   mode 1: the sum of a (n,) int32 vector of per-shard counts.
//
// Bound on this card: bytes. A 10,240-row bitmap is 10 KiB read and 4
// bytes written; the launch itself (a few microseconds) is the real cost.
//
// Design: a grid-stride loop gives each thread its partial count, warp
// shuffles sum the warp's 32 partials, the block's warp sums go through
// shared memory to warp 0 for a second shuffle reduction, and one atomicAdd
// a block adds the block's count into the output, zeroed first on the same
// stream. The grid is capped so a large bitmap does not launch thousands of
// atomics.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two a streaming multiprocessor of the H100

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool SUM>
__global__ void fail_count_kernel(const void *in, int n, int32_t *out) {
  __shared__ int warp_sums[kThreads / 32];
  int acc = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if constexpr (SUM)
      acc += static_cast<const int32_t *>(in)[i];
    else
      acc += static_cast<const uint8_t *>(in)[i] == 0;
  }
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
  acc = warp_sum(acc);
  if (lane == 0) atomicAdd(out, acc);
}

extern "C" int tm_fail_count(const void *in, int n, int mode, void *out, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaMemsetAsync(out, 0, sizeof(int32_t), st);
  if (rc || n == 0) return rc;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (mode == 0)
    fail_count_kernel<false><<<blocks, kThreads, 0, st>>>(in, n, (int32_t *)out);
  else
    fail_count_kernel<true><<<blocks, kThreads, 0, st>>>(in, n, (int32_t *)out);
  return (int)cudaGetLastError();
}
