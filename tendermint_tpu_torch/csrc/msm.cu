// Randomized-linear-combination check of a whole batch:
//   [8](sum z_i h_i (-A_i) + sum z_i (-R_i) + [sum z_i s_i]B) == identity
// and every encoding decodes.
//
// Replaces the JAX program `msm_verify_kernel` (tendermint_tpu/ops/msm.py:162,
// body msm_verify_kernel_impl at :132, accumulation _accumulate_windows at
// :86).
//
// Bound on this card: integer multiplies. Per row: two decodes (about 265
// field multiplications each), two 16-multiples tables (14 additions
// each, 9M) and 96 window additions (9M): about 1,650 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. The tail (Horner over 64
// windows per stream, the stream tree, the fixed-base comb and the
// cofactor) is a fixed cost of about 330,000 field multiplications
// for G = 128 streams, shared by the whole batch.
//
// Design: three launches from one entry point, on the caller's stream.
//   1. tables: one thread per point of -A | -R; decodes it and writes its
//      16 multiples (ten-limb form) and its decode bit to scratch.
//   2. windows: one thread per (window w, stream g) accumulator, looping
//      over the rows g, g + G, g + 2G, ... and adding each row's table
//      entry for nibble w of z*h (and of z, for w < 32). The reference's
//      TPU program runs the same (window, stream) grid in lock step.
//   3. tail: one block of G threads; each Horner-combines its stream's 64
//      window sums, the block tree-reduces the streams in shared memory,
//      and thread 0 adds [zs]B by the 64-row fixed-base comb, clears the
//      cofactor and tests for the identity. The decode bits of every row,
//      padding rows included, are ANDed in the same block.
#include <cuda_runtime.h>

#include "ge25519.cuh"

__global__ void msm_tables(const uint8_t *a_enc, const uint8_t *r_enc, int32_t *tabs, uint8_t *oks,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  ge p;
  const uint8_t *enc = i < n ? a_enc + 32 * i : r_enc + 32 * (i - n);
  oks[i] = ge_decompress(p, enc) ? 1 : 0;
  ge_neg(p, p);
  ge_build_table(tabs + i, 2 * n, p);
}

__global__ void msm_windows(const uint8_t *zk_bytes, const uint8_t *z_bytes, const int32_t *tabs,
                            int32_t *wsum, int n, int g) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 64 * g) return;
  const int w = idx / g, stream = idx % g;
  ge acc, e;
  ge_identity(acc);
#pragma unroll 1
  for (int row = stream; row < n; row += g) {
    ge_load(e, tabs + row, nibble(zk_bytes + 32 * row, w), 2 * n);
    ge_add(acc, acc, e, true);
    if (w < 32) {
      ge_load(e, tabs + n + row, nibble(z_bytes + 16 * row, w), 2 * n);
      ge_add(acc, acc, e, true);
    }
  }
  ge_store(wsum + idx, 0, 64 * g, acc);  // point (w, stream) at idx
}

__global__ void msm_tail(const int32_t *wsum, const uint8_t *oks, const uint8_t *zs_bytes,
                         const int32_t *fixed_table, uint8_t *out, int n, int g) {
  extern __shared__ int32_t sh[];  // g points, strided by g
  const int s = threadIdx.x;
  ge acc, e;
  ge_load(acc, wsum + 63 * g + s, 0, 64 * g);
#pragma unroll 1
  for (int w = 62; w >= 0; w--) {
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, true);
    ge_load(e, wsum + w * g + s, 0, 64 * g);
    ge_add(acc, acc, e, true);
  }
  ge_store(sh + s, 0, g, acc);
  bool ok = true;
  for (int i = s; i < 2 * n; i += g) ok = ok && oks[i];
  ok = __syncthreads_and(ok);
  for (int half = g / 2; half >= 1; half /= 2) {
    if (s < half) {
      ge_load(acc, sh + s, 0, g);
      ge_load(e, sh + s + half, 0, g);
      ge_add(acc, acc, e, true);
      ge_store(sh + s, 0, g, acc);
    }
    __syncthreads();
  }
  if (s != 0) return;
  ge_load(acc, sh, 0, g);
  ge sb;
  ge_identity(sb);
#pragma unroll 1
  for (int i = 0; i < 64; i++) {
    ge_from_limbs8(e, fixed_table + ((size_t)i * 16 + nibble(zs_bytes, i)) * 128);
    ge_add(sb, sb, e, true);
  }
  ge_add(acc, acc, sb, false);
#pragma unroll 1
  for (int i = 0; i < 3; i++) ge_dbl(acc, acc, false);
  out[0] = (ok && ge_is_identity(acc)) ? 1 : 0;
}

extern "C" int tm_msm_verify(const void *a_enc, const void *r_enc, const void *zk_bytes,
                             const void *z_bytes, const void *zs_bytes, const void *fixed_table,
                             void *tabs, void *oks, void *wsum, void *out, int n, int g,
                             void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (g < 1 || g > 1024 || n % g) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  msm_tables<<<grid_for(2 * n, threads), threads, 0, st>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, (int32_t *)tabs, (uint8_t *)oks, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_windows<<<grid_for(64 * g, threads), threads, 0, st>>>(
      (const uint8_t *)zk_bytes, (const uint8_t *)z_bytes, (const int32_t *)tabs, (int32_t *)wsum,
      n, g);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t shmem = (size_t)g * 40 * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(msm_tail, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)shmem);
    if (rc) return rc;
  }
  msm_tail<<<1, g, shmem, st>>>((const int32_t *)wsum, (const uint8_t *)oks,
                                (const uint8_t *)zs_bytes, (const int32_t *)fixed_table,
                                (uint8_t *)out, n, g);
  return (int)cudaGetLastError();
}
