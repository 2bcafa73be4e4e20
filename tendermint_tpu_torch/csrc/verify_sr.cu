// Uncached sr25519 bitmap: R == encode([s]B - [k]A) for every row of a
// batch, compared as 32 bytes with the wire R (which is never decoded).
//
// Replaces the JAX program `verify_sr_kernel`
// (tendermint_tpu/ops/verify_sr.py:46, body verify_sr_kernel_impl at :32).
//
// Bound on this card: integer multiplies. A row decodes A with the
// ristretto codec (256 squarings, 18 products), builds 15 table entries
// (9M each), runs 63 windows of 4 doublings and 2 additions, and encodes
// the result (255 squarings, 21 products): about 4,100 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. Memory traffic is 128 bytes in
// and 1 byte out.
//
// Design: one thread per signature (the ladder is ladder.cuh's
// ge_straus_base, the first design of the ed25519 bitmap), with ristretto decode in place of ZIP-215 decompression
// and encode-and-compare in place of the cofactored equality. The last
// ladder addition writes T, which the encoder reads.
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void verify_sr_rows(const uint8_t *a_enc, const uint8_t *r_enc, const uint8_t *s_bytes,
                               const uint8_t *k_bytes, const int32_t *base_table, int32_t *scratch,
                               uint8_t *out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge a, q;
  const bool a_ok = ristretto_decode(a, a_enc + 32 * i);
  ge_neg(a, a);
  int32_t *tab = scratch + i;
  ge_build_table(tab, n, a);
  ge_straus_base(q, base_table, tab, n, s_bytes + 32 * i, k_bytes + 32 * i, true);
  uint8_t enc[32];
  ristretto_encode(enc, q);
  const uint8_t *r = r_enc + 32 * i;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 32; j++) eq = eq && enc[j] == r[j];
  out[i] = (a_ok && eq) ? 1 : 0;
}

extern "C" int tm_verify_sr(const void *a_enc, const void *r_enc, const void *s_bytes,
                            const void *k_bytes, const void *base_table, void *scratch, void *out,
                            int n, void *stream) {
  const int threads = 128;
  verify_sr_rows<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, (const uint8_t *)s_bytes,
      (const uint8_t *)k_bytes, (const int32_t *)base_table, (int32_t *)scratch, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
