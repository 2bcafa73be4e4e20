// Uncached per-signature bitmap: the cofactored ZIP-215 check
// [8]([s]B - [k]A) == [8]R for every row of a batch.
//
// Replaces the JAX program `verify_kernel` (tendermint_tpu/ops/verify.py:81,
// body verify_kernel_impl at :58), which runs the whole batch in lock step
// on the TPU's vector lanes with one-hot table selects.
//
// Bound on this card: integer multiplies. A row decodes two points (about
// 265 field multiplications each), builds 15 table entries (9M each) and
// runs 63 windows of 4 doublings and 2 additions plus the 6 cofactor
// doublings: about 4,400 field multiplications, each at least 64 32-bit
// multiplies (36 for a square), the count the bound in chip_smoke.py uses;
// this design issues 100 wide multiplies per product and per square.
// Memory traffic is 128 bytes in and 1 byte out.
//
// Design: one thread per signature with the ten-limb radix-2^25.5 field
// (fe25519.cuh). The 16-multiples table of -A lives in scratch that the
// wrapper allocates (strided so a warp's loads coalesce); the table of B
// is read from the constant table by direct index, since verification
// handles only public data (the ladder is ladder.cuh's, shared with the
// sr25519 kernel). Later work: warp-cooperative multiplication,
// shared-memory tables, occupancy.
#include <cuda_runtime.h>

#include "ladder.cuh"

__global__ void verify_rows(const uint8_t *a_enc, const uint8_t *r_enc, const uint8_t *s_bytes,
                            const uint8_t *k_bytes, const int32_t *base_table, int32_t *scratch,
                            uint8_t *out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t *s = s_bytes + 32 * i;
  const uint8_t *k = k_bytes + 32 * i;
  ge a, r, q;
  const bool a_ok = ge_decompress(a, a_enc + 32 * i);
  const bool r_ok = ge_decompress(r, r_enc + 32 * i);
  ge_neg(a, a);
  int32_t *tab = scratch + i;
  ge_build_table(tab, n, a);
  ge_straus_base(q, base_table, tab, n, s, k, false);
  out[i] = (a_ok && r_ok && ge_cofactored_equal(q, r)) ? 1 : 0;
}

extern "C" int tm_verify(const void *a_enc, const void *r_enc, const void *s_bytes,
                         const void *k_bytes, const void *base_table, void *scratch, void *out,
                         int n, void *stream) {
  const int threads = 128;
  verify_rows<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, (const uint8_t *)s_bytes,
      (const uint8_t *)k_bytes, (const int32_t *)base_table, (int32_t *)scratch, (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
