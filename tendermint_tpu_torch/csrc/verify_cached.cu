// Cache-hit bitmap on the split ladder: [8]([s]B - [k]A) == [8]R with -A's
// power tables read from the device-resident pubkey cache by slot.
//
// Replaces the JAX program `verify_kernel_cached_split`
// (tendermint_tpu/ops/verify.py:157, body verify_kernel_cached_split_impl
// at :144).
//
// Bound on this card: integer multiplies. A row decodes R (about 265 field
// multiplications), runs 16 steps of 4 doublings and 8 additions and the
// 6 cofactor doublings: about 1,900 field multiplications, each at least
// 64 32-bit multiplies (36 for a square), the count the bound in
// chip_smoke.py uses; this design issues 100 wide multiplies per product
// and per square. It reads 96 bytes of input, and 64 table
// entries of 256 bytes (16 KiB) from the cache.
//
// Design: one thread per signature. Cache entries are int16 radix-2^8
// limbs (canonical from the port's fill kernel, or the reference's
// signed limbs carried across by cache_from_reference) and are converted
// to the ten-limb field as they are read; [s]B rides the rows of the
// fixed-base comb at the chunk boundaries, read by direct index (the
// ladder is ladder.cuh's, shared with the sr25519 kernel).
#include <cuda_runtime.h>

#include "ladder.cuh"

__global__ void verify_cached_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                                   const uint8_t *r_enc, const uint8_t *s_bytes,
                                   const uint8_t *k_bytes, const int32_t *fixed_table, uint8_t *out,
                                   int n, int capacity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t *s = s_bytes + 32 * i;
  const uint8_t *k = k_bytes + 32 * i;
  // an out-of-range slot clamps, as the reference's XLA gather does
  const int slot = min(max(slots[i], 0), capacity - 1);
  const int16_t *a_tab = tables + (size_t)slot * 4 * 16 * 128;
  ge r, q;
  const bool r_ok = ge_decompress(r, r_enc + 32 * i);
  ge_straus_split(q, a_tab, fixed_table, s, k, false);
  out[i] = (oks[slot] && r_ok && ge_cofactored_equal(q, r)) ? 1 : 0;
}

extern "C" int tm_verify_cached_split(const void *tables, const void *oks, const void *slots,
                                      const void *r_enc, const void *s_bytes, const void *k_bytes,
                                      const void *fixed_table, void *out, int n, int capacity,
                                      void *stream) {
  const int threads = 128;
  verify_cached_rows<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)fixed_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
