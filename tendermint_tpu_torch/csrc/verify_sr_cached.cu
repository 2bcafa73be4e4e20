// sr25519 cache-hit bitmap on the split ladder: R == encode([s]B - [k]A)
// with -A's power tables read from the device-resident sr25519 pubkey
// cache by slot.
//
// Replaces the JAX program `verify_sr_kernel_cached_split`
// (tendermint_tpu/ops/verify_sr.py:112, body
// verify_sr_kernel_cached_split_impl at :92).
//
// Bound on this card: integer multiplies. A row runs 16 steps of 4
// doublings and 8 additions and one ristretto encode (255 squarings, 21
// products): about 1,900 field multiplications, each at least 64 32-bit
// multiplies (36 for a square), the count the bound in chip_smoke.py uses;
// this design issues 100 wide multiplies per product and per square. It
// reads 96 bytes of input, and 64 table entries of 256 bytes (16 KiB) from
// the cache.
//
// Design: verify_cached.cu's, one thread per signature (the ladder is
// ladder.cuh's). R is never decoded. The reference's split ladder returns
// no T and adds the identity to regenerate it; here the ladder's last
// addition writes T instead, which gives a projectively scaled point with
// T Z = X Y and therefore the same encoding.
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void verify_sr_cached_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                                      const uint8_t *r_enc, const uint8_t *s_bytes,
                                      const uint8_t *k_bytes, const int32_t *fixed_table,
                                      uint8_t *out, int n, int capacity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // an out-of-range slot clamps, as the reference's XLA gather does
  const int slot = min(max(slots[i], 0), capacity - 1);
  ge q;
  ge_straus_split(q, tables + (size_t)slot * 4 * 16 * 128, fixed_table, s_bytes + 32 * i,
                  k_bytes + 32 * i, true);
  uint8_t enc[32];
  ristretto_encode(enc, q);
  const uint8_t *r = r_enc + 32 * i;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 32; j++) eq = eq && enc[j] == r[j];
  out[i] = (oks[slot] && eq) ? 1 : 0;
}

extern "C" int tm_verify_sr_cached_split(const void *tables, const void *oks, const void *slots,
                                         const void *r_enc, const void *s_bytes,
                                         const void *k_bytes, const void *fixed_table, void *out,
                                         int n, int capacity, void *stream) {
  const int threads = 128;
  verify_sr_cached_rows<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)fixed_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
