// sr25519 cache-hit bitmap on the single-table plane (TM_TPU_PK_SPLIT=1):
// R == encode([s]B - [k]A) with -A's 16 multiples read from the
// device-resident sr25519 pubkey cache by slot.
//
// Replaces the JAX program `verify_sr_kernel_cached`
// (tendermint_tpu/ops/verify_sr.py:75, body verify_sr_kernel_cached_impl
// at :62).
//
// Bound on this card: integer multiplies. A row runs the 252-doubling
// Straus ladder (63 windows of 4 doublings and 2 additions, the last with
// T) and one ristretto encode (255 squarings, 21 products): about 3,300
// field multiplications, each at least 64 32-bit multiplies (36 for a
// square), the count the bound in chip_smoke.py uses; this design issues
// 100 wide multiplies per product and per square. It reads 96 bytes of
// input and at most the 4 KiB cache entry.
//
// Design: one thread per signature, A's table read from the int16 cache
// entry (ge_straus_base_cached in ladder.cuh). R is never decoded; the
// ladder's last addition writes T, which the encoder reads, as the
// reference's double_scalar_mul_base(..., final_t=True) does.
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void verify_sr_cached_single_rows(const int16_t *tables, const uint8_t *oks,
                                             const int32_t *slots, const uint8_t *r_enc,
                                             const uint8_t *s_bytes, const uint8_t *k_bytes,
                                             const int32_t *base_table, uint8_t *out, int n,
                                             int capacity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // a slot wraps from the end, then clamps, as the reference's jnp gather does
  const int slot = cache_slot(slots[i], capacity);
  ge q;
  ge_straus_base_cached(q, base_table, tables + (size_t)slot * 16 * 128, s_bytes + 32 * i,
                        k_bytes + 32 * i, true);
  uint8_t enc[32];
  ristretto_encode(enc, q);
  const uint8_t *r = r_enc + 32 * i;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 32; j++) eq = eq && enc[j] == r[j];
  out[i] = (oks[slot] && eq) ? 1 : 0;
}

extern "C" int tm_verify_sr_cached(const void *tables, const void *oks, const void *slots,
                                   const void *r_enc, const void *s_bytes, const void *k_bytes,
                                   const void *base_table, void *out, int n, int capacity,
                                   void *stream) {
  const int threads = 128;
  verify_sr_cached_single_rows<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)base_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
