// sr25519 cache-hit bitmap on the split ladder: R == encode([s]B - [k]A)
// with -A's power tables read from the device-resident sr25519 pubkey
// cache by slot, at S = `splits` chunks (2, 4 or 8).
//
// Replaces the JAX program `verify_sr_kernel_cached_split`
// (tendermint_tpu/ops/verify_sr.py:112, body
// verify_sr_kernel_cached_split_impl at :92).
//
// Bound on this card: integer multiplies. A row runs 64/S steps of 4
// doublings and 2 S additions and one ristretto encode (255 squarings, 21
// products): at S = 4 about 1,900 field multiplications, each at least 64
// 32-bit multiplies (36 for a square), the count the bound in
// chip_smoke.py uses; this design issues 100 wide multiplies per product
// and per square. It reads 96 bytes of input, and 64 table entries of 256
// bytes (16 KiB) from the cache, out of an entry of 4 S KiB.
//
// Design: verify_cached.cu's, one thread per signature and one
// instantiation per S (the ladder is ladder.cuh's). R is never decoded.
// The reference's split ladder returns no T and adds the identity to
// regenerate it; here the ladder's last addition writes T instead, which
// gives a projectively scaled point with T Z = X Y and therefore the same
// encoding.
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

template <int S>
__global__ void verify_sr_cached_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                                      const uint8_t *r_enc, const uint8_t *s_bytes,
                                      const uint8_t *k_bytes, const int32_t *fixed_table,
                                      uint8_t *out, int n, int capacity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // an out-of-range slot clamps, as the reference's XLA gather does
  const int slot = min(max(slots[i], 0), capacity - 1);
  ge q;
  ge_straus_split<S>(q, tables + (size_t)slot * S * 16 * 128, fixed_table, s_bytes + 32 * i,
                     k_bytes + 32 * i, true);
  uint8_t enc[32];
  ristretto_encode(enc, q);
  const uint8_t *r = r_enc + 32 * i;
  bool eq = true;
#pragma unroll
  for (int j = 0; j < 32; j++) eq = eq && enc[j] == r[j];
  out[i] = (oks[slot] && eq) ? 1 : 0;
}

template <int S>
static int launch_rows(const void *tables, const void *oks, const void *slots, const void *r_enc,
                       const void *s_bytes, const void *k_bytes, const void *fixed_table,
                       void *out, int n, int capacity, cudaStream_t st) {
  const int threads = 128;
  verify_sr_cached_rows<S><<<grid_for(n, threads), threads, 0, st>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)fixed_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}

extern "C" int tm_verify_sr_cached_split(const void *tables, const void *oks, const void *slots,
                                         const void *r_enc, const void *s_bytes,
                                         const void *k_bytes, const void *fixed_table, void *out,
                                         int n, int capacity, int splits, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (splits) {
    case 2:
      return launch_rows<2>(tables, oks, slots, r_enc, s_bytes, k_bytes, fixed_table, out, n,
                            capacity, st);
    case 4:
      return launch_rows<4>(tables, oks, slots, r_enc, s_bytes, k_bytes, fixed_table, out, n,
                            capacity, st);
    case 8:
      return launch_rows<8>(tables, oks, slots, r_enc, s_bytes, k_bytes, fixed_table, out, n,
                            capacity, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
