// sr25519 cache-hit bitmap on the single-table plane (TM_TPU_PK_SPLIT=1):
// R == encode([s]B - [k]A) with -A's 16 multiples read from the
// device-resident sr25519 pubkey cache by slot, decided here as decode(R)
// ok and ristretto_equal(decode(R), [s]B - [k]A).
//
// Replaces the JAX program `verify_sr_kernel_cached`
// (tendermint_tpu/ops/verify_sr.py:75, body verify_sr_kernel_cached_impl
// at :62).
//
// Bound on this card: integer multiplies. A row ristretto-decodes R (256
// squarings, 18 products), runs the 252-doubling Straus ladder (63
// windows of 4 doublings and 2 additions, and the top window's addition)
// and decides with 4 products: about 3,150 field multiplications, each at
// least 64 32-bit multiplies (36 for a square), the count the bound in
// chip_smoke.py uses; this design issues 100 wide multiplies per product
// and per square. It reads 96 bytes of input and at most the 4 KiB cache
// entry.
//
// Design: verify_cached_single.cu's (coop.cuh coop_cached_hit): a quad a
// row runs the 63 windows on the int16 cache entry, and the block's decode
// warp ristretto-decodes R beside the ladder warps; lane 0 of each quad
// then takes X and Y of Q = [s]B - [k]A from lanes 0 and 1 and decides
// oks[slot] && decode(R) ok && ristretto_equal(R, Q) (RFC 9496 section
// 4.5, 4 products). The one-thread kernel ended each row's chain with a
// serial encode of Q (255 squarings, 21 products) compared with R's
// bytes; the two decisions are the same function, by the proof in
// verify_sr_cached.cu: A and B lie in 2E, so Q does too, and that holds
// for a JAX cache carried across, whose entries are multiples of -A.
// There is no cofactor step: ristretto255 has prime order.
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ristretto.cuh"

__global__ void __launch_bounds__(32 * (HIT1_MAX_WARPS + 1), HIT1_MIN_BLOCKS)
    verify_sr_cached_single_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                                 const uint8_t *r_enc, const uint8_t *s_bytes,
                                 const uint8_t *k_bytes, const int32_t *base_table,
                                 uint8_t *out, int n, int capacity) {
  coop_cached_hit(
      [](ge &p, const uint8_t *enc) { return ristretto_decode(p, enc); },
      [](fe &mine, int q, const int32_t *r_row) {
        ge qp, rp;  // X and Y of Q and of R: ristretto_equal reads nothing else
        fe_shfl(qp.X, mine, 0);
        fe_shfl(qp.Y, mine, 1);
        fe_load_coord(rp.X, r_row, 0, 1);
        fe_load_coord(rp.Y, r_row, 1, 1);
        return ristretto_equal(rp, qp);
      },
      tables, oks, slots, r_enc, s_bytes, k_bytes, base_table, out, n, capacity);
}

extern "C" int tm_verify_sr_cached(const void *tables, const void *oks, const void *slots,
                                   const void *r_enc, const void *s_bytes, const void *k_bytes,
                                   const void *base_table, void *out, int n, int capacity,
                                   void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int warps;
  const cudaError_t e = hit1_warps(n, &warps);
  if (e != cudaSuccess) return (int)e;
  verify_sr_cached_single_rows<<<grid_for(n, warps * HIT1_ROWS), 32 * (warps + 1), 0,
                                 (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)base_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
