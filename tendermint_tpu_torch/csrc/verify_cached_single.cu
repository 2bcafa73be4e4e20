// Cache-hit bitmap on the single-table plane (TM_TPU_PK_SPLIT=1):
// [8]([s]B - [k]A) == [8]R with -A's 16 multiples read from the
// device-resident pubkey cache by slot.
//
// Replaces the JAX program `verify_kernel_cached`
// (tendermint_tpu/ops/verify.py:113, body verify_kernel_cached_impl at
// :98).
//
// Bound on this card: integer multiplies. A row decodes R (about 265 field
// multiplications), runs the 252-doubling Straus ladder (63 windows of 4
// doublings and 2 additions, and the top window's addition) and the 6
// cofactor doublings: about 3,300 field multiplications, each at least 64
// 32-bit multiplies (36 for a square), the count the bound in
// chip_smoke.py uses; this design issues 100 wide multiplies per product
// and per square. It reads 96 bytes of input and at most the 4 KiB cache
// entry.
//
// Design: the one-thread-a-row kernel ran each row as one chain of ~3,300
// dependent products and left 1,024 rows on 8 of 132 SMs. Here a row is a
// quad (coop.cuh coop_cached_hit, the sr25519 hit's body too): its four
// lanes run the uncached bitmap's window loop (coop_straus_with, 63
// windows, ~880 rounds of one product a lane) with -A's multiples read
// straight from the int16 cache entry (coop_load_cached, limbs read modulo
// p, so the JAX cache's signed limbs work as the port's canonical ones),
// so no table is built. R's ZIP-215 decode (~265 products) runs in the
// block's decode warp, a lane a row, beside the ladder warps, which then
// add the stored -R, clear the cofactor by 3 doublings and test the
// identity, X = 0 and Y = Z, as verify.cu's ladder does. A block is W
// ladder warps of 8 rows and the decode warp, W = 3 or 4 by the rows and
// the card's SMs (coop.cuh hit1_warps: no two ladder warps on one of an
// SM's schedulers while the card has room). A row whose
// R does not decode is decided by its decode bit, a slot whose key did not
// decode by oks.
#include <cuda_runtime.h>

#include "coop.cuh"

__global__ void __launch_bounds__(32 * (HIT1_MAX_WARPS + 1), HIT1_MIN_BLOCKS)
    verify_cached_single_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                              const uint8_t *r_enc, const uint8_t *s_bytes,
                              const uint8_t *k_bytes, const int32_t *base_table, uint8_t *out,
                              int n, int capacity) {
  coop_cached_hit(
      [](ge &p, const uint8_t *enc) {
        const bool ok = ge_decompress(p, enc);
        ge_neg(p, p);  // -R, which the quad adds
        return ok;
      },
      [](fe &mine, int q, const int32_t *neg_r) {
        return coop_cofactored_identity(mine, q, neg_r);
      },
      tables, oks, slots, r_enc, s_bytes, k_bytes, base_table, out, n, capacity);
}

extern "C" int tm_verify_cached(const void *tables, const void *oks, const void *slots,
                                const void *r_enc, const void *s_bytes, const void *k_bytes,
                                const void *base_table, void *out, int n, int capacity,
                                void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int warps;
  const cudaError_t e = hit1_warps(n, &warps);
  if (e != cudaSuccess) return (int)e;
  verify_cached_single_rows<<<grid_for(n, warps * HIT1_ROWS), 32 * (warps + 1), 0,
                              (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)base_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
