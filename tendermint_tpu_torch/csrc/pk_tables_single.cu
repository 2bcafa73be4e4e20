// Pubkey-cache fill on the single-table plane (TM_TPU_PK_SPLIT=1): decode
// each key A and write the 16-multiples table of -A.
//
// Replaces the JAX program `build_pk_tables`
// (tendermint_tpu/ops/verify.py:95, body build_pk_tables_impl at :84).
//
// Output keeps the reference's cache format, (B, 16, 4, 32) int16 in
// radix-2^8 limbs, every coordinate written canonical (bytes 0..255): the
// same bytes as pk_tables.cu's (B, 1, 16, 4, 32) at S = 1. The reference's
// _build_var_table is build_power_tables at one split: decode, negate,
// entries 0, P, 2P and 13 more additions.
//
// Bound on this card: integer multiplies. A key costs one decode (256
// squarings, 19 products) and 14 additions (9M): about 400 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses. 64 canonicalizations; 32
// bytes in and 4 KiB out.
//
// What holds it back is latency: a key is one chain of ~275 dependent
// products in the decode, then 42 rounds of additions, and 1,024 keys are
// few threads. Design: a quad a key on coop.cuh's coop_fill at S = 1 (the
// body of the split fills), blocks of one warp, so 1,024 keys spread over
// 128 SMs; the decoder is coop_decode.cuh's coop_ge_decompress, which
// splits each of the decode's products across the quad's four lanes (30
// of fe_mul's 100 terms a lane, 18 of a square's 55, then twenty shuffles
// and the carry chain), so the four lanes do not run one chain four
// times. At most 10 blocks an SM (launch bounds), so 10,240 keys are one
// wave.
#include <cuda_runtime.h>

#include "coop_decode.cuh"

__global__ void __launch_bounds__(COOP_FILL_THREADS, 10)
    build_table(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n) {
  coop_fill([](ge &p, const uint8_t *enc) { return coop_ge_decompress(p, enc); }, a_enc, tables,
            oks, n, 1);
}

extern "C" int tm_build_pk_tables_single(const void *a_enc, void *tables, void *oks, int n,
                                         void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  build_table<<<grid_for(4 * n, COOP_FILL_THREADS), COOP_FILL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n);
  return (int)cudaGetLastError();
}
