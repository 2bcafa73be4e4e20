// sr25519 pubkey-cache fill on the single-table plane (TM_TPU_PK_SPLIT=1):
// ristretto-decode each key A and write the 16-multiples table of -A.
//
// Replaces the JAX program `build_sr_tables`
// (tendermint_tpu/ops/verify_sr.py:59, body build_sr_tables_impl at :49).
//
// Output keeps the reference's cache format, (B, 16, 4, 32) int16 in
// radix-2^8 limbs, every coordinate written canonical: the same bytes as
// sr_tables.cu's at S = 1.
//
// Bound on this card: integer multiplies. A key costs one ristretto decode
// (256 squarings, 18 products) and 14 additions (9M): about 400 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses. 64 canonicalizations; 32
// bytes in and 4 KiB out.
//
// Design: the ed25519 single-table fill's (pk_tables_single.cu), a quad a
// key on coop.cuh's coop_fill at S = 1, with coop_decode.cuh's
// coop_ristretto_decode, whose products are split across the quad's four
// lanes.
#include <cuda_runtime.h>

#include "coop_decode.cuh"

__global__ void __launch_bounds__(COOP_FILL_THREADS, 10)
    build_sr_table(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n) {
  coop_fill([](ge &p, const uint8_t *enc) { return coop_ristretto_decode(p, enc); }, a_enc,
            tables, oks, n, 1);
}

extern "C" int tm_build_sr_tables_single(const void *a_enc, void *tables, void *oks, int n,
                                         void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  build_sr_table<<<grid_for(4 * n, COOP_FILL_THREADS), COOP_FILL_THREADS, 0,
                   (cudaStream_t)stream>>>((const uint8_t *)a_enc, (int16_t *)tables,
                                           (uint8_t *)oks, n);
  return (int)cudaGetLastError();
}
