// Pubkey-cache fill on the split plane: decode each key A and write the
// 16-multiples tables of -A, -[2^c]A, -[2^2c]A, ... at S = `splits` chunks
// of c = 256/S bits (S = 2, 4 or 8, TM_TPU_PK_SPLIT).
//
// Replaces the JAX program `build_pk_tables_split`
// (tendermint_tpu/ops/verify.py:141, body build_pk_tables_split_impl at
// :130).
//
// Output keeps the reference's cache format, (B, S, 16, 4, 32) int16 in
// radix-2^8 limbs, with every coordinate written canonical (bytes 0..255),
// which meets the cache's |limb| < 2^9 contract. The formula sequence is
// the reference's (decode, negate, 256/S doublings per power, then
// repeated addition), so every coordinate equals the reference's modulo p.
//
// Bound on this card: integer multiplies. A key costs one ZIP-215 decode
// (256 squarings, 19 products), (S - 1) * 256/S doublings (7-8M; 128, 192
// and 224 at S = 2, 4, 8) and S x 14 additions (9M): at S = 4 about 2,300
// field multiplications, each at least 64 32-bit multiplies (36 for a
// square), the count the bound in chip_smoke.py uses; this design issues
// 100 wide multiplies per product and per square. 64 S
// canonicalizations; 32 bytes in and 4 S KiB out.
//
// What holds it back is latency: a key is one chain of dependent products,
// and 1,024 keys are few threads (one thread a key filled 8 of 132 SMs).
// Design: the sr25519 split fill's (sr_tables.cu), with ZIP-215's
// ge_decompress as the decoder; the body is coop.cuh's coop_fill. Four
// lanes a key (a quad), blocks of one warp (eight keys), so 1,024 keys
// spread over 128 SMs; the quad decodes in lock step, then each doubling
// takes two rounds and each addition three, one product a lane a round,
// and each lane canonicalizes and stores its own coordinate, so a quad
// writes an entry's 256 bytes as one run of 16-byte stores. At most 10
// blocks an SM (launch bounds), so 10,240 keys are one wave.
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ladder.cuh"

__global__ void __launch_bounds__(COOP_FILL_THREADS, 10)
    build_tables(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n, int splits) {
  coop_fill([](ge &p, const uint8_t *enc) { return ge_decompress(p, enc); }, a_enc, tables, oks,
            n, splits);
}

extern "C" int tm_build_pk_tables(const void *a_enc, void *tables, void *oks, int n, int splits,
                                  void *stream) {
  if (!valid_splits(splits) || n < 1) return (int)cudaErrorInvalidValue;
  build_tables<<<grid_for(4 * n, COOP_FILL_THREADS), COOP_FILL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n, splits);
  return (int)cudaGetLastError();
}
