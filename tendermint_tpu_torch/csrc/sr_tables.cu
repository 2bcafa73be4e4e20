// sr25519 pubkey-cache fill on the split plane: ristretto-decode each key A
// and write the 16-multiples tables of -A, -[2^c]A, -[2^2c]A, ... at
// S = `splits` chunks of c = 256/S bits (S = 2, 4 or 8).
//
// Replaces the JAX program `build_sr_tables_split`
// (tendermint_tpu/ops/verify_sr.py:89, body build_sr_tables_split_impl at
// :78).
//
// Output keeps the reference's cache format, (B, S, 16, 4, 32) int16 in
// radix-2^8 limbs, every coordinate written canonical, the same layout as
// the ed25519 fill (pk_tables.cu), into a cache of its own: the same bytes
// decode to other points under ZIP-215.
//
// Bound on this card: integer multiplies. A key costs one ristretto decode
// (256 squarings, 18 products), (S - 1) * 256/S doublings (7-8M) and
// S x 14 additions (9M): at S = 4 about 2,300 field multiplications, each
// at least 64 32-bit multiplies (36 for a square), the count the bound in
// chip_smoke.py uses; this design issues 100 wide multiplies per product
// and per square. 64 S canonicalizations; 32 bytes in and 4 S KiB out.
//
// What holds it back is latency: a key is one chain of dependent products,
// and 1,024 keys are few threads. Design: four lanes a key (a quad,
// coop.cuh), blocks of one warp (eight keys), so 1,024 keys spread over
// 128 SMs. The body is coop.cuh's coop_fill, shared with the ed25519 split
// fill (pk_tables.cu), which differs only in its decoder. The quad's four
// lanes decode the key in lock step (the same work on each lane, no
// divergence within the quad), then lane q keeps coordinate q of -A; the
// doublings take two rounds and the additions three, one product a lane a
// round (coop_write_power_tables). Each lane canonicalizes and stores its
// own coordinate of each entry, so a quad writes an entry's 256 bytes as
// one run of 16-byte stores. At most 10 blocks an SM (launch bounds, 168
// registers): 10,240 keys are then one wave instead of two at 255
// registers, at the price of ~800 bytes of spills in the decode, which
// measured no slower at 1,024 or 4,096 keys.
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void __launch_bounds__(COOP_FILL_THREADS, 10)
    build_sr_tables(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n, int splits) {
  coop_fill([](ge &p, const uint8_t *enc) { return ristretto_decode(p, enc); }, a_enc, tables,
            oks, n, splits);
}

extern "C" int tm_build_sr_tables(const void *a_enc, void *tables, void *oks, int n, int splits,
                                  void *stream) {
  if (!valid_splits(splits) || n < 1) return (int)cudaErrorInvalidValue;
  build_sr_tables<<<grid_for(4 * n, COOP_FILL_THREADS), COOP_FILL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n, splits);
  return (int)cudaGetLastError();
}
