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
// Design: pk_tables.cu's, one thread per key, with ristretto decode in
// place of ZIP-215 decompression (write_power_tables in ladder.cuh).
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void build_sr_tables(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n,
                                int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  oks[i] = ristretto_decode(p, a_enc + 32 * i) ? 1 : 0;
  ge_neg(p, p);
  write_power_tables(tables + (size_t)i * splits * 16 * 128, p, splits);
}

extern "C" int tm_build_sr_tables(const void *a_enc, void *tables, void *oks, int n, int splits,
                                  void *stream) {
  if (!valid_splits(splits)) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  build_sr_tables<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n, splits);
  return (int)cudaGetLastError();
}
