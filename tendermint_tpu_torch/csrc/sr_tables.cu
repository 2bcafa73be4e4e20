// sr25519 pubkey-cache fill on the split plane: ristretto-decode each key A
// and write the 16-multiples tables of -A, -[2^64]A, -[2^128]A and
// -[2^192]A.
//
// Replaces the JAX program `build_sr_tables_split`
// (tendermint_tpu/ops/verify_sr.py:89, body build_sr_tables_split_impl at
// :78).
//
// Output keeps the reference's cache format, (B, 4, 16, 4, 32) int16 in
// radix-2^8 limbs, every coordinate written canonical, the same layout as
// the ed25519 fill (pk_tables.cu), into a cache of its own: the same bytes
// decode to other points under ZIP-215.
//
// Bound on this card: integer multiplies. A key costs one ristretto decode
// (256 squarings, 18 products), 192 doublings (7-8M) and 4 x 14 additions
// (9M): about 2,300 field multiplications, each at least 64 32-bit
// multiplies (36 for a square), the count the bound in chip_smoke.py uses;
// this design issues 100 wide multiplies per product and per square.
// 256 canonicalizations; 32 bytes in and 16 KiB out.
//
// Design: pk_tables.cu's, one thread per key, with ristretto decode in
// place of ZIP-215 decompression (write_power_tables in ladder.cuh).
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void build_sr_tables(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  oks[i] = ristretto_decode(p, a_enc + 32 * i) ? 1 : 0;
  ge_neg(p, p);
  write_power_tables(tables + (size_t)i * 4 * 16 * 128, p);
}

extern "C" int tm_build_sr_tables(const void *a_enc, void *tables, void *oks, int n, void *stream) {
  const int threads = 128;
  build_sr_tables<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n);
  return (int)cudaGetLastError();
}
