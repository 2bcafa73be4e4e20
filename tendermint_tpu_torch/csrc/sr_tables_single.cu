// sr25519 pubkey-cache fill on the single-table plane (TM_TPU_PK_SPLIT=1):
// ristretto-decode each key A and write the 16-multiples table of -A.
//
// Replaces the JAX program `build_sr_tables`
// (tendermint_tpu/ops/verify_sr.py:59, body build_sr_tables_impl at :49).
//
// Output keeps the reference's cache format, (B, 16, 4, 32) int16 in
// radix-2^8 limbs, every coordinate written canonical: sr_tables.cu's
// kernel at S = 1.
//
// Bound on this card: integer multiplies. A key costs one ristretto decode
// (256 squarings, 18 products) and 14 additions (9M): about 400 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. 64 canonicalizations; 32 bytes
// in and 4 KiB out.
//
// Design: one thread per key, write_power_tables (ladder.cuh) at one split.
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

__global__ void build_sr_table(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  oks[i] = ristretto_decode(p, a_enc + 32 * i) ? 1 : 0;
  ge_neg(p, p);
  write_power_tables(tables + (size_t)i * 16 * 128, p, 1);
}

extern "C" int tm_build_sr_tables_single(const void *a_enc, void *tables, void *oks, int n,
                                         void *stream) {
  const int threads = 128;
  build_sr_table<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n);
  return (int)cudaGetLastError();
}
