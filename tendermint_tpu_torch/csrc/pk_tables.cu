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
// the reference's (decode, negate, c - 1 doublings without T and one with
// T per power, then repeated addition), so every coordinate equals the
// reference's modulo p.
//
// Bound on this card: integer multiplies. A key costs one decode (about
// 265 field multiplications), (S - 1) * 256/S doublings (7-8M; 128, 192
// and 224 at S = 2, 4, 8) and S x 14 additions (9M): at S = 4 about 2,300
// field multiplications, each at least 64 32-bit multiplies (36 for a
// square), the count the bound in chip_smoke.py uses; this design issues
// 100 wide multiplies per product and per square. 64 S
// canonicalizations; 32 bytes in and 4 S KiB out.
//
// Design: one thread per key; each table entry is canonicalized and
// written as it is produced, so nothing but the running point stays live
// (write_power_tables in ladder.cuh, shared with the single-table fills,
// which are this kernel at S = 1; the sr25519 split fill runs four lanes a
// key instead, coop.cuh).
#include <cuda_runtime.h>

#include "ladder.cuh"

__global__ void build_tables(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n,
                             int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  oks[i] = ge_decompress(p, a_enc + 32 * i) ? 1 : 0;
  ge_neg(p, p);
  write_power_tables(tables + (size_t)i * splits * 16 * 128, p, splits);
}

extern "C" int tm_build_pk_tables(const void *a_enc, void *tables, void *oks, int n, int splits,
                                  void *stream) {
  if (!valid_splits(splits)) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  build_tables<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n, splits);
  return (int)cudaGetLastError();
}
