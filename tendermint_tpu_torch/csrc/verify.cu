// Uncached per-signature bitmap: the cofactored ZIP-215 check
// [8]([s]B - [k]A) == [8]R for every row of a batch.
//
// Replaces the JAX program `verify_kernel` (tendermint_tpu/ops/verify.py:81,
// body verify_kernel_impl at :58), which runs the whole batch in lock step
// on the TPU's vector lanes with one-hot table selects.
//
// Bound on this card: integer multiplies. A row decodes two points (about
// 265 field multiplications each), builds 15 table entries (9M each) and
// runs 63 windows of 4 doublings and 2 additions plus the 6 cofactor
// doublings: about 4,400 field multiplications, each at least 64 32-bit
// multiplies (36 for a square), the count the bound in chip_smoke.py uses;
// this design issues 100 wide multiplies per product and per square.
// Memory traffic is 128 bytes in and 1 byte out.
//
// What holds it back is latency, not throughput: a row of the first,
// one-thread design was one chain of ~3,750 dependent field products, and
// 16,384 rows filled one wave of threads at 255 registers. So the work is
// split in two launches behind one entry point:
//   1. verify_tables: one thread per point of -A | R (2 n threads, 32,768
//      at 16,384 rows, one wave at 255 registers). Thread i < n decodes A
//      (ZIP-215) and writes -A as entry 1 of its table, thread n + i
//      decodes R and writes -R; each point a contiguous 160-byte row, each
//      thread a decode bit.
//   2. verify_ladder: four lanes a row (a quad, coop.cuh), lane q holding
//      coordinate q of the running point, so each point operation is two
//      (doubling) or three (addition) rounds of one product a lane. The
//      quad first builds -A's multiples 0, 2, ..., 15 (14 additions, 42
//      rounds; each lane writes its coordinate, then __syncwarp), then runs
//      63 Straus windows of 4 doublings and 2 additions (B's entry from the
//      block's shared-memory copy of the base table, then -A's), about 880
//      rounds (coop.cuh coop_straus_base, the sr25519 bitmap's ladder
//      too, verify_sr.cu), then adds -R and clears the cofactor by 3
//      doublings: the row is valid when [8]([s]B - [k]A - R) is the
//      identity, X = 0 and Y = Z.
//      That is the reference's group equation [8]([s]B - [k]A) == [8]R on
//      the decoded points (the laws are complete on ed25519, so coinciding
//      or small-order points need no branch); a row whose A or R does not
//      decode is false whatever its point.
// Building -A's multiples in step 1 on a lone lane instead (14 additions,
// ~126 dependent products) measured slower at every batch size. A quad
// past the end of the batch runs the last row (it writes that row's table
// with the same values) and writes no bit, so every lane of a warp
// reaches every shuffle.
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ladder.cuh"

constexpr int VERIFY_TABLE_THREADS = 128;
constexpr int VERIFY_LADDER_THREADS = 128;  // 32 rows a block

// Scratch: 17 rows of 40 int32 a signature (the 16 multiples of -A, then
// -R), then 2 n decode bytes (A's, then R's).
__global__ void verify_tables(const uint8_t *a_enc, const uint8_t *r_enc, int32_t *tabs,
                              uint8_t *oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  ge p;
  const bool a_row = i < n;
  oks[i] = ge_decompress(p, a_row ? a_enc + 32 * i : r_enc + 32 * (i - n)) ? 1 : 0;
  ge_neg(p, p);
  // -A as entry 1 of its row's table (step 2 builds the rest), -R after the tables
  ge_store_row(tabs + (a_row ? ((size_t)i * 16 + 1) * 40 : ((size_t)16 * n + (i - n)) * 40), p);
}

__global__ void __launch_bounds__(VERIFY_LADDER_THREADS)
    verify_ladder(const uint8_t *s_bytes, const uint8_t *k_bytes, const int32_t *base_table,
                  int32_t *tabs, const uint8_t *oks, uint8_t *out, int n) {
  __shared__ int32_t sh_b[16 * B_SLOT];
  coop_base_to_shared(sh_b, base_table);
  const int t = threadIdx.x, q = t & 3;
  const int row_raw = blockIdx.x * (blockDim.x / 4) + t / 4;
  const int row = min(row_raw, n - 1);
  fe mine;
  coop_straus_base(mine, q, sh_b, tabs + (size_t)row * 16 * 40, s_bytes + 32 * row,
                   k_bytes + 32 * row);
  coop_add(mine, tabs + ((size_t)16 * n + row) * 40, 1, q);  // - R
#pragma unroll 1
  for (int i = 0; i < 3; i++) coop_dbl(mine, q);
  fe y, z;
  fe_shfl(y, mine, 1);
  fe_shfl(z, mine, 2);
  if (q != 0 || row_raw >= n) return;
  fe_sub(y, y, z);
  const bool identity = fe_iszero(mine) && fe_iszero(y);
  out[row] = (oks[row] && oks[n + row] && identity) ? 1 : 0;
}

extern "C" int tm_verify(const void *a_enc, const void *r_enc, const void *s_bytes,
                         const void *k_bytes, const void *base_table, void *scratch, void *out,
                         int n, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t *tabs = (int32_t *)scratch;
  uint8_t *oks = (uint8_t *)(tabs + (size_t)17 * 40 * n);
  verify_tables<<<grid_for(2 * n, VERIFY_TABLE_THREADS), VERIFY_TABLE_THREADS, 0, st>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, tabs, oks, n);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  verify_ladder<<<grid_for(4 * n, VERIFY_LADDER_THREADS), VERIFY_LADDER_THREADS, 0, st>>>(
      (const uint8_t *)s_bytes, (const uint8_t *)k_bytes, (const int32_t *)base_table, tabs, oks,
      (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
