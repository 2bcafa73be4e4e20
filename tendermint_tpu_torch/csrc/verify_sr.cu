// Uncached sr25519 bitmap: R == encode([s]B - [k]A) for every row of a
// batch, the reference's byte comparison with the wire R, decided here as
// decode(R) ok and ristretto_equal(decode(R), [s]B - [k]A).
//
// Replaces the JAX program `verify_sr_kernel`
// (tendermint_tpu/ops/verify_sr.py:46, body verify_sr_kernel_impl at :32).
//
// Bound on this card: integer multiplies. A row decodes A and R with the
// ristretto codec (256 squarings, 18 products each), builds 15 table
// entries (9M each), runs 63 windows of 4 doublings and 2 additions, and
// decides with 4 products: about 4,100 field multiplications, each at
// least 64 32-bit multiplies (36 for a square), the count the bound in
// chip_smoke.py uses; this design issues 100 wide multiplies per product
// and per square. Memory traffic is 128 bytes in and 1 byte out.
//
// What holds it back is latency, not throughput: a row of the first,
// one-thread design was one chain of ~4,100 dependent field products,
// and its time hardly moved with the batch. So the work is the ed25519
// bitmap's two launches behind one entry point (verify.cu):
//   1. verify_sr_tables: one thread per point of A | R (2 n threads).
//      Thread i < n ristretto-decodes A and writes -A as entry 1 of its
//      table, thread n + i decodes R and writes R after the tables; each
//      point a contiguous 160-byte row, each thread a decode bit.
//   2. verify_sr_ladder: four lanes a row (a quad, coop.cuh): the quad
//      builds -A's multiples 0, 2, ..., 15 and runs the 63 windows
//      (coop_straus_base, the ed25519 bitmap's ladder), then lane 0 takes
//      X and Y of Q = [s]B - [k]A from lanes 0 and 1 and decides
//      okA && okR && ristretto_equal(R, Q) (RFC 9496 section 4.5, 4
//      products). There is no cofactor step: ristretto255 has prime order.
// The decision computes the reference's encode(Q) == R: both are false
// when A does not decode, and otherwise Q lies in 2E, where encode(Q) == R
// holds exactly when R decodes to a point equal to Q (the proof is
// verify_sr_cached.cu's; tests/test_torch_coop_lanes.py holds this
// kernel's schedule to the JAX program on the edge rows). A quad past the
// end of the batch runs the last row (it writes that row's table with the
// same values) and writes no bit, so every lane of a warp reaches every
// shuffle.
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ristretto.cuh"

constexpr int VERIFY_SR_TABLE_THREADS = 128;
constexpr int VERIFY_SR_LADDER_THREADS = 128;  // 32 rows a block
// Blocks an SM, so at most 80 registers a thread: left free, ptxas gave
// this kernel 142 (the ed25519 ladder, the same loop and another tail, 80)
// and an SM half the warps.
constexpr int VERIFY_SR_LADDER_BLOCKS = 6;

// Scratch: 17 rows of 40 int32 a signature (the 16 multiples of -A, then
// R), then 2 n decode bytes (A's, then R's).
__global__ void verify_sr_tables(const uint8_t *a_enc, const uint8_t *r_enc, int32_t *tabs,
                                 uint8_t *oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  ge p;
  const bool a_row = i < n;
  oks[i] = ristretto_decode(p, a_row ? a_enc + 32 * i : r_enc + 32 * (i - n)) ? 1 : 0;
  if (a_row) ge_neg(p, p);
  // -A as entry 1 of its row's table (step 2 builds the rest), R after the tables
  ge_store_row(tabs + (a_row ? ((size_t)i * 16 + 1) * 40 : ((size_t)16 * n + (i - n)) * 40), p);
}

__global__ void __launch_bounds__(VERIFY_SR_LADDER_THREADS, VERIFY_SR_LADDER_BLOCKS)
    verify_sr_ladder(const uint8_t *s_bytes, const uint8_t *k_bytes, const int32_t *base_table,
                     int32_t *tabs, const uint8_t *oks, uint8_t *out, int n) {
  __shared__ int32_t sh_b[16 * B_SLOT];
  coop_base_to_shared(sh_b, base_table);
  const int t = threadIdx.x, q = t & 3;
  const int row_raw = blockIdx.x * (blockDim.x / 4) + t / 4;
  const int row = min(row_raw, n - 1);
  fe mine;
  coop_straus_base(mine, q, sh_b, tabs + (size_t)row * 16 * 40, s_bytes + 32 * row,
                   k_bytes + 32 * row);
  ge qp, rp;  // X and Y of Q and of R: ristretto_equal reads nothing else
  fe_shfl(qp.X, mine, 0);
  fe_shfl(qp.Y, mine, 1);
  if (q != 0 || row_raw >= n) return;
  const int32_t *r_row = tabs + ((size_t)16 * n + row) * 40;
  fe_load_coord(rp.X, r_row, 0, 1);
  fe_load_coord(rp.Y, r_row, 1, 1);
  out[row] = (oks[row] && oks[n + row] && ristretto_equal(rp, qp)) ? 1 : 0;
}

extern "C" int tm_verify_sr(const void *a_enc, const void *r_enc, const void *s_bytes,
                            const void *k_bytes, const void *base_table, void *scratch, void *out,
                            int n, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t *tabs = (int32_t *)scratch;
  uint8_t *oks = (uint8_t *)(tabs + (size_t)17 * 40 * n);
  verify_sr_tables<<<grid_for(2 * n, VERIFY_SR_TABLE_THREADS), VERIFY_SR_TABLE_THREADS, 0, st>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, tabs, oks, n);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  verify_sr_ladder<<<grid_for(4 * n, VERIFY_SR_LADDER_THREADS), VERIFY_SR_LADDER_THREADS, 0, st>>>(
      (const uint8_t *)s_bytes, (const uint8_t *)k_bytes, (const int32_t *)base_table, tabs, oks,
      (uint8_t *)out, n);
  return (int)cudaGetLastError();
}
