// Cache-hit bitmap on the split ladder: [8]([s]B - [k]A) == [8]R with -A's
// power tables read from the device-resident pubkey cache by slot, at
// S = `splits` chunks (2, 4 or 8).
//
// Replaces the JAX program `verify_kernel_cached_split`
// (tendermint_tpu/ops/verify.py:157, body verify_kernel_cached_split_impl
// at :144).
//
// Bound on this card: integer multiplies. A row decodes R (about 265 field
// multiplications), runs [s]B + [k]A' and the 6 cofactor doublings: the
// least work is the shared ladder's 64/S steps of 4 doublings and 2 S
// additions, at S = 4 about 1,900 field multiplications (2,450 at S = 2,
// 1,700 at S = 8), each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. It reads 96 bytes of input, and
// 64 table entries of 256 bytes (16 KiB) from the cache, out of an entry
// of 4 S KiB.
//
// Design: the one-thread-a-row kernel left 1,024 rows on 8 of 132 SMs,
// each thread running ~1,900 dependent products. Here a row is 2 S lanes
// of a warp running ladder.cuh's ge_split_lanes<S> (S comb lanes and S
// power lanes, each a Horner chain of 64/S windows, then a shuffle tree),
// so its chain is (64/S - 1) steps of 4 doublings and one addition plus
// log2(2 S) additions: ~570 products at S = 4 instead of ~1,640. The lanes
// do S times the doublings of the shared ladder (2 S chains of 4 (64/S -
// 1) doublings against 4 (64/S) shared ones). R's decode (ZIP-215) runs
// in a second warp of the block, one lane a row, beside the ladder warp:
// on a lane of the ladder warp its ~265 products would diverge from the
// row's other lanes and add to the warp's chain. A block is W ladder warps
// and the decode warp (ladder.cuh's split_hit_warps picks W from the rows
// and the card's occupancy): at 1,024 rows W = 1, 64 threads and 16/S rows
// a block, 128-512 blocks; past one wave of those, up to 7 ladder warps
// share a decode warp. Lane 0 of each row then takes R from shared memory
// and decides with the cofactored equality. The sums come in another order than the plain
// version's; the additions are complete on ed25519, so the group element
// and the verdict are the same; a row whose R does not decode is decided
// by its decode bit, and a slot whose key did not decode by oks. Cache
// entries are int16 radix-2^8 limbs (canonical from the port's fill, or
// the reference's signed limbs carried across by cache_from_reference),
// converted to the ten-limb field as they are read. One instantiation per
// S (the ladder's chunk count is a template parameter: one ladder with S
// read at run time crashed the device compiler).
#include <cuda_runtime.h>

#include "ladder.cuh"

template <int S>
__global__ void __launch_bounds__(32 * (split_lanes<S>::max_warps + 1))
    verify_cached_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
          const uint8_t *r_enc, const uint8_t *s_bytes, const uint8_t *k_bytes,
          const int32_t *fixed_table, uint8_t *out, int n, int capacity) {
  constexpr int lanes = split_lanes<S>::lanes;
  __shared__ ge r_pts[split_lanes<S>::max_rows];
  __shared__ bool r_oks[split_lanes<S>::max_rows];
  // warps 0 .. W - 1 run the ladder, 32 / (2 S) rows a warp; warp W
  // decodes R for the block's W * 32 / (2 S) rows
  const int ladder_warps = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int block_rows = ladder_warps * split_lanes<S>::rows;
  const int row0 = blockIdx.x * block_rows;
  const int j = warp * split_lanes<S>::rows + lane / lanes;  // the ladder lane's row in the block
  // rows past n run on the last row's inputs and are never written
  const int i = min(row0 + j, n - 1);
  // a slot wraps from the end, then clamps, as the reference's jnp gather does
  const int slot = cache_slot(slots[i], capacity);
  ge q;
  if (warp == ladder_warps) {
    if (lane < block_rows)
      r_oks[lane] = ge_decompress(r_pts[lane], r_enc + 32 * min(row0 + lane, n - 1));
  } else {
    ge_split_lanes<S>(q, lane % lanes, tables + (size_t)slot * S * 16 * 128, fixed_table,
                      s_bytes + 32 * i, k_bytes + 32 * i);
  }
  __syncthreads();
  if (warp < ladder_warps && lane % lanes == 0 && row0 + j < n)
    out[i] = (oks[slot] && r_oks[j] && ge_cofactored_equal(q, r_pts[j])) ? 1 : 0;
}

template <int S>
static int launch_rows(const void *tables, const void *oks, const void *slots, const void *r_enc,
                       const void *s_bytes, const void *k_bytes, const void *fixed_table,
                       void *out, int n, int capacity, cudaStream_t st) {
  int warps;
  const cudaError_t e = split_hit_warps<S>(verify_cached_rows<S>, n, &warps);
  if (e != cudaSuccess) return (int)e;
  verify_cached_rows<S><<<grid_for(n, warps * split_lanes<S>::rows), 32 * (warps + 1), 0, st>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)fixed_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}

extern "C" int tm_verify_cached_split(const void *tables, const void *oks, const void *slots,
                                      const void *r_enc, const void *s_bytes, const void *k_bytes,
                                      const void *fixed_table, void *out, int n, int capacity,
                                      int splits, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (splits) {
    case 2:
      return launch_rows<2>(tables, oks, slots, r_enc, s_bytes, k_bytes, fixed_table, out, n,
                            capacity, st);
    case 4:
      return launch_rows<4>(tables, oks, slots, r_enc, s_bytes, k_bytes, fixed_table, out, n,
                            capacity, st);
    case 8:
      return launch_rows<8>(tables, oks, slots, r_enc, s_bytes, k_bytes, fixed_table, out, n,
                            capacity, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
