// What the cache kernels of both signature planes share: the split cache
// hits' lane-parallel ladder and launch shape (verify_cached.cu,
// verify_sr_cached.cu), and the cache's geometries and slot rule, which
// every cache kernel reads. The planes differ only in how points are
// decoded and compared (ge25519.cuh, ristretto.cuh). The single-table
// hits, the uncached bitmaps and every fill run four lanes a point
// (coop.cuh) and take only the helpers below.
#pragma once
#include "ge25519.cuh"

// The split cache hit's lane-parallel ladder (kernels 3 and 13): each row
// of the batch is 2 S neighbouring lanes of a warp, split_lanes<S>::rows =
// 16 / S rows a warp (8, 4, 2 at S = 2, 4, 8). [s]B + [k]A' (the reference's
// double_scalar_mul_split) is a sum of 2 S chunk products, each a Horner
// chain of per = 64/S nibbles over one 16-entry table:
//   lane c < S (comb lane):   [s's chunk c] (16^(per c) B), table row per c
//                             of the fixed-base comb (the rows the shared
//                             ladder read at the chunk boundaries);
//   lane S + c (power lane):  [k's chunk c] (2^(256 c / S) A'), table c of
//                             the cache entry (-A's power tables).
// Every lane runs the same code: load its top window's entry, then per - 1
// steps of 4 doublings and one addition (T on the last), then a
// __shfl_xor_sync tree over the row's 2 S lanes sums the partials in
// log2(2 S) additions, so every lane of the row ends with the row's point.
// The comb lanes could sum per comb rows with additions alone; in lock
// step with the power lanes their doublings take no extra issue slot, and
// one code path keeps the warp converged and one point live a lane.
template <int S>
struct split_lanes {
  static constexpr int per = 64 / S;
  static constexpr int lanes = 2 * S;        // lanes a row
  static constexpr int rows = 32 / lanes;    // rows a warp
  // ladder warps a block at most: the block's decode warp decodes R for
  // every row, one lane a row, and 8 warps of 255 registers fill an SM
  static constexpr int max_warps = 32 / rows < 7 ? 32 / rows : 7;
  static constexpr int max_rows = max_warps * rows;  // rows a block at most
};

// The ladder warps a block of a split hit kernel takes for n rows: the
// fewest waves of blocks on this card (blocks resident an SM from the
// occupancy calculator, so the kernel's registers decide), and among those
// the fewest warps a block, which spreads the rows over the most SMs. Up to
// one wave of 2-warp blocks (~2,100 rows at S = 4 on an H100) that is one
// ladder warp; past it more ladder warps share a decode warp, whose idle
// lanes would otherwise hold half the register file.
template <int S, typename Kernel>
static cudaError_t split_hit_warps(Kernel kernel, int n, int *warps) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long best = -1;
  *warps = 1;
  for (int w = 1; e == cudaSuccess && w <= split_lanes<S>::max_warps; w++) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * (w + 1), 0);
    if (e != cudaSuccess || per_sm == 0) continue;
    const long resident = (long)per_sm * sms;
    const long waves = (grid_for(n, w * split_lanes<S>::rows) + resident - 1) / resident;
    if (best < 0 || waves < best) {
      best = waves;
      *warps = w;
    }
  }
  return e;
}

// All 40 limbs of a point from lane (this lane ^ off) of the row.
template <int S>
__device__ __forceinline__ void ge_shfl_xor(ge &out, const ge &p, int off) {
  const fe *src[4] = {&p.X, &p.Y, &p.Z, &p.T};
  fe *dst[4] = {&out.X, &out.Y, &out.Z, &out.T};
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int l = 0; l < 10; l++)
      dst[k]->v[l] = __shfl_xor_sync(0xffffffffu, src[k]->v[l], off, split_lanes<S>::lanes);
}

// [s]B + [k]A' for the row of lane `lane` (0 .. 2 S - 1 within the row):
// a_tab is the row's cache entry (S x 16 entries of 128 int16 limbs),
// fixed_table the (64, 16, 4, 32) int32 comb. Every lane of the row must
// call it (the tree shuffles across the row); q carries no T.
template <int S>
__device__ __forceinline__ void ge_split_lanes(ge &q, int lane, const int16_t *a_tab,
                                               const int32_t *fixed_table, const uint8_t *s,
                                               const uint8_t *k) {
  constexpr int per = split_lanes<S>::per;
  const bool power = lane >= S;
  const int c = power ? lane - S : lane;
  const uint8_t *scalar = power ? k : s;
  const int16_t *a_row = a_tab + (size_t)c * 16 * 128;
  const int32_t *comb_row = fixed_table + (size_t)per * c * 16 * 128;
  // the two kinds of lane diverge only here, on the table's limb type (one
  // load reading both tables through an int16 stride crashed the device
  // compiler)
  if (power)
    ge_from_limbs8(q, a_row + nibble(scalar, per * c + per - 1) * 128);
  else
    ge_from_limbs8(q, comb_row + nibble(scalar, per * c + per - 1) * 128);
  ge e;
#pragma unroll 1
  for (int w = per - 2; w >= 0; w--) {
    if (power)
      ge_from_limbs8(e, a_row + nibble(scalar, per * c + w) * 128);
    else
      ge_from_limbs8(e, comb_row + nibble(scalar, per * c + w) * 128);
    ge_dbl(q, q, false);
    ge_dbl(q, q, false);
    ge_dbl(q, q, false);
    ge_dbl(q, q, true);
    // the partials enter the tree's additions, which read T
    ge_add(q, q, e, w == 0);
  }
#pragma unroll
  for (int off = 1; off < split_lanes<S>::lanes; off <<= 1) {
    ge_shfl_xor<S>(e, q, off);
    ge_add(q, q, e, off < S);  // the last sum feeds no addition
  }
}

// The cache geometries of the reference (TM_TPU_PK_SPLIT).
__host__ __device__ __forceinline__ bool valid_splits(int splits) {
  return splits == 1 || splits == 2 || splits == 4 || splits == 8;
}

// The cache entry a slot reads, as the reference's `tables[slots]` under
// jnp indexing maps it: a negative slot counts from the end (slot + C),
// then the index clamps into [0, C - 1], so -5 reads C - 5, -C - 1 and
// INT32_MIN read 0, C and INT32_MAX read C - 1. raw + C is formed only
// for -C <= raw < 0, so nothing overflows.
__device__ __forceinline__ int cache_slot(int raw, int capacity) {
  if (raw < 0) return raw < -capacity ? 0 : raw + capacity;
  return raw < capacity ? raw : capacity - 1;
}
