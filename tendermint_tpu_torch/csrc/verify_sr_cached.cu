// sr25519 cache-hit bitmap on the split ladder: R == encode([s]B - [k]A)
// with -A's power tables read from the device-resident sr25519 pubkey
// cache by slot, at S = `splits` chunks (2, 4 or 8).
//
// Replaces the JAX program `verify_sr_kernel_cached_split`
// (tendermint_tpu/ops/verify_sr.py:112, body
// verify_sr_kernel_cached_split_impl at :92).
//
// Bound on this card: integer multiplies. The least work for the function
// is the shared ladder's 64/S steps of 4 doublings and 2 S additions and
// one ristretto encode (255 squarings, 21 products): at S = 4 about 1,900
// field multiplications, each at least 64 32-bit multiplies (36 for a
// square), the count the bound in chip_smoke.py uses; this design issues
// 100 wide multiplies per product and per square. It reads 96 bytes of
// input, and 64 table entries of 256 bytes (16 KiB) from the cache, out of
// an entry of 4 S KiB.
//
// Design: verify_cached.cu's. A row is 2 S lanes of a warp running
// ladder.cuh's ge_split_lanes<S>; the block's last warp decodes R, one
// lane a row, beside the ladder warps (1 at 1,024 rows, up to 7 past one
// wave, split_hit_warps); lane 0 of each row decides. The
// decision is decode(R) ok and ristretto_equal(decode(R), Q) (RFC 9496
// section 4.5, 4 products) in place of the reference's encode(Q) == R
// bytes, which took a ~276-product encode onto the end of the row's chain.
// The two compute the same function when A decoded (oks[slot]; otherwise
// both are false): A and B lie in 2E, so Q = [s]B - [k]A does too, and
// (1) encode maps every point of 2E to a canonical encoding that decodes
// to a point equal to it; (2) decode accepts only canonical encodings, and
// encode(decode(R)) = R for each of them; (3) encode is constant on each
// element (equal representatives encode alike). So encode(Q) = R implies R
// decodes, to P equal to Q by (1); and R decoding to P equal to Q implies
// encode(Q) = encode(P) = R by (3) and (2). tests/test_torch_split_lanes.py
// holds the two forms equal on RFC 9496's bad encodings, non-canonical
// ones, -Q, the identity and random bytes.
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

template <int S>
__global__ void __launch_bounds__(32 * (split_lanes<S>::max_warps + 1))
    verify_sr_cached_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
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
      r_oks[lane] = ristretto_decode(r_pts[lane], r_enc + 32 * min(row0 + lane, n - 1));
  } else {
    ge_split_lanes<S>(q, lane % lanes, tables + (size_t)slot * S * 16 * 128, fixed_table,
                      s_bytes + 32 * i, k_bytes + 32 * i);
  }
  __syncthreads();
  if (warp < ladder_warps && lane % lanes == 0 && row0 + j < n)
    out[i] = (oks[slot] && r_oks[j] && ristretto_equal(r_pts[j], q)) ? 1 : 0;
}

template <int S>
static int launch_rows(const void *tables, const void *oks, const void *slots, const void *r_enc,
                       const void *s_bytes, const void *k_bytes, const void *fixed_table,
                       void *out, int n, int capacity, cudaStream_t st) {
  int warps;
  const cudaError_t e = split_hit_warps<S>(verify_sr_cached_rows<S>, n, &warps);
  if (e != cudaSuccess) return (int)e;
  verify_sr_cached_rows<S><<<grid_for(n, warps * split_lanes<S>::rows), 32 * (warps + 1), 0, st>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)fixed_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}

extern "C" int tm_verify_sr_cached_split(const void *tables, const void *oks, const void *slots,
                                         const void *r_enc, const void *s_bytes,
                                         const void *k_bytes, const void *fixed_table, void *out,
                                         int n, int capacity, int splits, void *stream) {
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
