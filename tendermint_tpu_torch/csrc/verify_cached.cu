// Cache-hit bitmap on the split ladder: [8]([s]B - [k]A) == [8]R with -A's
// power tables read from the device-resident pubkey cache by slot, at
// S = `splits` chunks (2, 4 or 8).
//
// Replaces the JAX program `verify_kernel_cached_split`
// (tendermint_tpu/ops/verify.py:157, body verify_kernel_cached_split_impl
// at :144).
//
// Bound on this card: integer multiplies. A row decodes R (about 265 field
// multiplications), runs 64/S steps of 4 doublings and 2 S additions and
// the 6 cofactor doublings: at S = 4 about 1,900 field multiplications
// (2,450 at S = 2, 1,700 at S = 8), each at least 64 32-bit multiplies (36
// for a square), the count the bound in chip_smoke.py uses; this design
// issues 100 wide multiplies per product and per square. It reads 96
// bytes of input, and 64 table entries of 256 bytes (16 KiB) from the
// cache, out of an entry of 4 S KiB.
//
// Design: one thread per signature, one instantiation per S (the ladder's
// chunk count is a template parameter). Cache entries are int16 radix-2^8
// limbs (canonical from the port's fill kernel, or the reference's
// signed limbs carried across by cache_from_reference) and are converted
// to the ten-limb field as they are read; [s]B rides the rows of the
// fixed-base comb at the chunk boundaries, read by direct index (the
// ladder is ladder.cuh's, shared with the sr25519 kernel).
#include <cuda_runtime.h>

#include "ladder.cuh"

template <int S>
__global__ void verify_cached_rows(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                                   const uint8_t *r_enc, const uint8_t *s_bytes,
                                   const uint8_t *k_bytes, const int32_t *fixed_table, uint8_t *out,
                                   int n, int capacity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t *s = s_bytes + 32 * i;
  const uint8_t *k = k_bytes + 32 * i;
  // an out-of-range slot clamps, as the reference's XLA gather does
  const int slot = min(max(slots[i], 0), capacity - 1);
  const int16_t *a_tab = tables + (size_t)slot * S * 16 * 128;
  ge r, q;
  const bool r_ok = ge_decompress(r, r_enc + 32 * i);
  ge_straus_split<S>(q, a_tab, fixed_table, s, k, false);
  out[i] = (oks[slot] && r_ok && ge_cofactored_equal(q, r)) ? 1 : 0;
}

template <int S>
static int launch_rows(const void *tables, const void *oks, const void *slots, const void *r_enc,
                       const void *s_bytes, const void *k_bytes, const void *fixed_table,
                       void *out, int n, int capacity, cudaStream_t st) {
  const int threads = 128;
  verify_cached_rows<S><<<grid_for(n, threads), threads, 0, st>>>(
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
