// Randomized-linear-combination check of a whole ed25519 batch through the
// split pubkey cache (TM_TPU_MSM_CACHE=on, S = 2, 4 or 8):
//   [8](sum z_i h_i (-A_i) + sum z_i (-R_i) + [sum z_i s_i]B) == identity,
// every R decodes and every key's cache entry decoded.
//
// Replaces the JAX program `msm_verify_kernel_cached`
// (tendermint_tpu/ops/msm.py:241, body msm_verify_kernel_cached_impl at
// :165).
//
// Bound on this card: integer multiplies. Per row: one decode (about 265
// field multiplications), one 16-multiples table (14 additions, 9M) and 96
// window additions (9M): 32 of R's and 64 of A's whatever S, since A's
// 64 nibbles ride S cache rows of 64/S windows each; about 1,260 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. The reduce and tail are the
// uncached RLC's with max(32, 64/S) = 32 windows: Horner depth halves. It
// reads up to 4 S KiB of cache entry per distinct key besides 84 bytes of
// input per row.
//
// Design: msm.cuh's four launches on the caller's stream. The tables step
// decodes R alone (n threads, not 2n) and folds each key's cache ok bit
// into the row's; the windows step's (window, stream) threads read A's
// multiples straight from the int16 cache entries (limbs read modulo p);
// msm.cuh's reduce sums each window over the streams and its tail runs
// Horner over the 32 window sums on four cooperating lanes and keeps the
// cofactored identity test. It computes what the JAX program computes, not
// in its order of additions: the verdict is a group identity test, so the
// order is free.
#include "msm.cuh"

extern "C" int tm_msm_verify_cached(const void *tables, const void *cache_oks, const void *slots,
                                    const void *r_enc, const void *zk_bytes, const void *z_bytes,
                                    const void *zs_bytes, const void *fixed_table, void *tabs,
                                    void *oks, void *wsum, void *ws, void *out, int n, int g,
                                    int capacity, int splits, void *stream) {
  return msm_cached_launch(tables, cache_oks, slots, r_enc, zk_bytes, z_bytes, zs_bytes,
                           fixed_table, tabs, oks, wsum, ws, out, n, g, capacity, splits, stream);
}
