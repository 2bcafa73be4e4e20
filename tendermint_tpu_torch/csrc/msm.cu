// Randomized-linear-combination check of a whole ed25519 batch:
//   [8](sum z_i h_i (-A_i) + sum z_i (-R_i) + [sum z_i s_i]B) == identity
// and every encoding decodes.
//
// Replaces the JAX program `msm_verify_kernel` (tendermint_tpu/ops/msm.py:162,
// body msm_verify_kernel_impl at :132, accumulation _accumulate_windows at
// :86).
//
// Bound on this card: integer multiplies. Per row: two decodes (about 265
// field multiplications each), two 16-multiples tables (14 additions
// each, 9M) and 96 window additions (9M): about 1,650 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. The tail (Horner over 64
// windows per stream, the stream tree, the fixed-base comb and the
// cofactor) is a fixed cost of about 330,000 field multiplications
// for G = 128 streams, shared by the whole batch.
//
// Design: msm.cuh's three launches (tables, window accumulation, tail),
// shared with the sr25519 check, with ZIP-215 decoding and the cofactored
// identity test.
#include "msm.cuh"

extern "C" int tm_msm_verify(const void *a_enc, const void *r_enc, const void *zk_bytes,
                             const void *z_bytes, const void *zs_bytes, const void *fixed_table,
                             void *tabs, void *oks, void *wsum, void *out, int n, int g,
                             void *stream) {
  return msm_launch<false>(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes, fixed_table, tabs, oks,
                           wsum, out, n, g, stream);
}
