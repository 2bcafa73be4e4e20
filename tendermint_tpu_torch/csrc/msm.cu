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
// multiplies per product and per square. What holds it back is latency,
// not the multiplier count: a point addition is a chain of dependent
// products, and a batch-independent tail must run Horner over 64 windows
// (252 doublings and 63 additions in a row) before the verdict.
//
// Design: msm.cuh's four launches, shared with the sr25519 check, with
// ZIP-215 decoding and the cofactored identity test. The windows step
// spreads 96 columns x 128 streams x K chunks over the card and overlaps
// its scattered 160-byte table reads with the additions (cp.async into
// shared memory); a reduce over many blocks turns the partials into 64
// window sums; the tail's Horner runs each point operation on four
// cooperating lanes (about 11 dependent products a window instead of 37,
// about 700 on the critical path instead of about 3,000), while another
// warp sums the fixed-base comb.
#include "msm.cuh"

extern "C" int tm_msm_verify(const void *a_enc, const void *r_enc, const void *zk_bytes,
                             const void *z_bytes, const void *zs_bytes, const void *fixed_table,
                             void *tabs, void *oks, void *part, void *ws, void *out, int n, int g,
                             int chunks, void *stream) {
  return msm_launch<false>(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes, fixed_table, tabs, oks,
                           part, ws, out, n, g, chunks, stream);
}
