// Randomized-linear-combination check of a whole sr25519 batch:
//   encode(sum z_i k_i (-A_i) + sum z_i (-R_i) + [sum z_i s_i]B) == 0^32
// and every ristretto encoding decodes. Ristretto255 has prime order, so
// there is no cofactor to clear, and the identity is decided by its
// encoding.
//
// Replaces the JAX program `msm_verify_sr_kernel`
// (tendermint_tpu/ops/msm.py:272, body msm_verify_sr_kernel_impl at :244,
// accumulation _accumulate_windows at :86).
//
// Bound on this card: integer multiplies. Per row: two ristretto decodes
// (256 squarings and 18 products each), two 16-multiples tables (14
// additions each, 9M) and 96 window additions (9M): about 1,650 field
// multiplications, each at least 64 32-bit multiplies (36 for a square),
// the count the bound in chip_smoke.py uses; this design issues 100 wide
// multiplies per product and per square. What holds it back is latency:
// dependent products in each addition, and a batch-independent tail of
// Horner over 64 windows and one ristretto encode (255 squarings in a
// row).
//
// Design: msm.cuh's four launches, shared with the ed25519 check, with
// ristretto decoding in the tables step and the encoding test in the tail.
// The windows step fills the card (96 columns x 128 streams x K chunks,
// table reads overlapped by cp.async), a reduce over many blocks gives the
// 64 window sums, and the tail runs Horner on four cooperating lanes while
// another warp sums the comb; the encode stays on one lane (its inversion
// chain is serial).
#include "msm.cuh"

extern "C" int tm_msm_verify_sr(const void *a_enc, const void *r_enc, const void *zk_bytes,
                                const void *z_bytes, const void *zs_bytes, const void *fixed_table,
                                void *tabs, void *oks, void *part, void *ws, void *out, int n, int g,
                                int chunks, void *stream) {
  return msm_launch<true>(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes, fixed_table, tabs, oks, part,
                          ws, out, n, g, chunks, stream);
}
