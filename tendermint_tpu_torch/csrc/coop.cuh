// Four cooperating lanes a point. A quad is four neighbouring lanes of a
// warp (lanes 4m .. 4m + 3); lane q = lane & 3 of the quad holds coordinate
// q of an extended point (X, Y, Z, T) as one ten-limb field element, so a
// point operation spreads over the quad: dbl-2008-hwcd in two rounds (four
// squarings, then four products) and add-2008-hwcd-3 in three (four
// products, the 2d product, four products), each lane one product a round,
// limbs exchanged by __shfl_sync of width 4. Every quad of a warp may run
// them at once (the default mask is the whole warp, and then every lane of
// the warp must call them together); the RLC tail, where lanes 0-3 alone
// run, passes mask 0xF. The values equal ge_dbl's and ge_add's coordinate
// for coordinate modulo p, T included.
//
// Users: the RLC tail (msm.cuh), the quad ladder (coop_straus_with) of the
// uncached bitmaps (coop_straus_base: verify.cu, verify_sr.cu) and of the
// single-table cache hits (coop_load_cached: verify_cached_single.cu,
// verify_sr_cached_single.cu), and every fill (coop_fill: the split fills
// pk_tables.cu, sr_tables.cu and the single-table fills
// pk_tables_single.cu, sr_tables_single.cu, whose decoders split each
// product across the quad, coop_decode.cuh).
#pragma once
#include <cuda_runtime.h>

#include "ge25519.cuh"
#include "ladder.cuh"

constexpr unsigned QUAD_ALL = 0xffffffffu;

// One point as a contiguous row of 40 int32 (X, Y, Z, T, ten limbs each),
// moved as ten 16-byte words; the row must be 16-byte aligned.
__device__ __forceinline__ void ge_store_row(int32_t *dst, const ge &p) {
  const fe *c[4] = {&p.X, &p.Y, &p.Z, &p.T};
  int4 *d = reinterpret_cast<int4 *>(dst);
#pragma unroll
  for (int j = 0; j < 10; j++)
    d[j] = make_int4(c[(4 * j) / 10]->v[(4 * j) % 10], c[(4 * j + 1) / 10]->v[(4 * j + 1) % 10],
                     c[(4 * j + 2) / 10]->v[(4 * j + 2) % 10],
                     c[(4 * j + 3) / 10]->v[(4 * j + 3) % 10]);
}

// r = v of lane src of this lane's quad.
__device__ __forceinline__ void fe_shfl(fe &r, const fe &v, int src, unsigned mask = QUAD_ALL) {
#pragma unroll
  for (int l = 0; l < 10; l++) r.v[l] = __shfl_sync(mask, v.v[l], src, 4);
}

// r = the argument numbered q.
__device__ __forceinline__ void fe_pick(fe &r, int q, const fe &a0, const fe &a1, const fe &a2,
                                        const fe &a3) {
#pragma unroll
  for (int l = 0; l < 10; l++)
    r.v[l] = q == 0 ? a0.v[l] : q == 1 ? a1.v[l] : q == 2 ? a2.v[l] : a3.v[l];
}

// Coordinate `coord` of a point stored strided (ge_store's layout); a row
// (ge_store_row's) is stride 1.
__device__ __forceinline__ void fe_load_coord(fe &r, const int32_t *base, int coord, int stride) {
#pragma unroll
  for (int l = 0; l < 10; l++) r.v[l] = base[(coord * 10 + l) * stride];
}

// Coordinate `coord` of the point stored as a row at base.
__device__ __forceinline__ void fe_store_coord(int32_t *base, int coord, const fe &v) {
#pragma unroll
  for (int l = 0; l < 10; l++) base[coord * 10 + l] = v.v[l];
}

// mine = coordinate q of 2P, ge_dbl's formula (T included) in two rounds.
__device__ __forceinline__ void coop_dbl(fe &mine, int q, unsigned mask = QUAD_ALL) {
  fe x, y, u, s, a, b, c, d, e, f, g, h;
  fe_shfl(x, mine, 0, mask);
  fe_shfl(y, mine, 1, mask);
  fe_add(h, x, y);
  fe_pick(u, q, x, y, mine, h);
  fe_sq(s, u);  // X^2, Y^2, Z^2, (X+Y)^2
  fe_add(c, s, s);
  fe_carry(c, c);
  fe_pick(s, q, s, s, c, s);  // lane 2: C = 2 Z^2, carried
  fe_shfl(a, s, 0, mask);
  fe_shfl(b, s, 1, mask);
  fe_shfl(c, s, 2, mask);
  fe_shfl(d, s, 3, mask);
  fe_sub(e, d, a);
  fe_sub(e, e, b);
  fe_sub(g, b, a);
  fe_sub(f, g, c);
  fe_add(h, a, b);
  fe_neg(h, h);
  fe_pick(u, q, e, g, f, e);
  fe_pick(x, q, f, h, g, h);
  fe_mul(mine, u, x);  // X3 = EF, Y3 = GH, Z3 = FG, T3 = EH
}

// mine = coordinate q of P + Q, ge_add's formula in three rounds, given
// Q's X and Y and this lane's w = Q's T on lane 2, Q's Z on the others.
__device__ __forceinline__ void coop_add_xyw(fe &mine, int q, const fe &qx, const fe &qy,
                                             const fe &qw, unsigned mask) {
  fe partner, f1, f2, r, a, b, c, d, e, f, g, h;
  fe_shfl(partner, mine, q ^ 1, mask);  // lanes 0/1 swap X, Y; lanes 2/3 swap Z, T
  fe_sub(a, partner, mine);             // lane 0: Y1 - X1
  fe_add(b, mine, partner);             // lane 1: Y1 + X1
  fe_pick(f1, q, a, b, partner, partner);
  fe_sub(a, qy, qx);
  fe_add(b, qy, qx);
  fe_pick(f2, q, a, b, qw, qw);
  fe_mul(r, f1, f2);  // A, B, T1 T2, Z1 Z2
  if (q == 2) fe_mul_c(r, r, FE_D2);
  fe_add(d, r, r);
  fe_pick(r, q, r, r, r, d);  // C = 2d T1 T2, D = 2 Z1 Z2
  fe_shfl(a, r, 0, mask);
  fe_shfl(b, r, 1, mask);
  fe_shfl(c, r, 2, mask);
  fe_shfl(d, r, 3, mask);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_pick(f1, q, e, g, f, e);
  fe_pick(f2, q, f, h, g, h);
  fe_mul(mine, f1, f2);  // X3 = EF, Y3 = GH, Z3 = FG, T3 = EH
}

// mine = coordinate q of P + Q, Q a point with T stored at qp (strided, or
// a row at stride 1).
__device__ __forceinline__ void coop_add(fe &mine, const int32_t *qp, int stride, int q,
                                         unsigned mask = QUAD_ALL) {
  fe qx, qy, qw;
  fe_load_coord(qx, qp, 0, stride);
  fe_load_coord(qy, qp, 1, stride);
  fe_load_coord(qw, qp, q == 2 ? 3 : 2, stride);
  coop_add_xyw(mine, q, qx, qy, qw, mask);
}

// mine = coordinate q of P + Q, Q held by the quad as P is (lane q holds
// coordinate q of Q in `theirs`).
__device__ __forceinline__ void coop_add_reg(fe &mine, const fe &theirs, int q,
                                             unsigned mask = QUAD_ALL) {
  fe qx, qy, qw;
  fe_shfl(qx, theirs, 0, mask);
  fe_shfl(qy, theirs, 1, mask);
  fe_shfl(qw, theirs, q == 2 ? 3 : 2, mask);
  coop_add_xyw(mine, q, qx, qy, qw, mask);
}

// One lane's coordinate of a cache entry: canonical radix-2^8 bytes as 32
// int16 limbs at dst (64 bytes, 16-byte aligned), four 16-byte stores.
__device__ __forceinline__ void coop_write_coord(int16_t *dst, const fe &v) {
  uint8_t b[32];
  fe_tobytes(b, v);
  int4 *d = reinterpret_cast<int4 *>(dst);
#pragma unroll
  for (int j = 0; j < 4; j++)
    d[j] = make_int4(b[8 * j] | b[8 * j + 1] << 16, b[8 * j + 2] | b[8 * j + 3] << 16,
                     b[8 * j + 4] | b[8 * j + 5] << 16, b[8 * j + 6] | b[8 * j + 7] << 16);
}

// The cache entry of a decoded, negated key at `splits` chunks of c =
// 256/splits bits, written by its quad: lane q holds coordinate q of the
// key's point in p and writes coordinate q of every entry, so the quad
// writes each 256-byte entry as one contiguous run. The sequence is the
// reference's build_power_tables: per power c >= 1, c doublings (the last
// one's T is the one read), then entries 0, P, P + P and 13 more additions
// of P (at S = 1 the reference's _build_var_table); each entry equals the
// one-lane formulas' (ge_dbl, ge_add) coordinate for coordinate modulo p,
// so its canonical bytes are the same. Only a live quad writes; every quad
// of the warp must call it (the point operations shuffle across the warp).
__device__ __forceinline__ void coop_write_power_tables(int16_t *dst, fe p, int q, int splits,
                                                       bool live) {
  const int chunk_bits = 256 / splits;
  fe acc, id;
  if (q == 1 || q == 2)
    fe_one(id);
  else
    fe_zero(id);
#pragma unroll 1
  for (int c = 0; c < splits; c++) {
    if (c > 0) {
#pragma unroll 1
      for (int d = 0; d < chunk_bits; d++) coop_dbl(p, q);
    }
    int16_t *row = dst + (size_t)c * 16 * 128 + q * 32;
    fe_copy(acc, p);
    coop_add_reg(acc, p, q);
    if (live) {
      coop_write_coord(row, id);
      coop_write_coord(row + 128, p);
      coop_write_coord(row + 2 * 128, acc);
    }
#pragma unroll 1
    for (int j = 3; j < 16; j++) {
      coop_add_reg(acc, p, q);
      if (live) coop_write_coord(row + j * 128, acc);
    }
  }
}

// One key of a fill by its quad, the body of every fill: the split fills
// (pk_tables.cu with ZIP-215's ge_decompress, sr_tables.cu with
// ristretto_decode) and the single-table fills at splits = 1
// (pk_tables_single.cu, sr_tables_single.cu, with coop_decode.cuh's
// decoders), which differ only in `decode(p, enc)`. Quad m of the grid
// takes key m: its four lanes decode the key in lock step (the one-lane
// decoders run the same work on each lane; the quad-split ones share each
// product out, and every lane ends with the same point), lane q keeps
// coordinate q of -A (X and T negated) and coop_write_power_tables writes
// the key's cache entry. A quad past the end decodes the last key and
// writes nothing, so every lane of the warp reaches every shuffle.
// The fills' blocks: one warp, eight keys.
constexpr int COOP_FILL_THREADS = 32;

template <typename Decode>
__device__ __forceinline__ void coop_fill(Decode decode, const uint8_t *a_enc, int16_t *tables,
                                          uint8_t *oks, int n, int splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x, q = t & 3;
  const int key_raw = t / 4, key = min(key_raw, n - 1);
  const bool live = key_raw < n;
  ge p;
  const bool ok = decode(p, a_enc + 32 * key);
  if (live && q == 0) oks[key] = ok ? 1 : 0;
  fe mine;  // coordinate q of -A
  fe_pick(mine, q, p.X, p.Y, p.Z, p.T);
  if (q == 0 || q == 3) fe_neg(mine, mine);
  coop_write_power_tables(tables + (size_t)key * splits * 16 * 128, mine, q, splits, live);
}

// ints a base-table entry in shared memory: 40 and one of padding, so the
// 16 entries start on 16 distinct banks
constexpr int B_SLOT = 41;

// The base table (16, 4, 32) radix-2^8 limbs into the block's shared
// memory in ten-limb form, entry j at sh_b + j * B_SLOT; every thread of
// the block must call it.
__device__ __forceinline__ void coop_base_to_shared(int32_t *sh_b, const int32_t *base_table) {
  for (int c = threadIdx.x; c < 64; c += blockDim.x) {
    fe v;
    fe_from_limbs8(v, base_table + 32 * c);
#pragma unroll
    for (int l = 0; l < 10; l++) sh_b[(c >> 2) * B_SLOT + (c & 3) * 10 + l] = v.v[l];
  }
  __syncthreads();
}

// -A's multiples 0, 2, ..., 15 of one row by its quad, beside entry 1
// (-A) in a_tab, the row's 16 rows of 40 int32: 14 register additions, 42
// rounds, each lane writing its coordinate, then __syncwarp so that every
// lane may read the others' coordinates.
__device__ __forceinline__ void coop_build_a_table(int32_t *a_tab, int q) {
  fe a, mine;
  fe_load_coord(a, a_tab + 40, q, 1);
  if (q == 1 || q == 2)
    fe_one(mine);
  else
    fe_zero(mine);
  fe_store_coord(a_tab, q, mine);
  fe_copy(mine, a);
#pragma unroll 1
  for (int j = 2; j < 16; j++) {
    coop_add_reg(mine, a, q);
    fe_store_coord(a_tab + j * 40, q, mine);
  }
  __syncwarp();
}

// mine = coordinate q of [s]B + [k]A' for one row by its quad: 63 Straus
// windows of 4 doublings and 2 additions from the top (the reference's
// double_scalar_mul_base), B's entry from sh_b (coop_base_to_shared), then
// A''s, which load_a(x, y, w, j) loads: lane q's copy of X and Y of A''s
// multiple j and its w (T on lane 2, Z on the others), as coop_add reads
// a point. The result carries T. Every lane of the warp must call it.
template <typename LoadA>
__device__ __forceinline__ void coop_straus_with(fe &mine, int q, const int32_t *sh_b,
                                                 LoadA load_a, const uint8_t *s,
                                                 const uint8_t *k) {
  fe x, y, w;
  // window 63 has no leading doublings
  fe_load_coord(mine, sh_b + nibble(s, 63) * B_SLOT, q, 1);
  load_a(x, y, w, nibble(k, 63));
  coop_add_xyw(mine, q, x, y, w, QUAD_ALL);
#pragma unroll 1
  for (int win = 62; win >= 0; win--) {
#pragma unroll 1
    for (int i = 0; i < 4; i++) coop_dbl(mine, q);
    coop_add(mine, sh_b + nibble(s, win) * B_SLOT, 1, q);
    load_a(x, y, w, nibble(k, win));
    coop_add_xyw(mine, q, x, y, w, QUAD_ALL);
  }
}

// The ladder of both uncached bitmaps (verify.cu, verify_sr.cu): a_tab is
// the row's 16 rows of 40 int32 with A' stored as entry 1; the quad builds
// the other entries (coop_build_a_table), then runs the windows reading
// them back. A quad past the end of the batch must run a live row's values
// (the last row's) so that it writes that row's table with the same values.
__device__ __forceinline__ void coop_straus_base(fe &mine, int q, const int32_t *sh_b,
                                                 int32_t *a_tab, const uint8_t *s,
                                                 const uint8_t *k) {
  coop_build_a_table(a_tab, q);
  const int32_t *tab = a_tab;
  coop_straus_with(
      mine, q, sh_b,
      [tab, q](fe &x, fe &y, fe &w, int j) {
        fe_load_coord(x, tab + j * 40, 0, 1);
        fe_load_coord(y, tab + j * 40, 1, 1);
        fe_load_coord(w, tab + j * 40, q == 2 ? 3 : 2, 1);
      },
      s, k);
}

// The single-table cache hits' loader (verify_cached_single.cu,
// verify_sr_cached_single.cu): lane q's X, Y and w of multiple j of A',
// read from the row's cache entry, (16, 4, 32) int16 radix-2^8 limbs,
// modulo p (canonical bytes from the port's fill, signed limbs |l| < 2^9
// from a JAX cache carried across by cache_from_reference).
__device__ __forceinline__ void coop_load_cached(fe &x, fe &y, fe &w, const int16_t *entry, int j,
                                                 int q) {
  const int16_t *e = entry + j * 128;
  fe_from_limbs8(x, e);
  fe_from_limbs8(y, e + 32);
  fe_from_limbs8(w, e + (q == 2 ? 96 : 64));
}

// Lane 0's verdict of an ed25519 hit on its row's point Q (coordinate q in
// mine) and -R stored as a row: [8](Q - R) is the identity, X = 0 and Y =
// Z, as verify.cu's ladder tests it (an addition and 3 doublings, every
// lane of the warp calling).
__device__ __forceinline__ bool coop_cofactored_identity(fe &mine, int q, const int32_t *neg_r) {
  coop_add(mine, neg_r, 1, q);
#pragma unroll 1
  for (int i = 0; i < 3; i++) coop_dbl(mine, q);
  fe y, z;
  fe_shfl(y, mine, 1);
  fe_shfl(z, mine, 2);
  fe_sub(y, y, z);
  return fe_iszero(mine) && fe_iszero(y);
}

// The single-table cache hits' blocks: W ladder warps of HIT1_ROWS rows, a
// quad a row, and one decode warp, a lane a row, so W <= HIT1_MAX_WARPS.
// Each of an SM's four schedulers issues for the warps it holds, and a
// quad's chain keeps one warp's pace only while no other ladder warp
// shares its scheduler. So hit1_warps takes W = 3 (the block's four warps
// on the four schedulers) while the card has an SM for every block, then
// W = 4 (a ladder warp on each scheduler, and beside one of them the
// decode warp, which finishes early). The launch bound of HIT1_MIN_BLOCKS
// blocks an SM holds a thread to 128 registers, so that past one block an
// SM more blocks stay resident; the decode spills, hidden behind the
// ladder.
constexpr int HIT1_ROWS = 8;
constexpr int HIT1_MAX_WARPS = 4;
constexpr int HIT1_MIN_BLOCKS = 3;

static cudaError_t hit1_warps(int n, int *warps) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *warps = grid_for(n, 3 * HIT1_ROWS) <= sms ? 3 : HIT1_MAX_WARPS;
  return e;
}

// One block of a single-table cache hit, the body of both planes' kernels
// (verify_cached_single.cu, verify_sr_cached_single.cu), which differ in
// `decode(p, enc)`, R's decoder (the point each row's decision reads and
// its decode bit), and `decide(mine, q, r_row)`, lane 0's verdict on the
// row's point and R's stored row (every lane of a ladder warp calls it).
// The decode warp decodes R for the block's rows into shared memory while
// each ladder quad maps its slot (cache_slot, the reference's gather) and
// runs the 63 windows on its cache entry (coop_straus_with with
// coop_load_cached); after __syncthreads lane 0 of each quad writes
// oks[slot] && R's bit && decide. A quad past the end runs the last row
// and writes nothing, so every lane of a ladder warp reaches every shuffle.
template <typename Decode, typename Decide>
__device__ __forceinline__ void coop_cached_hit(Decode decode, Decide decide,
                                                const int16_t *tables, const uint8_t *oks,
                                                const int32_t *slots, const uint8_t *r_enc,
                                                const uint8_t *s_bytes, const uint8_t *k_bytes,
                                                const int32_t *base_table, uint8_t *out, int n,
                                                int capacity) {
  __shared__ int32_t sh_b[16 * B_SLOT];
  __shared__ __align__(16) int32_t r_rows[HIT1_MAX_WARPS * HIT1_ROWS * 40];
  __shared__ bool r_oks[HIT1_MAX_WARPS * HIT1_ROWS];
  coop_base_to_shared(sh_b, base_table);
  const int ladder_warps = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, q = lane & 3;
  const int row0 = blockIdx.x * ladder_warps * HIT1_ROWS;
  const int j = warp * HIT1_ROWS + lane / 4;  // the quad's row in the block
  const int i = min(row0 + j, n - 1);
  fe mine;
  int slot = 0;
  if (warp == ladder_warps) {
    if (lane < ladder_warps * HIT1_ROWS) {
      ge p;
      r_oks[lane] = decode(p, r_enc + 32 * min(row0 + lane, n - 1));
      ge_store_row(r_rows + lane * 40, p);
    }
  } else {
    slot = cache_slot(slots[i], capacity);
    const int16_t *entry = tables + (size_t)slot * 16 * 128;
    coop_straus_with(
        mine, q, sh_b,
        [entry, q](fe &x, fe &y, fe &w, int e) { coop_load_cached(x, y, w, entry, e, q); },
        s_bytes + 32 * i, k_bytes + 32 * i);
  }
  __syncthreads();
  if (warp == ladder_warps) return;
  const bool ok = decide(mine, q, r_rows + j * 40);
  if (q == 0 && row0 + j < n) out[i] = (oks[slot] && r_oks[j] && ok) ? 1 : 0;
}
