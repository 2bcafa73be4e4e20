// The randomized-linear-combination check shared by both signature planes
// (msm.cu for ed25519, msm_sr.cu for sr25519): four launches from one entry
// point, on the caller's stream.
//   1. tables: one thread per point of -A | -R; decodes it (ZIP-215, or
//      ristretto when SR) and writes its 16 multiples and its decode bit
//      to scratch, each multiple one contiguous 160-byte row.
//   2. windows: 96 columns, 64 A windows (nibble w of z*h) and 32 R windows
//      (nibble w of z), each making one addition a row, so no thread does
//      more work than another. A column's rows are split into G streams
//      (rows g, g + G, g + 2G, ...) and each stream into K chunks of
//      consecutive rounds; the wrapper picks K from the batch and the SM
//      count (ops/msm.py _window_chunks) so the grid fills the card several
//      times over and a thread walks a few tens of rows at most. A thread
//      copies the next row's entry into its shared-memory slot with cp.async
//      while it adds the current one, so the scattered table reads overlap
//      the arithmetic; each block then sums the K chunks of its streams as a
//      tree in shared memory and writes one partial sum a (column, stream).
//   3. reduce: one block a window; its threads sum the window's A and R
//      partials of every stream, then a tree in shared memory gives the 64
//      window sums.
//   4. tail: one block. Lanes 0-3 of warp 0 run Horner over the window sums
//      (4 doublings and one addition a window, from the top), each point
//      operation spread over the four lanes, lane i holding coordinate i
//      (X, Y, Z, T): dbl-2008-hwcd in two rounds (4 squarings, then 4
//      products), add-2008-hwcd-3 in three (4 products, the 2d product,
//      4 products), limbs exchanged by __shfl_sync (coop.cuh, mask 0xF:
//      the rest of warp 0 waits). Warp 1 meanwhile sums
//      the 64 comb entries of [zs]B as a tree across its lanes, and the
//      other warps AND the decode bits of every row, padding rows included.
//      At the join the four lanes add [zs]B and decide: ed25519 clears the
//      cofactor (3 doublings) and tests the projective identity; sr25519
//      (prime order, no cofactor) tests that the ristretto encoding of the
//      sum is 32 zero bytes, since projective equality would miss the
//      identity coset's other representatives. The encode runs on lane 0
//      alone: it is one inversion chain of 255 squarings, serial whatever
//      the lanes.
// Registers (ptxas, sm_90a): the windows, reduce and ed25519 tail launches
// spill nothing. Two spill, and why: the tables step (the first design's
// per-row decode and table build, only its output layout changed) keeps
// a decode's saved powers and a point addition's temporaries live at
// once, past 255 registers; the sr25519 tail's ristretto encode on lane 0
// does the same with the inversion chain's saved powers. They spill about
// 100 and 50 bytes once per thread, off the windows step's inner loop.
// Every addition is add-2008-hwcd-3, complete on ed25519, so partial sums
// that coincide or are the identity need no branch; padding rows carry zero
// scalars and select entry 0, the identity. The sum is taken in another
// order than the plain version's (ops/msm.py _accumulate_windows); the
// verdict, an identity or encoding test of the same group element, is the
// same.
//
// The cached ed25519 check (msm_cached.cu) reads -A from the split pubkey
// cache: its tables step runs for -R alone and folds each row's cache ok
// bit into R's decode bit; its windows step has one (window, stream) thread
// for each of W = max(32, 64/S) windows, adding R's entry for nibble w of z
// in every window and, for w < 64/S, the S cache-row entries for nibbles
// c * 64/S + w of z*h (row c holds -[2^(256c/S)]A's multiples); it shares
// the reduce and the tail, over W windows.
#pragma once
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ladder.cuh"
#include "ristretto.cuh"

// Windows step: 64 A columns and 32 R columns.
constexpr int MSM_COLS = 96;
constexpr int MSM_WIN_THREADS = 128;
// ints a shared-memory entry slot: the 160-byte row padded to 176 bytes, so
// the eight threads of a quarter warp reading 16 bytes each hit 32
// distinct banks.
constexpr int MSM_SLOT = 44;
constexpr int MSM_RED_THREADS = 64;
constexpr int MSM_TAIL_THREADS = 128;
constexpr int MSM_MAX_WINDOWS = 64;
// The tail's Horner quad: lanes 0-3 of warp 0, alone in their warp.
constexpr unsigned TAIL_QUAD = 0xFu;

// A point stored as a row (coop.cuh ge_store_row's layout).
__device__ __forceinline__ void ge_load_row(ge &p, const int32_t *src) {
  fe *c[4] = {&p.X, &p.Y, &p.Z, &p.T};
  const int4 *s = reinterpret_cast<const int4 *>(src);
#pragma unroll
  for (int j = 0; j < 10; j++) {
    const int4 v = s[j];
    c[(4 * j) / 10]->v[(4 * j) % 10] = v.x;
    c[(4 * j + 1) / 10]->v[(4 * j + 1) % 10] = v.y;
    c[(4 * j + 2) / 10]->v[(4 * j + 2) % 10] = v.z;
    c[(4 * j + 3) / 10]->v[(4 * j + 3) % 10] = v.w;
  }
}

// An asynchronous copy of one 160-byte row from device memory into a
// shared-memory slot (cp.async, 16 bytes at a time, no registers held).
__device__ __forceinline__ void fetch_row(int32_t *slot, const int32_t *row) {
#pragma unroll
  for (int j = 0; j < 10; j++) __pipeline_memcpy_async(slot + 4 * j, row + 4 * j, 16);
}

template <bool SR>
__global__ void msm_tables(const uint8_t *a_enc, const uint8_t *r_enc, int32_t *tabs, uint8_t *oks,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  ge p;
  const uint8_t *enc = i < n ? a_enc + 32 * i : r_enc + 32 * (i - n);
  bool ok;
  if constexpr (SR)
    ok = ristretto_decode(p, enc);
  else
    ok = ge_decompress(p, enc);
  oks[i] = ok ? 1 : 0;
  ge_neg(p, p);
  // multiples 0..15 by repeated addition, as the reference's _build_var_table
  int32_t *dst = tabs + (size_t)i * 16 * 40;
  ge acc;
  ge_identity(acc);
  ge_store_row(dst, acc);
  ge_store_row(dst + 40, p);
  ge_add(acc, p, p, true);
  ge_store_row(dst + 2 * 40, acc);
#pragma unroll 1
  for (int j = 3; j < 16; j++) {
    ge_add(acc, acc, p, true);
    ge_store_row(dst + j * 40, acc);
  }
}

// Grid (ceil(g * chunks / blockDim.x), MSM_COLS); thread tid of column
// blockIdx.y is chunk tid % chunks of stream tid / chunks, and blockDim.x is
// a multiple of chunks, so a stream's chunks share a block. Chunk k covers
// rounds [k * R / chunks, (k + 1) * R / chunks) of the R = n / g rounds,
// never empty since chunks <= R. The partial sum of (column c, stream s)
// goes to point c * g + s of part, strided by MSM_COLS * g.
__global__ void __launch_bounds__(MSM_WIN_THREADS, 2)
    msm_windows(const uint8_t *zk_bytes, const uint8_t *z_bytes, const int32_t *tabs,
                int32_t *part, int n, int g, int chunks) {
  __shared__ __align__(16) int32_t sh[2 * MSM_WIN_THREADS * MSM_SLOT];
  const int t = threadIdx.x, col = blockIdx.y;
  const int tid = blockIdx.x * blockDim.x + t;
  const int stream = tid / chunks, k = tid % chunks;
  const bool live = stream < g;
  const bool a_col = col < 64;
  const int w = a_col ? col : col - 64;
  const uint8_t *scalars = a_col ? zk_bytes : z_bytes;
  const int scalar_len = a_col ? 32 : 16;
  const int32_t *rows = tabs + (a_col ? 0 : (size_t)n * 16 * 40);
  ge acc, e;
  if (live) {
    const int rounds = n / g;
    const int lo = (int)((long long)k * rounds / chunks);
    const int hi = (int)((long long)(k + 1) * rounds / chunks);
    // slot b of this thread (b = 0, 1: the double buffer)
    auto slot = [&](int b) { return sh + (b * MSM_WIN_THREADS + t) * MSM_SLOT; };
    auto nib = [&](int r) {
      const int row = stream + g * r;
      return nibble(scalars + (size_t)scalar_len * row, w);
    };
    auto entry = [&](int r, int j) { return rows + ((size_t)(stream + g * r) * 16 + j) * 40; };
    fetch_row(slot(0), entry(lo, nib(lo)));
    __pipeline_commit();
    int nib_next = lo + 1 < hi ? nib(lo + 1) : 0;
#pragma unroll 1
    for (int r = lo; r < hi; r++) {
      if (r + 1 < hi) fetch_row(slot((r - lo + 1) & 1), entry(r + 1, nib_next));
      __pipeline_commit();
      if (r + 2 < hi) nib_next = nib(r + 2);  // read one iteration ahead of its use
      __pipeline_wait_prior(1);               // the copy of row r has landed
      ge_load_row(e, slot((r - lo) & 1));
      if (r == lo)
        acc = e;
      else
        ge_add(acc, acc, e, true);
    }
  }
  // the block's tree over each stream's chunks, in the prefetch slots
  __syncthreads();
  if (live) ge_store_row(sh + t * MSM_SLOT, acc);
#pragma unroll 1
  for (int half = chunks / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (live && k < half) {
      ge_load_row(e, sh + (t + half) * MSM_SLOT);
      ge_add(acc, acc, e, true);
      ge_store_row(sh + t * MSM_SLOT, acc);
    }
  }
  if (live && k == 0) ge_store(part + col * g + stream, 0, MSM_COLS * g, acc);
}

// One block a window w < wn: the partials of columns w, w + wn, ... (below
// cols) of every stream, summed by each thread over the streams t, t + 64,
// ..., then a tree in shared memory; the window sum goes to point w of ws,
// strided by wn.
__global__ void __launch_bounds__(MSM_RED_THREADS)
    msm_reduce(const int32_t *part, int32_t *ws, int g, int cols, int wn) {
  __shared__ int32_t sh[MSM_RED_THREADS * 40];  // points strided by MSM_RED_THREADS
  const int w = blockIdx.x, t = threadIdx.x;
  ge acc, e;
  ge_identity(acc);
#pragma unroll 1
  for (int c = w; c < cols; c += wn)
#pragma unroll 1
    for (int s = t; s < g; s += MSM_RED_THREADS) {
      ge_load(e, part + c * g + s, 0, cols * g);
      ge_add(acc, acc, e, true);
    }
  ge_store(sh + t, 0, MSM_RED_THREADS, acc);
#pragma unroll 1
  for (int half = MSM_RED_THREADS / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (t < half) {
      ge_load(e, sh + t + half, 0, MSM_RED_THREADS);
      ge_add(acc, acc, e, true);
      ge_store(sh + t, 0, MSM_RED_THREADS, acc);
    }
  }
  if (t == 0) ge_store(ws + w, 0, wn, acc);
}

// The tail over wn <= 64 window sums (ws, strided by wn); oks holds m
// decode bits. One block of MSM_TAIL_THREADS: warp 0 lanes 0-3 Horner,
// warp 1 the comb, the rest the decode bits.
template <bool SR>
__global__ void __launch_bounds__(MSM_TAIL_THREADS, 1)
    msm_tail(const int32_t *ws, const uint8_t *oks, const uint8_t *zs_bytes,
             const int32_t *fixed_table, uint8_t *out, int m, int wn) {
  __shared__ int32_t sh_w[MSM_MAX_WINDOWS * 40];  // the window sums, strided by wn
  __shared__ int32_t sh_b[40];                     // [zs]B
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, q = lane & 3;
  for (int i = t; i < 40 * wn; i += blockDim.x) sh_w[i] = ws[i];
  __syncthreads();
  bool ok = true;
  fe mine;
  if (warp == 0) {
    if (lane < 4) {
      fe_load_coord(mine, sh_w + wn - 1, q, wn);
#pragma unroll 1
      for (int w = wn - 2; w >= 0; w--) {
#pragma unroll 1
        for (int i = 0; i < 4; i++) coop_dbl(mine, q, TAIL_QUAD);
        coop_add(mine, sh_w + w, wn, q, TAIL_QUAD);
      }
    }
  } else if (warp == 1) {
    // [zs]B: entry nibble(zs, i) of comb row i for i < 64, two a lane, then
    // a tree across the lanes
    ge p, e;
    ge_from_limbs8(p, fixed_table + ((size_t)(2 * lane) * 16 + nibble(zs_bytes, 2 * lane)) * 128);
    ge_from_limbs8(e, fixed_table +
                          ((size_t)(2 * lane + 1) * 16 + nibble(zs_bytes, 2 * lane + 1)) * 128);
    ge_add(p, p, e, true);
#pragma unroll 1
    for (int off = 16; off >= 1; off /= 2) {
      fe *dst[4] = {&e.X, &e.Y, &e.Z, &e.T};
      const fe *src[4] = {&p.X, &p.Y, &p.Z, &p.T};
#pragma unroll
      for (int c = 0; c < 4; c++)
#pragma unroll
        for (int l = 0; l < 10; l++) dst[c]->v[l] = __shfl_down_sync(0xffffffffu, src[c]->v[l], off);
      ge_add(p, p, e, true);  // lanes >= off add a stale point; only lane 0's sum is kept
    }
    if (lane == 0) ge_store(sh_b, 0, 1, p);
  } else {
    // the decode bits (0 or 1 each), four a word where they fill one
    const int i0 = t - 64, nt = blockDim.x - 64;
    const uint32_t *words = reinterpret_cast<const uint32_t *>(oks);
    for (int i = i0; i < m / 4; i += nt) ok = ok && words[i] == 0x01010101u;
    for (int i = 4 * (m / 4) + i0; i < m; i += nt) ok = ok && oks[i] != 0;
  }
  ok = __syncthreads_and(ok);
  if (warp != 0 || lane >= 4) return;
  bool zero;
  coop_add(mine, sh_b, 1, q, TAIL_QUAD);
  if constexpr (SR) {
    ge s;  // lane 0 gathers the sum, T included: the encoder reads it
    fe_copy(s.X, mine);
    fe_shfl(s.Y, mine, 1, TAIL_QUAD);
    fe_shfl(s.Z, mine, 2, TAIL_QUAD);
    fe_shfl(s.T, mine, 3, TAIL_QUAD);
    if (lane != 0) return;
    uint8_t enc[32];
    ristretto_encode(enc, s);
    uint8_t any = 0;
#pragma unroll
    for (int i = 0; i < 32; i++) any |= enc[i];
    zero = any == 0;
  } else {
#pragma unroll 1
    for (int i = 0; i < 3; i++) coop_dbl(mine, q, TAIL_QUAD);
    ge s;  // lane 0 gathers X, Y, Z
    fe_copy(s.X, mine);
    fe_shfl(s.Y, mine, 1, TAIL_QUAD);
    fe_shfl(s.Z, mine, 2, TAIL_QUAD);
    if (lane != 0) return;
    zero = ge_is_identity(s);
  }
  out[0] = (ok && zero) ? 1 : 0;
}

// The reduce and the tail over the partial sums of cols columns of g
// streams (part, point c * g + s strided by cols * g), wn window sums into
// ws; oks holds m decode bits.
template <bool SR>
static int msm_tail_launch(const int32_t *part, int32_t *ws, const uint8_t *oks,
                           const void *zs_bytes, const void *fixed_table, void *out, int m, int g,
                           int cols, int wn, cudaStream_t st) {
  if (wn < 1 || wn > MSM_MAX_WINDOWS || cols < wn) return (int)cudaErrorInvalidValue;
  msm_reduce<<<wn, MSM_RED_THREADS, 0, st>>>(part, ws, g, cols, wn);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_tail<SR><<<1, MSM_TAIL_THREADS, 0, st>>>(ws, oks, (const uint8_t *)zs_bytes,
                                               (const int32_t *)fixed_table, (uint8_t *)out, m, wn);
  return (int)cudaGetLastError();
}

template <bool SR>
static int msm_launch(const void *a_enc, const void *r_enc, const void *zk_bytes,
                      const void *z_bytes, const void *zs_bytes, const void *fixed_table,
                      void *tabs, void *oks, void *part, void *ws, void *out, int n, int g,
                      int chunks, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (g < 1 || g > 1024 || n % g || chunks < 1 || chunks > MSM_WIN_THREADS ||
      (chunks & (chunks - 1)) || chunks > n / g)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  msm_tables<SR><<<grid_for(2 * n, threads), threads, 0, st>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, (int32_t *)tabs, (uint8_t *)oks, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int win_threads = g * chunks < MSM_WIN_THREADS ? g * chunks : MSM_WIN_THREADS;
  msm_windows<<<dim3(grid_for(g * chunks, win_threads), MSM_COLS), win_threads, 0, st>>>(
      (const uint8_t *)zk_bytes, (const uint8_t *)z_bytes, (const int32_t *)tabs, (int32_t *)part,
      n, g, chunks);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return msm_tail_launch<SR>((const int32_t *)part, (int32_t *)ws, (const uint8_t *)oks, zs_bytes,
                             fixed_table, out, 2 * n, g, MSM_COLS, 64, st);
}

// -- the cached ed25519 check -------------------------------------------------

// One thread per row: -R's 16 multiples into scratch, and the row's ok bit
// (R decodes and its key's cache entry decoded).
__global__ void msm_cached_tables(const uint8_t *r_enc, const int32_t *slots,
                                  const uint8_t *cache_oks, int capacity, int32_t *tabs,
                                  uint8_t *oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  const bool r_ok = ge_decompress(p, r_enc + 32 * i);
  // a slot wraps from the end, then clamps, as the reference's jnp gather does
  const int slot = cache_slot(slots[i], capacity);
  oks[i] = (r_ok && cache_oks[slot]) ? 1 : 0;
  ge_neg(p, p);
  ge_build_table(tabs + i, n, p);
}

__global__ void msm_cached_windows(const uint8_t *zk_bytes, const uint8_t *z_bytes,
                                   const int32_t *tabs, const int16_t *tables,
                                   const int32_t *slots, int capacity, int splits, int32_t *wsum,
                                   int n, int g, int wn) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= wn * g) return;
  const int w = idx / g, stream = idx % g, per = 64 / splits;
  ge acc, e;
  ge_identity(acc);
#pragma unroll 1
  for (int row = stream; row < n; row += g) {
    if (w < 32) {
      ge_load(e, tabs + row, nibble(z_bytes + 16 * row, w), n);
      ge_add(acc, acc, e, true);
    }
    if (w < per) {
      const int slot = cache_slot(slots[row], capacity);
      const int16_t *entry = tables + (size_t)slot * splits * 16 * 128;
      const uint8_t *zk = zk_bytes + 32 * row;
#pragma unroll 1
      for (int c = 0; c < splits; c++) {
        ge_from_limbs8(e, entry + ((size_t)c * 16 + nibble(zk, c * per + w)) * 128);
        ge_add(acc, acc, e, true);
      }
    }
  }
  ge_store(wsum + idx, 0, wn * g, acc);  // point (w, stream) at idx
}

static int msm_cached_launch(const void *tables, const void *cache_oks, const void *slots,
                             const void *r_enc, const void *zk_bytes, const void *z_bytes,
                             const void *zs_bytes, const void *fixed_table, void *tabs, void *oks,
                             void *wsum, void *ws, void *out, int n, int g, int capacity,
                             int splits, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (g < 1 || g > 1024 || n % g || splits < 2 || !valid_splits(splits))
    return (int)cudaErrorInvalidValue;
  const int wn = 64 / splits > 32 ? 64 / splits : 32;
  const int threads = 128;
  msm_cached_tables<<<grid_for(n, threads), threads, 0, st>>>(
      (const uint8_t *)r_enc, (const int32_t *)slots, (const uint8_t *)cache_oks, capacity,
      (int32_t *)tabs, (uint8_t *)oks, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_cached_windows<<<grid_for(wn * g, threads), threads, 0, st>>>(
      (const uint8_t *)zk_bytes, (const uint8_t *)z_bytes, (const int32_t *)tabs,
      (const int16_t *)tables, (const int32_t *)slots, capacity, splits, (int32_t *)wsum, n, g,
      wn);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return msm_tail_launch<false>((const int32_t *)wsum, (int32_t *)ws, (const uint8_t *)oks,
                                zs_bytes, fixed_table, out, n, g, wn, wn, st);
}
