// The randomized-linear-combination check shared by both signature planes
// (msm.cu for ed25519, msm_sr.cu for sr25519): three launches from one
// entry point, on the caller's stream.
//   1. tables: one thread per point of -A | -R; decodes it (ZIP-215, or
//      ristretto when SR) and writes its 16 multiples (ten-limb form) and
//      its decode bit to scratch.
//   2. windows: one thread per (window w, stream g) accumulator, looping
//      over the rows g, g + G, g + 2G, ... and adding each row's table
//      entry for nibble w of z*h (and of z, for w < 32). The reference's
//      TPU program runs the same (window, stream) grid in lock step.
//   3. tail: one block of G threads; each Horner-combines its stream's 64
//      window sums (W of them in general), the block tree-reduces the streams in shared memory,
//      and thread 0 adds [zs]B by the 64-row fixed-base comb and decides:
//      ed25519 clears the cofactor (3 doublings) and tests the projective
//      identity; sr25519 (prime order, no cofactor) keeps T in the last
//      addition and tests that the ristretto encoding is 32 zero bytes,
//      since projective equality would miss the identity coset's other
//      representatives. The decode bits of every row, padding rows
//      included, are ANDed in the same block.
// The cached ed25519 check (msm_cached.cu) reads -A from the split pubkey
// cache: its tables step runs for -R alone and folds each row's cache ok
// bit into R's decode bit; its windows step covers W = max(32, 64/S)
// windows, adding R's entry for nibble w of z in every window and, for
// w < 64/S, the S cache-row entries for nibbles c * 64/S + w of z*h (row c
// holds -[2^(256c/S)]A's multiples); the tail is the same with W windows.
#pragma once
#include <cuda_runtime.h>

#include "ladder.cuh"
#include "ristretto.cuh"

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
  ge_build_table(tabs + i, 2 * n, p);
}

__global__ void msm_windows(const uint8_t *zk_bytes, const uint8_t *z_bytes, const int32_t *tabs,
                            int32_t *wsum, int n, int g) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 64 * g) return;
  const int w = idx / g, stream = idx % g;
  ge acc, e;
  ge_identity(acc);
#pragma unroll 1
  for (int row = stream; row < n; row += g) {
    ge_load(e, tabs + row, nibble(zk_bytes + 32 * row, w), 2 * n);
    ge_add(acc, acc, e, true);
    if (w < 32) {
      ge_load(e, tabs + n + row, nibble(z_bytes + 16 * row, w), 2 * n);
      ge_add(acc, acc, e, true);
    }
  }
  ge_store(wsum + idx, 0, 64 * g, acc);  // point (w, stream) at idx
}

// The tail over wn windows of g streams; oks holds m decode bits.
template <bool SR>
__global__ void msm_tail(const int32_t *wsum, const uint8_t *oks, const uint8_t *zs_bytes,
                         const int32_t *fixed_table, uint8_t *out, int m, int g, int wn) {
  extern __shared__ int32_t sh[];  // g points, strided by g
  const int s = threadIdx.x;
  ge acc, e;
  ge_load(acc, wsum + (wn - 1) * g + s, 0, wn * g);
#pragma unroll 1
  for (int w = wn - 2; w >= 0; w--) {
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, true);
    ge_load(e, wsum + w * g + s, 0, wn * g);
    ge_add(acc, acc, e, true);
  }
  ge_store(sh + s, 0, g, acc);
  bool ok = true;
  for (int i = s; i < m; i += g) ok = ok && oks[i];
  ok = __syncthreads_and(ok);
  for (int half = g / 2; half >= 1; half /= 2) {
    if (s < half) {
      ge_load(acc, sh + s, 0, g);
      ge_load(e, sh + s + half, 0, g);
      ge_add(acc, acc, e, true);
      ge_store(sh + s, 0, g, acc);
    }
    __syncthreads();
  }
  if (s != 0) return;
  ge_load(acc, sh, 0, g);
  ge sb;
  ge_identity(sb);
#pragma unroll 1
  for (int i = 0; i < 64; i++) {
    ge_from_limbs8(e, fixed_table + ((size_t)i * 16 + nibble(zs_bytes, i)) * 128);
    ge_add(sb, sb, e, true);
  }
  bool zero;
  if constexpr (SR) {
    ge_add(acc, acc, sb, true);  // the encoder reads T
    uint8_t enc[32];
    ristretto_encode(enc, acc);
    uint8_t any = 0;
#pragma unroll
    for (int i = 0; i < 32; i++) any |= enc[i];
    zero = any == 0;
  } else {
    ge_add(acc, acc, sb, false);
#pragma unroll 1
    for (int i = 0; i < 3; i++) ge_dbl(acc, acc, false);
    zero = ge_is_identity(acc);
  }
  out[0] = (ok && zero) ? 1 : 0;
}

template <bool SR>
static int msm_tail_launch(const int32_t *wsum, const uint8_t *oks, const void *zs_bytes,
                           const void *fixed_table, void *out, int m, int g, int wn,
                           cudaStream_t st) {
  const size_t shmem = (size_t)g * 40 * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        msm_tail<SR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (rc) return rc;
  }
  msm_tail<SR><<<1, g, shmem, st>>>(wsum, oks, (const uint8_t *)zs_bytes,
                                    (const int32_t *)fixed_table, (uint8_t *)out, m, g, wn);
  return (int)cudaGetLastError();
}

template <bool SR>
static int msm_launch(const void *a_enc, const void *r_enc, const void *zk_bytes,
                      const void *z_bytes, const void *zs_bytes, const void *fixed_table,
                      void *tabs, void *oks, void *wsum, void *out, int n, int g, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (g < 1 || g > 1024 || n % g) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  msm_tables<SR><<<grid_for(2 * n, threads), threads, 0, st>>>(
      (const uint8_t *)a_enc, (const uint8_t *)r_enc, (int32_t *)tabs, (uint8_t *)oks, n);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  msm_windows<<<grid_for(64 * g, threads), threads, 0, st>>>(
      (const uint8_t *)zk_bytes, (const uint8_t *)z_bytes, (const int32_t *)tabs, (int32_t *)wsum,
      n, g);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return msm_tail_launch<SR>((const int32_t *)wsum, (const uint8_t *)oks, zs_bytes, fixed_table,
                             out, 2 * n, g, 64, st);
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
  // an out-of-range slot clamps, as the reference's XLA gather does
  const int slot = min(max(slots[i], 0), capacity - 1);
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
      const int slot = min(max(slots[row], 0), capacity - 1);
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
                             void *wsum, void *out, int n, int g, int capacity, int splits,
                             void *stream) {
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
  return msm_tail_launch<false>((const int32_t *)wsum, (const uint8_t *)oks, zs_bytes,
                                fixed_table, out, n, g, wn, st);
}
