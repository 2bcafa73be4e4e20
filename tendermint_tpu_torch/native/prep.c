/* Native host prep for the port's verify planes, a trimmed copy of the
 * JAX package's tendermint_tpu/native/prep.c with the same bytes out:
 *
 *   prepare_batch   the host side of ops/verify.prepare_batch: per
 *                   signature, SHA-512(R||A||M) reduced mod L, byte
 *                   shaping of (A, R, S) and the s < L precheck, on up
 *                   to 8 pthreads (serial below 2,048 rows);
 *   tm_rlc_scalars  the RLC's scalars (ops/msm._rlc_scalars):
 *                   zk_i = z_i k_i mod L and zs = sum z_i s_i mod L;
 *   tm_host_verify  ed25519 through a dlopen'd libcrypto's EVP verify,
 *                   on up to 8 pthreads (serial below 16 rows);
 *   tm_mod_l        the 512-bit reduction, exported for tests;
 *   tm_sha256_batch, tm_merkle_root, tm_merkle_proofs, tm_merkle_multiproof
 *                   the SHA-256 / RFC-6962 merkle plane of crypto/merkle.py
 *                   (leaf hashing on up to 8 pthreads for big trees).
 *
 * Unlike the reference's copy, prepare_batch and the merkle plane return a
 * status: a failed allocation is reported to the caller, which raises.
 *
 * SHA-512 is implemented from FIPS 180-4 (constants generated from the
 * prime square/cube-root definitions); the mod-L reduction uses
 * 2^256 === R (mod L) folding with 64-bit limbs and __int128 products.
 */

#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <unistd.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;

/* ------------------------------------------------------------ SHA-512 */

static const u64 K[80] = {
0x428a2f98d728ae22ULL,0x7137449123ef65cdULL,0xb5c0fbcfec4d3b2fULL,0xe9b5dba58189dbbcULL,
0x3956c25bf348b538ULL,0x59f111f1b605d019ULL,0x923f82a4af194f9bULL,0xab1c5ed5da6d8118ULL,
0xd807aa98a3030242ULL,0x12835b0145706fbeULL,0x243185be4ee4b28cULL,0x550c7dc3d5ffb4e2ULL,
0x72be5d74f27b896fULL,0x80deb1fe3b1696b1ULL,0x9bdc06a725c71235ULL,0xc19bf174cf692694ULL,
0xe49b69c19ef14ad2ULL,0xefbe4786384f25e3ULL,0x0fc19dc68b8cd5b5ULL,0x240ca1cc77ac9c65ULL,
0x2de92c6f592b0275ULL,0x4a7484aa6ea6e483ULL,0x5cb0a9dcbd41fbd4ULL,0x76f988da831153b5ULL,
0x983e5152ee66dfabULL,0xa831c66d2db43210ULL,0xb00327c898fb213fULL,0xbf597fc7beef0ee4ULL,
0xc6e00bf33da88fc2ULL,0xd5a79147930aa725ULL,0x06ca6351e003826fULL,0x142929670a0e6e70ULL,
0x27b70a8546d22ffcULL,0x2e1b21385c26c926ULL,0x4d2c6dfc5ac42aedULL,0x53380d139d95b3dfULL,
0x650a73548baf63deULL,0x766a0abb3c77b2a8ULL,0x81c2c92e47edaee6ULL,0x92722c851482353bULL,
0xa2bfe8a14cf10364ULL,0xa81a664bbc423001ULL,0xc24b8b70d0f89791ULL,0xc76c51a30654be30ULL,
0xd192e819d6ef5218ULL,0xd69906245565a910ULL,0xf40e35855771202aULL,0x106aa07032bbd1b8ULL,
0x19a4c116b8d2d0c8ULL,0x1e376c085141ab53ULL,0x2748774cdf8eeb99ULL,0x34b0bcb5e19b48a8ULL,
0x391c0cb3c5c95a63ULL,0x4ed8aa4ae3418acbULL,0x5b9cca4f7763e373ULL,0x682e6ff3d6b2b8a3ULL,
0x748f82ee5defb2fcULL,0x78a5636f43172f60ULL,0x84c87814a1f0ab72ULL,0x8cc702081a6439ecULL,
0x90befffa23631e28ULL,0xa4506cebde82bde9ULL,0xbef9a3f7b2c67915ULL,0xc67178f2e372532bULL,
0xca273eceea26619cULL,0xd186b8c721c0c207ULL,0xeada7dd6cde0eb1eULL,0xf57d4f7fee6ed178ULL,
0x06f067aa72176fbaULL,0x0a637dc5a2c898a6ULL,0x113f9804bef90daeULL,0x1b710b35131c471bULL,
0x28db77f523047d84ULL,0x32caab7b40c72493ULL,0x3c9ebe0a15c9bebcULL,0x431d67c49c100d4cULL,
0x4cc5d4becb3e42b6ULL,0x597f299cfc657e2aULL,0x5fcb6fab3ad6faecULL,0x6c44198c4a475817ULL};

#define ROR(x,n) (((x) >> (n)) | ((x) << (64-(n))))

static void sha512_compress(u64 st[8], const uint8_t blk[128]) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
        w[i] = ((u64)blk[8*i] << 56) | ((u64)blk[8*i+1] << 48) |
               ((u64)blk[8*i+2] << 40) | ((u64)blk[8*i+3] << 32) |
               ((u64)blk[8*i+4] << 24) | ((u64)blk[8*i+5] << 16) |
               ((u64)blk[8*i+6] << 8) | (u64)blk[8*i+7];
    }
    for (int i = 16; i < 80; i++) {
        u64 s0 = ROR(w[i-15],1) ^ ROR(w[i-15],8) ^ (w[i-15] >> 7);
        u64 s1 = ROR(w[i-2],19) ^ ROR(w[i-2],61) ^ (w[i-2] >> 6);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    u64 a=st[0],b=st[1],c=st[2],d=st[3],e=st[4],f=st[5],g=st[6],h=st[7];
    for (int i = 0; i < 80; i++) {
        u64 S1 = ROR(e,14) ^ ROR(e,18) ^ ROR(e,41);
        u64 ch = (e & f) ^ (~e & g);
        u64 t1 = h + S1 + ch + K[i] + w[i];
        u64 S0 = ROR(a,28) ^ ROR(a,34) ^ ROR(a,39);
        u64 mj = (a & b) ^ (a & c) ^ (b & c);
        u64 t2 = S0 + mj;
        h=g; g=f; f=e; e=d+t1; d=c; c=b; b=a; a=t1+t2;
    }
    st[0]+=a; st[1]+=b; st[2]+=c; st[3]+=d; st[4]+=e; st[5]+=f; st[6]+=g; st[7]+=h;
}

/* OpenSSL's asm-optimized SHA512 and SHA256 when libcrypto is present
 * (2-4x the portable compressions); resolved once, thread-safe. Both give
 * the same digests, so which one runs changes no byte; sha512_local and
 * sha256_local serve where libcrypto or its SHA256 symbol is absent. */
typedef unsigned char *(*ossl_sha512_fn)(const unsigned char *, size_t,
                                         unsigned char *);
typedef unsigned char *(*ossl_sha256_fn)(const unsigned char *, size_t,
                                         unsigned char *);
static ossl_sha512_fn ossl_sha512;
static ossl_sha256_fn ossl_sha256;
static pthread_once_t ossl_once = PTHREAD_ONCE_INIT;

static void ossl_resolve(void) {
    const char *names[] = {"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so", 0};
    for (int i = 0; names[i]; i++) {
        void *h = dlopen(names[i], RTLD_NOW | RTLD_LOCAL);
        if (h) {
            ossl_sha512 = (ossl_sha512_fn)dlsym(h, "SHA512");
            ossl_sha256 = (ossl_sha256_fn)dlsym(h, "SHA256");
            if (ossl_sha512) return;  /* sha256 may be absent: local then */
            dlclose(h);
            ossl_sha256 = 0;
        }
    }
}

static void sha512_local(const uint8_t *data, u64 len, uint8_t out[64]) {
    u64 st[8] = {0x6a09e667f3bcc908ULL,0xbb67ae8584caa73bULL,0x3c6ef372fe94f82bULL,
                 0xa54ff53a5f1d36f1ULL,0x510e527fade682d1ULL,0x9b05688c2b3e6c1fULL,
                 0x1f83d9abfb41bd6bULL,0x5be0cd19137e2179ULL};
    u64 full = len / 128;
    for (u64 i = 0; i < full; i++) sha512_compress(st, data + 128*i);
    uint8_t tail[256];
    u64 rem = len - 128*full;
    memcpy(tail, data + 128*full, rem);
    tail[rem] = 0x80;
    u64 tail_len = (rem + 1 + 16 <= 128) ? 128 : 256;
    memset(tail + rem + 1, 0, tail_len - rem - 1);
    u64 bits = len * 8;  /* messages here are far below 2^64 bits */
    for (int i = 0; i < 8; i++) tail[tail_len-1-i] = (uint8_t)(bits >> (8*i));
    sha512_compress(st, tail);
    if (tail_len == 256) sha512_compress(st, tail + 128);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[8*i+j] = (uint8_t)(st[i] >> (56 - 8*j));
}

/* ------------------------------------------------- mod L (group order) */

/* L = 2^252 + 27742317777372353535851937790883648493, little-endian limbs */
static const u64 L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                               0x0ULL, 0x1000000000000000ULL};

static int ge(const u64 *a, const u64 *b, int n) {
    for (int i = n-1; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

/* multi-limb subtract with borrow */
static void sub_n(u64 *a, const u64 *b, int nb, int n) {
    u64 borrow = 0;
    for (int i = 0; i < n; i++) {
        u64 bi = (i < nb) ? b[i] : 0;
        u64 ai = a[i];
        u64 t1 = ai - bi;
        u64 borrow1 = (ai < bi);
        u64 t2 = t1 - borrow;
        u64 borrow2 = (t1 < borrow);
        a[i] = t2;
        borrow = borrow1 | borrow2;
    }
}

/* digest (64 bytes LE) mod L -> 32 bytes LE */
/* c = L - 2^252, so 2^252 === -c (mod L); c fits two limbs. */
static const u64 C_LIMBS[2] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL};

/* Horner reduction of the 512-bit digest: consume one 64-bit limb per
 * round (most significant first). Invariant r < L (252 bits). Per
 * round t = r*2^64 + limb < 2^316; split t = hi*2^252 + lo with hi a
 * single limb, then t === lo - hi*c (mod L), corrected into [0, L)
 * with at most one add/sub of L. Two __int128 multiplies per round —
 * constant time and ~100x the iteration count of a naive
 * subtract-until-below loop. */
void tm_mod_l(const uint8_t digest[64], uint8_t out[32]);

/* exported (tm_mod_l) so the test suite can drive the reduction over
 * adversarial digests directly — random fuzz cannot reach the
 * r in [2^252, L) intermediate states (probability ~2^-126). */
void tm_mod_l(const uint8_t digest[64], uint8_t out[32]) {
    u64 d[8];
    for (int i = 0; i < 8; i++) {
        d[i] = 0;
        for (int j = 0; j < 8; j++) d[i] |= (u64)digest[8*i+j] << (8*j);
    }
    u64 r[4] = {0, 0, 0, 0};
    for (int i = 7; i >= 0; i--) {
        /* t = r<<64 | d[i], 5 limbs; t[4] = r[3] < 2^60 */
        u64 t0 = d[i], t1 = r[0], t2 = r[1], t3 = r[2], t4 = r[3];
        /* r < L allows r in [2^252, L), where t4 == 2^60 exactly and
         * (canonicity forces r[2] == 0, so) the true hi is 2^64: the
         * wrapped low word (t4 << 4) is 0 and the 65th bit must be
         * folded as an extra c<<64 term. */
        u64 hi = (t3 >> 60) | (t4 << 4);
        u64 hi_ext = t4 >> 60; /* 0 or 1 */
        u64 lo0 = t0, lo1 = t1, lo2 = t2, lo3 = t3 & 0x0fffffffffffffffULL;
        /* prod = hi * c + hi_ext * (c << 64) (3 limbs) */
        u128 p = (u128)hi * C_LIMBS[0];
        u64 pr0 = (u64)p;
        u64 carry = (u64)(p >> 64);
        p = (u128)hi * C_LIMBS[1] + carry;
        u64 pr1 = (u64)p, pr2 = (u64)(p >> 64);
        if (hi_ext) {
            p = (u128)pr1 + C_LIMBS[0];
            pr1 = (u64)p;
            pr2 += C_LIMBS[1] + (u64)(p >> 64); /* < 2^62: no carry out */
        }
        /* z = lo - prod, borrow-tracked */
        u64 z[4];
        unsigned char b = 0;
        u128 t;
        t = (u128)lo0 - pr0;             z[0] = (u64)t; b = (t >> 64) != 0;
        t = (u128)lo1 - pr1 - b;         z[1] = (u64)t; b = (t >> 64) != 0;
        t = (u128)lo2 - pr2 - b;         z[2] = (u64)t; b = (t >> 64) != 0;
        t = (u128)lo3 - b;               z[3] = (u64)t; b = (t >> 64) != 0;
        if (b) {
            /* z was negative (> -2^189): one +L lands in [0, L) */
            unsigned char cy = 0;
            t = (u128)z[0] + L_LIMBS[0];       z[0] = (u64)t; cy = (u64)(t >> 64);
            t = (u128)z[1] + L_LIMBS[1] + cy;  z[1] = (u64)t; cy = (u64)(t >> 64);
            t = (u128)z[2] + L_LIMBS[2] + cy;  z[2] = (u64)t; cy = (u64)(t >> 64);
            z[3] = z[3] + L_LIMBS[3] + cy;
        } else if (ge(z, L_LIMBS, 4)) {
            sub_n(z, L_LIMBS, 4, 4);
        }
        r[0] = z[0]; r[1] = z[1]; r[2] = z[2]; r[3] = z[3];
    }
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) out[8*i+j] = (uint8_t)(r[i] >> (8*j));
}

/* ------------------------------------------------------------ batch API */

/* s (32 bytes LE) < L ? */
static int s_in_range(const uint8_t s[32]) {
    u64 sl[4];
    for (int i = 0; i < 4; i++) {
        sl[i] = 0;
        for (int j = 0; j < 8; j++) sl[i] |= (u64)s[8*i+j] << (8*j);
    }
    return !ge(sl, L_LIMBS, 4);
}

static void sha512(const uint8_t *data, u64 len, uint8_t out[64]) {
    if (ossl_sha512) {
        ossl_sha512(data, len, out);
    } else {
        sha512_local(data, len, out);
    }
}

/* Rows lo..hi-1; returns 0, or -1 when a long message's buffer could
 * not be allocated (the rows from that one on are left unwritten). */
static int prepare_range(const uint8_t *pks, const uint8_t *sigs,
                         const uint8_t *msgs, const int64_t *offsets,
                         int64_t lo, int64_t hi,
                         uint8_t *out_a, uint8_t *out_r, uint8_t *out_s,
                         uint8_t *out_k, uint8_t *precheck) {
    uint8_t buf[64 + 4096];
    uint8_t digest[64], k[32];
    for (int64_t i = lo; i < hi; i++) {
        const uint8_t *pk = pks + 32*i;
        const uint8_t *sig = sigs + 64*i;
        const uint8_t *msg = msgs + offsets[i];
        int64_t mlen = offsets[i+1] - offsets[i];
        precheck[i] = 0;
        if (!s_in_range(sig + 32)) {
            for (int j = 0; j < 32; j++) {
                out_a[32*i+j] = out_r[32*i+j] = out_s[32*i+j] = out_k[32*i+j] = 0;
            }
            continue;
        }
        const uint8_t *hash_input;
        uint8_t *heap = 0;
        u64 total = 64 + (u64)mlen;
        if (mlen <= 4096) {
            memcpy(buf, sig, 32);
            memcpy(buf + 32, pk, 32);
            memcpy(buf + 64, msg, mlen);
            hash_input = buf;
        } else {
            heap = (uint8_t *)__builtin_malloc(total);
            if (!heap) return -1;
            memcpy(heap, sig, 32);
            memcpy(heap + 32, pk, 32);
            memcpy(heap + 64, msg, mlen);
            hash_input = heap;
        }
        sha512(hash_input, total, digest);
        if (heap) __builtin_free(heap);
        tm_mod_l(digest, k);
        for (int j = 0; j < 32; j++) {
            out_a[32*i+j] = pk[j];
            out_r[32*i+j] = sig[j];
            out_s[32*i+j] = sig[32+j];
            out_k[32*i+j] = k[j];
        }
        precheck[i] = 1;
    }
    return 0;
}

/* ---------------------------------------------------- RLC randomizers */

static void load_le(const uint8_t *b, int nbytes, u64 *out, int nlimbs) {
    for (int i = 0; i < nlimbs; i++) {
        out[i] = 0;
        for (int j = 0; j < 8; j++) {
            int idx = 8 * i + j;
            if (idx < nbytes) out[i] |= (u64)b[idx] << (8 * j);
        }
    }
}

/* (2-limb a) * (4-limb b) -> 64-byte LE buffer (6 limbs + 2 zero), fed
 * straight back through tm_mod_l's 512-bit Horner reduction. */
static void mul_2x4_modl(const u64 a[2], const u64 b[4], uint8_t out[32]) {
    u64 prod[8] = {0};
    for (int i = 0; i < 2; i++) {
        u64 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)a[i] * b[j] + prod[i + j] + carry;
            prod[i + j] = (u64)t;
            carry = (u64)(t >> 64);
        }
        prod[i + 4] += carry; /* top limb of this row; prod[5] <= 2^64-1, no overflow */
    }
    uint8_t buf[64];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) buf[8 * i + j] = (uint8_t)(prod[i] >> (8 * j));
    tm_mod_l(buf, out);
}

/* Host-side scalar math for the RLC/MSM batch equation (ops/msm.py):
 * per signature zk_i = z_i * k_i mod L, plus zs = sum z_i * s_i mod L.
 * z_raw: n*16 LE randomizers; s/k rows: n*32 LE (k already < L).
 * Exported alongside prepare_batch so the MSM path's host cost keeps
 * up with the chip (the pure-Python loop tops out ~280k sigs/s). */
void tm_rlc_scalars(const uint8_t *z_raw, const uint8_t *s_rows,
                    const uint8_t *k_rows, int64_t n,
                    uint8_t *zk_out, uint8_t *zs_out) {
    u64 acc[4] = {0, 0, 0, 0};
    for (int64_t i = 0; i < n; i++) {
        u64 z[2], k4[4], s4[4];
        load_le(z_raw + 16 * i, 16, z, 2);
        load_le(k_rows + 32 * i, 32, k4, 4);
        load_le(s_rows + 32 * i, 32, s4, 4);
        mul_2x4_modl(z, k4, zk_out + 32 * i);
        uint8_t zsm[32];
        mul_2x4_modl(z, s4, zsm);
        u64 t4[4];
        load_le(zsm, 32, t4, 4);
        /* acc = (acc + t4) mod L; both < L < 2^253 so the sum fits */
        u64 cy = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)acc[j] + t4[j] + cy;
            acc[j] = (u64)t;
            cy = (u64)(t >> 64);
        }
        if (ge(acc, L_LIMBS, 4)) sub_n(acc, L_LIMBS, 4, 4);
    }
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) zs_out[8 * i + j] = (uint8_t)(acc[i] >> (8 * j));
}

typedef struct {
    const uint8_t *pks, *sigs, *msgs;
    const int64_t *offsets;
    int64_t lo, hi;
    uint8_t *out_a, *out_r, *out_s, *out_k, *precheck;
    int status;
} prep_job;

static void *prep_worker(void *arg) {
    prep_job *j = (prep_job *)arg;
    j->status = prepare_range(j->pks, j->sigs, j->msgs, j->offsets, j->lo, j->hi,
                              j->out_a, j->out_r, j->out_s, j->out_k, j->precheck);
    return 0;
}

/* Inputs: pks n*32, sigs n*64, msgs concatenated with offsets[n+1].
 * Outputs: a/r/s/k as uint8 arrays (n*32) — the device transfer
 * format; the kernel widens to int32 on chip — precheck bytes (n).
 *
 * Parallel over the batch for large n: each signature's prep is
 * independent (pure SHA-512 + mod L), so the range splits cleanly
 * across cores; the caller's ctypes FFI releases the GIL, so these
 * threads run truly concurrent with Python.
 *
 * Returns 0, or -1 when a buffer could not be allocated: the outputs
 * are then incomplete and the caller must not use them. */
int prepare_batch(const uint8_t *pks, const uint8_t *sigs,
                  const uint8_t *msgs, const int64_t *offsets, int64_t n,
                  uint8_t *out_a, uint8_t *out_r, uint8_t *out_s,
                  uint8_t *out_k, uint8_t *precheck) {
    pthread_once(&ossl_once, ossl_resolve);
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int nthreads = (int)(ncpu < 1 ? 1 : (ncpu > 8 ? 8 : ncpu));
    if (n < 2048 || nthreads == 1)
        return prepare_range(pks, sigs, msgs, offsets, 0, n,
                             out_a, out_r, out_s, out_k, precheck);
    pthread_t threads[8];
    prep_job jobs[8];
    int64_t chunk = (n + nthreads - 1) / nthreads;
    int started = 0, status = 0;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) break;
        jobs[t] = (prep_job){pks, sigs, msgs, offsets, lo, hi,
                             out_a, out_r, out_s, out_k, precheck, 0};
        if (pthread_create(&threads[t], 0, prep_worker, &jobs[t]) != 0) {
            /* thread spawn failed: finish this and all remaining
             * ranges inline */
            status = prepare_range(pks, sigs, msgs, offsets, lo, n,
                                   out_a, out_r, out_s, out_k, precheck);
            break;
        }
        started++;
    }
    for (int t = 0; t < started; t++) {
        pthread_join(threads[t], 0);
        if (jobs[t].status) status = jobs[t].status;
    }
    return status;
}

/* -------------------- OpenSSL EVP ed25519 host verify -----------------
 *
 * The host-path analog of the batch kernel: one C call verifies a whole
 * batch through libcrypto's ed25519 (RFC 8032, cofactorless), threaded
 * across cores. The caller's ctypes FFI releases the GIL for the whole
 * batch, so — unlike a Python loop over per-signature FFI calls, which
 * reacquires the GIL between calls and scales at ~0.6x with threads —
 * this reaches near-linear multicore scaling.
 *
 * Acceptance contract (same as crypto/ed25519._single_verify): anything
 * OpenSSL ACCEPTS is also ZIP-215-valid, so out[i]=1 is authoritative;
 * out[i]=0 only means "not RFC-8032-accepted" and the caller re-checks
 * those rows with the pure-Python ZIP-215 oracle. libcrypto is dlopen'd
 * like SHA512 above; without it tm_host_verify returns 0 and builds
 * fine (the port's caller raises then, unless TM_TPU_NATIVE=0). */

typedef void *(*evp_pkey_new_raw_fn)(int, void *, const unsigned char *, size_t);
typedef void (*evp_pkey_free_fn)(void *);
typedef void *(*evp_md_ctx_new_fn)(void);
typedef void (*evp_md_ctx_free_fn)(void *);
typedef int (*evp_dv_init_fn)(void *, void **, const void *, void *, void *);
typedef int (*evp_dv_fn)(void *, const unsigned char *, size_t,
                         const unsigned char *, size_t);
typedef void (*err_clear_fn)(void);

static struct {
    int ready;
    evp_pkey_new_raw_fn pkey_new_raw;
    evp_pkey_free_fn pkey_free;
    evp_md_ctx_new_fn ctx_new;
    evp_md_ctx_free_fn ctx_free;
    evp_dv_init_fn dv_init;
    evp_dv_fn dv;
    err_clear_fn err_clear;
} evp;
static pthread_once_t evp_once = PTHREAD_ONCE_INIT;

static void evp_resolve(void) {
    const char *names[] = {"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so", 0};
    for (int i = 0; names[i]; i++) {
        void *h = dlopen(names[i], RTLD_NOW | RTLD_LOCAL);
        if (!h) continue;
        evp.pkey_new_raw = (evp_pkey_new_raw_fn)dlsym(h, "EVP_PKEY_new_raw_public_key");
        evp.pkey_free = (evp_pkey_free_fn)dlsym(h, "EVP_PKEY_free");
        evp.ctx_new = (evp_md_ctx_new_fn)dlsym(h, "EVP_MD_CTX_new");
        evp.ctx_free = (evp_md_ctx_free_fn)dlsym(h, "EVP_MD_CTX_free");
        evp.dv_init = (evp_dv_init_fn)dlsym(h, "EVP_DigestVerifyInit");
        evp.dv = (evp_dv_fn)dlsym(h, "EVP_DigestVerify");
        evp.err_clear = (err_clear_fn)dlsym(h, "ERR_clear_error");
        if (evp.pkey_new_raw && evp.pkey_free && evp.ctx_new && evp.ctx_free
            && evp.dv_init && evp.dv) {
            evp.ready = 1;
            return;
        }
        dlclose(h);
    }
}

#define TM_EVP_PKEY_ED25519 1087 /* NID_ED25519, stable across 1.1.1 / 3.x */

static void verify_range(const uint8_t *pks, const uint8_t *sigs,
                         const uint8_t *msgs, const int64_t *offsets,
                         int64_t lo, int64_t hi, uint8_t *out) {
    for (int64_t i = lo; i < hi; i++) {
        out[i] = 0;
        void *pkey = evp.pkey_new_raw(TM_EVP_PKEY_ED25519, 0, pks + 32 * i, 32);
        if (!pkey) {
            if (evp.err_clear) evp.err_clear();
            continue;
        }
        void *ctx = evp.ctx_new();
        if (ctx) {
            if (evp.dv_init(ctx, 0, 0, 0, pkey) == 1
                && evp.dv(ctx, sigs + 64 * i, 64, msgs + offsets[i],
                          (size_t)(offsets[i + 1] - offsets[i])) == 1)
                out[i] = 1;
            evp.ctx_free(ctx);
        }
        evp.pkey_free(pkey);
        /* failed inits/verifies leave entries on the thread-local error
         * queue; clear so long-lived callers don't accumulate them */
        if (!out[i] && evp.err_clear) evp.err_clear();
    }
}

typedef struct {
    const uint8_t *pks, *sigs, *msgs;
    const int64_t *offsets;
    int64_t lo, hi;
    uint8_t *out;
} verify_job;

static void *verify_worker(void *arg) {
    verify_job *j = (verify_job *)arg;
    verify_range(j->pks, j->sigs, j->msgs, j->offsets, j->lo, j->hi, j->out);
    return 0;
}

/* Inputs: pks n*32, sigs n*64, msgs concatenated with offsets[n+1].
 * Output: out[i] = 1 iff OpenSSL accepts row i. Returns 1 when
 * libcrypto served the batch, 0 when it is unavailable (out untouched). */
int tm_host_verify(const uint8_t *pks, const uint8_t *sigs,
                   const uint8_t *msgs, const int64_t *offsets, int64_t n,
                   uint8_t *out) {
    pthread_once(&evp_once, evp_resolve);
    if (!evp.ready) return 0;
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int nthreads = (int)(ncpu < 1 ? 1 : (ncpu > 8 ? 8 : ncpu));
    /* a verify is ~100x a prep row, so threads pay off far earlier */
    if (n < 16 || nthreads == 1) {
        verify_range(pks, sigs, msgs, offsets, 0, n, out);
        return 1;
    }
    pthread_t threads[8];
    verify_job jobs[8];
    int64_t chunk = (n + nthreads - 1) / nthreads;
    int started = 0;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) break;
        jobs[t] = (verify_job){pks, sigs, msgs, offsets, lo, hi, out};
        if (pthread_create(&threads[t], 0, verify_worker, &jobs[t]) != 0) {
            verify_range(pks, sigs, msgs, offsets, lo, n, out);
            break;
        }
        started++;
    }
    for (int t = 0; t < started; t++) pthread_join(threads[t], 0);
    return 1;
}


/* --------------------- SHA-256 + RFC-6962 merkle plane ----------------
 *
 * The structural hashes of a block (the header's fields, the commit's
 * signatures, the validator set, the txs) as one ctypes call a tree (GIL
 * released throughout), one contiguous 32-byte-stride buffer a level, no
 * recursion. SHA-256 is FIPS 180-4 (the local portable compression) with
 * libcrypto's asm SHA256 used when it resolves, as SHA-512 above.
 *
 * Every entry point returns 0, or -1 when a buffer could not be
 * allocated: the outputs are then incomplete and the caller raises. */

static const uint32_t K256[64] = {
0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,0x923f82a4,0xab1c5ed5,
0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,
0xe49b69c1,0xefbe4786,0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,0x06ca6351,0x14292967,
0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,
0xa2bfe8a1,0xa81a664b,0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,0x5b9cca4f,0x682e6ff3,
0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2};

#define ROR32(x,n) (((x) >> (n)) | ((x) << (32-(n))))

static void sha256_compress(uint32_t st[8], const uint8_t blk[64]) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++) {
        w[i] = ((uint32_t)blk[4*i] << 24) | ((uint32_t)blk[4*i+1] << 16) |
               ((uint32_t)blk[4*i+2] << 8) | (uint32_t)blk[4*i+3];
    }
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = ROR32(w[i-15],7) ^ ROR32(w[i-15],18) ^ (w[i-15] >> 3);
        uint32_t s1 = ROR32(w[i-2],17) ^ ROR32(w[i-2],19) ^ (w[i-2] >> 10);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    uint32_t a=st[0],b=st[1],c=st[2],d=st[3],e=st[4],f=st[5],g=st[6],h=st[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = ROR32(e,6) ^ ROR32(e,11) ^ ROR32(e,25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K256[i] + w[i];
        uint32_t S0 = ROR32(a,2) ^ ROR32(a,13) ^ ROR32(a,22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + mj;
        h=g; g=f; f=e; e=d+t1; d=c; c=b; b=a; a=t1+t2;
    }
    st[0]+=a; st[1]+=b; st[2]+=c; st[3]+=d; st[4]+=e; st[5]+=f; st[6]+=g; st[7]+=h;
}

static void sha256_local(const uint8_t *data, u64 len, uint8_t out[32]) {
    uint32_t st[8] = {0x6a09e667,0xbb67ae85,0x3c6ef372,0xa54ff53a,
                      0x510e527f,0x9b05688c,0x1f83d9ab,0x5be0cd19};
    u64 full = len / 64;
    for (u64 i = 0; i < full; i++) sha256_compress(st, data + 64*i);
    uint8_t tail[128];
    u64 rem = len - 64*full;
    memcpy(tail, data + 64*full, rem);
    tail[rem] = 0x80;
    u64 tail_len = (rem + 1 + 8 <= 64) ? 64 : 128;
    memset(tail + rem + 1, 0, tail_len - rem - 1);
    u64 bits = len * 8;
    for (int i = 0; i < 8; i++) tail[tail_len-1-i] = (uint8_t)(bits >> (8*i));
    sha256_compress(st, tail);
    if (tail_len == 128) sha256_compress(st, tail + 64);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++)
            out[4*i+j] = (uint8_t)(st[i] >> (24 - 8*j));
}

static void sha256(const uint8_t *data, u64 len, uint8_t out[32]) {
    if (ossl_sha256) {
        ossl_sha256(data, len, out);
    } else {
        sha256_local(data, len, out);
    }
}

/* SHA256(has_prefix ? prefix || item : item), the RFC-6962 leaf and inner
 * domain separation. One-shot hashing needs contiguous input: a stack
 * buffer for typical leaves (proto encodes, tx hashes), the heap for big
 * ones (64 KiB block parts). Returns 0, or -1 when that buffer could not
 * be allocated (out is then left unwritten). */
static int sha256_prefixed(int has_prefix, uint8_t prefix,
                           const uint8_t *item, int64_t len, uint8_t *out) {
    if (!has_prefix) {
        sha256(item, (u64)len, out);
        return 0;
    }
    uint8_t buf[1 + 4096];
    uint8_t *p = buf;
    if (len > 4096) {
        p = (uint8_t *)__builtin_malloc((u64)len + 1);
        if (!p) return -1;
    }
    p[0] = prefix;
    memcpy(p + 1, item, (u64)len);
    sha256(p, (u64)len + 1, out);
    if (p != buf) __builtin_free(p);
    return 0;
}

typedef struct {
    const uint8_t *items;
    const int64_t *offsets;
    int64_t lo, hi;
    int has_prefix;
    uint8_t prefix;
    uint8_t *out; /* 32-byte stride */
    int status;
} hash_job;

/* Items lo..hi-1; returns 0, or -1 at the first item whose buffer could
 * not be allocated (the items from that one on are left unwritten). */
static int hash_range(const uint8_t *items, const int64_t *offsets,
                      int64_t lo, int64_t hi, int has_prefix,
                      uint8_t prefix, uint8_t *out) {
    for (int64_t i = lo; i < hi; i++)
        if (sha256_prefixed(has_prefix, prefix, items + offsets[i],
                            offsets[i+1] - offsets[i], out + 32*i))
            return -1;
    return 0;
}

static void *hash_worker(void *arg) {
    hash_job *j = (hash_job *)arg;
    j->status = hash_range(j->items, j->offsets, j->lo, j->hi, j->has_prefix,
                           j->prefix, j->out);
    return 0;
}

/* Hash n items (concatenated, offsets[n+1]) into out (n*32), threading
 * across cores when there is enough total work to amortize the spawns
 * (from 1 MiB or 4,096 items). A failed pthread_create hashes the rest on
 * the calling thread: the same bytes. Returns 0 or -1 as hash_range. */
static int sha256_batch_threaded(const uint8_t *items, const int64_t *offsets,
                                 int64_t n, int has_prefix, uint8_t prefix,
                                 uint8_t *out) {
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int nthreads = (int)(ncpu < 1 ? 1 : (ncpu > 8 ? 8 : ncpu));
    int64_t total_bytes = offsets[n] - offsets[0];
    if (nthreads == 1 || n < 2 || (total_bytes < (1 << 20) && n < 4096))
        return hash_range(items, offsets, 0, n, has_prefix, prefix, out);
    pthread_t threads[8];
    hash_job jobs[8];
    int64_t chunk = (n + nthreads - 1) / nthreads;
    int started = 0, status = 0;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
        if (lo >= hi) break;
        jobs[t] = (hash_job){items, offsets, lo, hi, has_prefix, prefix, out, 0};
        if (pthread_create(&threads[t], 0, hash_worker, &jobs[t]) != 0) {
            status = hash_range(items, offsets, lo, n, has_prefix, prefix, out);
            break;
        }
        started++;
    }
    for (int t = 0; t < started; t++) {
        pthread_join(threads[t], 0);
        if (jobs[t].status) status = jobs[t].status;
    }
    return status;
}

/* Plain SHA-256 of each item (types/tx.go Tx.Hash). */
int tm_sha256_batch(const uint8_t *items, const int64_t *offsets, int64_t n,
                    uint8_t *out) {
    pthread_once(&ossl_once, ossl_resolve);
    return sha256_batch_threaded(items, offsets, n, 0, 0, out);
}

/* One level-halving pass: pair adjacent nodes (inner prefix 0x01); an odd
 * tail node is promoted unchanged. Bottom-up pairing with odd promotion
 * builds exactly the reference's split-at-the-largest-power-of-two-below-n
 * tree (crypto/merkle/tree.go getSplitPoint): both place 2^k leaves in
 * every maximal left subtree. In place over one contiguous buffer: writes
 * at index i/2 never pass unread reads. */
static int64_t merkle_halve(uint8_t *level, int64_t count) {
    uint8_t buf[65];
    buf[0] = 0x01;
    int64_t next = 0;
    for (int64_t i = 0; i + 1 < count; i += 2) {
        memcpy(buf + 1, level + 32*i, 32);
        memcpy(buf + 33, level + 32*(i+1), 32);
        sha256(buf, 65, level + 32*next);
        next++;
    }
    if (count & 1) {
        memmove(level + 32*next, level + 32*(count-1), 32);
        next++;
    }
    return next;
}

/* RFC-6962 merkle root over n items (leaf prefix 0x00, inner 0x01, the
 * empty list = SHA256("")), byte-identical to
 * crypto/merkle.hash_from_byte_slices. */
int tm_merkle_root(const uint8_t *items, const int64_t *offsets, int64_t n,
                   uint8_t *out) {
    pthread_once(&ossl_once, ossl_resolve);
    if (n == 0) {
        sha256((const uint8_t *)"", 0, out);
        return 0;
    }
    uint8_t *level = (uint8_t *)__builtin_malloc((u64)n * 32);
    if (!level) return -1;
    int status = sha256_batch_threaded(items, offsets, n, 1, 0x00, level);
    if (status == 0) {
        int64_t count = n;
        while (count > 1) count = merkle_halve(level, count);
        memcpy(out, level, 32);
    }
    __builtin_free(level);
    return status;
}

/* Root + one inclusion proof per item (crypto/merkle/proof.go
 * ProofsFromByteSlices). Outputs: root_out[32]; leaves_out n*32 (the leaf
 * hash each Proof carries); aunts_out n*stride*32 with item i's aunts
 * bottom-up at aunts_out + i*stride*32; counts_out[i] = its aunt count.
 * stride must be >= ceil(log2(n)) (the caller passes it so the buffer
 * layout is agreed on both sides). Requires n >= 1. */
int tm_merkle_proofs(const uint8_t *items, const int64_t *offsets, int64_t n,
                     int64_t stride, uint8_t *root_out, uint8_t *leaves_out,
                     uint8_t *aunts_out, int32_t *counts_out) {
    pthread_once(&ossl_once, ossl_resolve);
    if (sha256_batch_threaded(items, offsets, n, 1, 0x00, leaves_out)) return -1;
    uint8_t *level = (uint8_t *)__builtin_malloc((u64)n * 32);
    int64_t *idx = (int64_t *)__builtin_malloc((u64)n * sizeof(int64_t));
    if (!level || !idx) {
        __builtin_free(level);
        __builtin_free(idx);
        return -1;
    }
    memcpy(level, leaves_out, (u64)n * 32);
    for (int64_t i = 0; i < n; i++) { idx[i] = i; counts_out[i] = 0; }
    int64_t count = n;
    while (count > 1) {
        /* record each item's ancestor's sibling at this level, then halve.
         * A promoted odd tail has no sibling: no aunt at this level. */
        for (int64_t i = 0; i < n; i++) {
            int64_t sib = idx[i] ^ 1;
            if (sib < count)
                memcpy(aunts_out + (i * stride + counts_out[i]++) * 32,
                       level + 32*sib, 32);
            idx[i] >>= 1;
        }
        count = merkle_halve(level, count);
    }
    memcpy(root_out, level, 32);
    __builtin_free(level);
    __builtin_free(idx);
    return 0;
}

/* Batched multiproof: ONE call proving k sorted distinct indices against
 * the tree over n items, emitting the deduplicated shared-node set instead
 * of k aunt lists. Per level (bottom-up), each current ancestor index in
 * ascending order either pairs with its sibling inside the ancestor set
 * (shared: recomputed from the proven leaves at verify time, nothing
 * emitted) or consumes one emitted sibling node; a promoted odd tail
 * contributes nothing. Parent indices never collide outside the pair case
 * (equal idx>>1 means siblings), so the ancestor set stays strictly
 * ascending with no dedup pass.
 *
 * Outputs: root_out[32]; leaves_out k*32 (the proven leaf hashes in index
 * order); nodes_out (caller-sized to k*ceil(log2 n) slots: at most one
 * emission an ancestor a level); *n_nodes_out = the emitted count.
 * Requires n >= 1 and indices strictly ascending in [0, n) (the caller
 * validates them). */
int tm_merkle_multiproof(const uint8_t *items, const int64_t *offsets, int64_t n,
                         const int64_t *indices, int64_t k,
                         uint8_t *root_out, uint8_t *leaves_out,
                         uint8_t *nodes_out, int64_t *n_nodes_out) {
    pthread_once(&ossl_once, ossl_resolve);
    uint8_t *level = (uint8_t *)__builtin_malloc((u64)n * 32);
    int64_t *cur = (int64_t *)__builtin_malloc((u64)(k > 0 ? k : 1) * sizeof(int64_t));
    if (!level || !cur
        || sha256_batch_threaded(items, offsets, n, 1, 0x00, level)) {
        __builtin_free(level);
        __builtin_free(cur);
        return -1;
    }
    for (int64_t i = 0; i < k; i++) {
        memcpy(leaves_out + 32 * i, level + 32 * indices[i], 32);
        cur[i] = indices[i];
    }
    int64_t m = k, count = n, emitted = 0;
    while (count > 1) {
        int64_t w = 0;
        for (int64_t i = 0; i < m; ) {
            int64_t idx = cur[i];
            if ((idx & 1) == 0 && i + 1 < m && cur[i + 1] == idx + 1) {
                i += 2; /* both children proven: shared, nothing emitted */
            } else {
                int64_t sib = idx ^ 1;
                if (sib < count)
                    memcpy(nodes_out + 32 * emitted++, level + 32 * sib, 32);
                i += 1;
            }
            cur[w++] = idx >> 1;
        }
        m = w;
        count = merkle_halve(level, count);
    }
    *n_nodes_out = emitted;
    memcpy(root_out, level, 32);
    __builtin_free(level);
    __builtin_free(cur);
    return 0;
}
