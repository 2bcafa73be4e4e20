"""The single-table fills' quad-split decode (csrc/coop_decode.cuh) modelled
lane by lane and held to fe_mul and to the JAX package.

Rows 5 and 10 (csrc/pk_tables_single.cu, csrc/sr_tables_single.cu) run a
quad a key on coop.cuh's coop_fill at S = 1. Their decoders split each field
product across the quad's four lanes: lane q sums columns q, q + 4 and
q + 8 of the product from operands it selects by q (30 of fe_mul's 100
terms, 18 of a square's 55 distinct ones), the quad gathers the ten int64
columns, and every lane runs fe_mul's carry chain. The model below does
the same on ten-limb field elements in radix 2^25.5 (Python ints, batched
in numpy object arrays), lane by lane, and checks:

  - the product and the square: the gathered columns and the carried limbs
    equal the one-lane fe_mul's (csrc/fe25519.cuh) limb for limb, on random
    elements and at the contract's edges (sums of three carried elements,
    every limb at its maximum or at its minimum), with every int32 operand
    and int64 column inside its type; their value mod p equals the JAX
    field product's;
  - the quad decoders (coop_ge_decompress, coop_ristretto_decode), built
    on those products: point and decode bit equal to the JAX decompress
    (ops/curve.py) and ristretto decode (ops/ristretto.py), and limb for
    limb to the one-lane decoders on fe_mul, on edge keys (a non-square y,
    x = 0 with the sign bit set, non-canonical y; an odd s, a non-canonical
    s, a negative T, a non-square, the zero encoding);
  - the whole fill at S = 1 (test_torch_coop_lanes.fill_model with the
    quad decoder): tables and decode bits equal to the JAX build_pk_tables /
    build_sr_tables after canonicalization (the bytes the kernels write)."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tendermint_tpu.ops import curve as JC
from tendermint_tpu.ops import field as JF
from tendermint_tpu.ops import ristretto as JR
from tendermint_tpu.ops import verify as JV
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import field as F

import test_torch_coop_lanes as TCL
import test_torch_verify_sr as TVS

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "tendermint_tpu_torch" / "csrc"
P = 2**255 - 19
W = [26, 25] * 5  # limb widths
OFF = [(51 * i + 1) // 2 for i in range(10)]  # limb offsets
INT32 = 1 << 31
INT64 = 1 << 63


def _constants():
    """The ten-limb constants the kernels use, read from the CUDA headers."""
    text = (CSRC / "fe25519.cuh").read_text() + (CSRC / "ristretto.cuh").read_text()
    out = {}
    for name, body in re.findall(r"int32_t (FE_\w+)\[10\] = \{([^}]*)\}", text):
        out[name] = [int(x) for x in body.replace("\n", " ").split(",")]
    return out


CONST = _constants()


# -- ten-limb elements: lists of 10 object arrays (one Python int a key) ------


def value(f):
    """Each key's element as an int (not reduced)."""
    return [sum(int(f[i][b]) << OFF[i] for i in range(10)) for b in range(len(f[0]))]


def const(name, n):
    return [np.full(n, v, dtype=object) for v in CONST[name]]


def small(v, n):
    return [np.full(n, v if i == 0 else 0, dtype=object) for i in range(10)]


def in_int32(*limbs):
    for x in limbs:
        assert all(-INT32 <= int(v) < INT32 for v in np.atleast_1d(x)), "int32 operand overflows"


def in_int64(cols):
    for c in cols:
        assert all(-INT64 <= int(v) < INT64 for v in np.atleast_1d(c)), "int64 column overflows"


def carry_wide(cols):
    """fe_carry_wide: the rounding carry chain, limb 9's carry folded into
    limb 0 times 19, then limb 0 carried into limb 1."""
    t = list(cols)
    for i in range(9):
        c = (t[i] + (1 << (W[i] - 1))) >> W[i]
        t[i + 1] = t[i + 1] + c
        t[i] = t[i] - c * (1 << W[i])
    c = (t[9] + (1 << 24)) >> 25
    t[9] = t[9] - c * (1 << 25)
    t[0] = t[0] + c * 19
    c = (t[0] + (1 << 25)) >> 26
    t[0] = t[0] - c * (1 << 26)
    t[1] = t[1] + c
    in_int32(*t)
    return t


def fe_mul_cols(f, g):
    """fe_mul's ten columns on one lane: 2 f_i on odd-times-odd terms, 19 g_j
    on wrapped ones, both folded in int32."""
    f2 = [2 * f[i] if i & 1 else f[i] for i in range(10)]
    g19 = [19 * g[j] for j in range(10)]
    in_int32(*f, *g, *f2, *g19)
    t = [0] * 10
    for i in range(10):
        for j in range(10):
            k = i + j
            t[k % 10] = t[k % 10] + (f2[i] if i & 1 and j & 1 else f[i]) * (g19[j] if k >= 10 else g[j])
    in_int64(t)
    return t


def fe_mul(f, g):
    return carry_wide(fe_mul_cols(f, g))


def gather(partial):
    """The quad's shuffles: column k from lane k & 3, its sum number k >> 2."""
    cols = [partial[k & 3][k >> 2] for k in range(10)]
    in_int64(cols)
    return cols


def coop_mul_lanes(f, g):
    """Each lane's three partial columns of coop_fe_mul, then the gathered
    columns."""
    partial = []
    for q in range(4):
        odd, two = q & 1, q & 2
        h = [19 * g[x + 1] for x in range(9)] + [g[x] for x in range(10)] + [0, 0]
        h1 = [h[y + 1] if odd else h[y] for y in range(20)]
        s = [h1[r + 2] if two else h1[r] for r in range(18)]  # s[r + 9] = g index q + r
        a = [2 * f[i] if (i & 1) and not odd else f[i] for i in range(10)]
        in_int32(*s, *a)
        t = [sum(a[i] * s[4 * m - i + 9] for i in range(10)) for m in range(3)]
        in_int64(t)
        partial.append(t)
    return partial, gather(partial)


def coop_sq_lanes(f):
    """Each lane's three partial columns of coop_fe_sq (the 55 distinct
    terms), then the gathered columns."""
    partial = []
    for q in range(4):
        alpha, beta = (q + 1) >> 1, q >> 1
        ff = list(f) + [0, 0]
        x = [ff[u + alpha] for u in range(10)]
        yy = [19 * ff[v + 5] for v in range(5)] + [ff[v] for v in range(6)]
        y = [yy[w + beta] for w in range(10)]
        if q & 1:
            c = [2, 2, 2, 2, 2, 0]
        else:
            c = [(1 if s in (0, 5) else 2) << ((beta + s) & 1) for s in range(6)]
        cx = [[c[s] * x[2 * m + s] for s in range(6)] for m in range(3)]
        in_int32(*yy, *[v for row in cx for v in row])
        t = [sum(cx[m][s] * y[2 * m - s + 5] for s in range(6)) for m in range(3)]
        in_int64(t)
        partial.append(t)
    return partial, gather(partial)


def coop_mul(f, g):
    return carry_wide(coop_mul_lanes(f, g)[1])


def coop_sq(f):
    return carry_wide(coop_sq_lanes(f)[1])


def carried(rng, n):
    return [np.array([int(v) for v in rng.integers(-(1 << (w - 1)), 1 << (w - 1), n)], dtype=object)
            for w in W]


def add(f, g):
    return [f[i] + g[i] for i in range(10)]


def sub(f, g):
    return [f[i] - g[i] for i in range(10)]


def neg(f):
    return [-f[i] for i in range(10)]


def edge_elements():
    """Sums of three carried elements with every limb at its maximum, and
    at its minimum."""
    top = [np.array([3 * ((1 << (w - 1)) - 1)], dtype=object) for w in W]
    bottom = [np.array([-3 * (1 << (w - 1))], dtype=object) for w in W]
    return top, bottom


def cat(*elems):
    return [np.concatenate([e[i] for e in elems]) for i in range(10)]


def operand_pairs():
    rng = np.random.default_rng(101)
    n = 64
    f1, g1 = carried(rng, n), carried(rng, n)
    f3 = add(add(carried(rng, n), carried(rng, n)), carried(rng, n))
    g3 = sub(sub(carried(rng, n), carried(rng, n)), carried(rng, n))
    top, bottom = edge_elements()
    fs = cat(f1, f3, f3, top, bottom, top, bottom)
    gs = cat(g1, g3, g1, top, bottom, bottom, top)
    return fs, gs


@pytest.mark.parametrize("which", ["product", "square"])
def test_quad_split_equals_fe_mul_limb_for_limb(which):
    fs, gs = operand_pairs()
    if which == "square":
        gs = fs
        _, cols = coop_sq_lanes(fs)
    else:
        _, cols = coop_mul_lanes(fs, gs)
    want_cols = fe_mul_cols(fs, gs)
    for k in range(10):
        assert list(cols[k]) == list(want_cols[k]), f"column {k}"
    got, want = carry_wide(cols), carry_wide(want_cols)
    for i in range(10):
        assert list(got[i]) == list(want[i]), f"limb {i}"
    # the value mod p is the JAX field product's
    jf = np.stack([JF._int_to_limbs(v % P)[:, 0] for v in value(fs)], axis=1)
    jg = np.stack([JF._int_to_limbs(v % P)[:, 0] for v in value(gs)], axis=1)
    jp = np.asarray(jax.jit(JF.fe_square if which == "square" else JF.fe_mul)(
        *((jf,) if which == "square" else (jf, jg))))
    jv = [JF.limbs_to_int(jp[:, b]) % P for b in range(jp.shape[1])]
    assert [v % P for v in value(got)] == jv


def test_lanes_split_the_terms():
    """The split's index arithmetic: over the columns q, q + 4, q + 8 < 10 of
    the four lanes, the product takes each of the 100 terms (i, j) once and
    the square each of the 55 pairs i <= j once, in column (i + j) mod 10,
    with the factor 19 exactly where i + j >= 10 and the square's factor c
    equal to (2 for i != j) x (2 for odd times odd). Lanes 2 and 3 also sum
    columns 10 and 11, which the gather never reads."""
    mul_terms, sq_pairs = [], []
    for q in range(4):
        alpha, beta = (q + 1) >> 1, q >> 1
        for m in range(3):
            k = q + 4 * m
            if k > 9:
                continue
            for i in range(10):
                x = q + 4 * m - i  # the g index before it wraps
                j = x % 10
                assert (x < 0) == (i + j >= 10)
                mul_terms.append((k, i, j))
            for t in range(6):
                c = (2 if t < 5 else 0) if q & 1 else ((1 if t in (0, 5) else 2) << ((beta + t) & 1))
                if c == 0:
                    continue
                i, j_raw = alpha + 2 * m + t, beta + 2 * m - t
                j = j_raw % 10
                assert 0 <= i <= 9 and (j_raw < 0) == (i + j >= 10)
                assert c == (1 if i == j else 2) * (2 if i & 1 and j & 1 else 1)
                sq_pairs.append((k, min(i, j), max(i, j)))
    assert sorted(mul_terms) == sorted(((i + j) % 10, i, j) for i in range(10) for j in range(10))
    assert sorted(sq_pairs) == sorted(((i + j) % 10, i, j) for i in range(10) for j in range(i, 10))


# -- the decoders on the quad's products ----------------------------------------


def from_bytes(enc, mask_top: bool):
    """fe_from_limbs8 of 32-byte rows (the top bit dropped for ZIP-215's y)."""
    n = len(enc)
    t = [np.zeros(n, dtype=object) for _ in range(10)]
    for i in range(32):
        k = max(j for j in range(10) if OFF[j] <= 8 * i)
        col = np.array([(e[i] & 0x7F) if (mask_top and i == 31) else e[i] for e in enc], dtype=object)
        t[k] = t[k] + col * (1 << (8 * i - OFF[k]))
    return carry_wide(t)


def canon(f):
    return [v % P for v in value(f)]


def iszero(f):
    return np.array([v == 0 for v in canon(f)])


def parity(f):
    return np.array([v & 1 for v in canon(f)])


def carry(f):
    return carry_wide(list(f))


def select(flag, a, b):
    return [np.where(flag, a[i], b[i]) for i in range(10)]


def pow_p58(z, mul, sq):
    def sqn(f, n):
        for _ in range(n):
            f = sq(f)
        return f

    z2 = sq(z)
    z9 = mul(sqn(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sq(z11), z9)
    z_10_0 = mul(sqn(z_5_0, 5), z_5_0)
    z_20_0 = mul(sqn(z_10_0, 10), z_10_0)
    t = mul(sqn(z_20_0, 20), z_20_0)
    z_50_0 = mul(sqn(t, 10), z_10_0)
    z_100_0 = mul(sqn(z_50_0, 50), z_50_0)
    t = mul(sqn(z_100_0, 100), z_100_0)
    t = mul(sqn(t, 50), z_50_0)
    return mul(sqn(t, 2), z)


def decompress(enc, mul, sq):
    """ge_decompress / coop_ge_decompress (ZIP-215): the point (X, Y, Z, T)
    and the decode bit."""
    n = len(enc)
    sign = np.array([e[31] >> 7 for e in enc])
    y = from_bytes(enc, mask_top=True)
    one = small(1, n)
    yy = sq(y)
    u = sub(yy, one)
    v = add(mul(yy, const("FE_D", n)), one)
    v3 = mul(sq(v), v)
    v7 = mul(sq(v3), v)
    t = pow_p58(mul(u, v7), mul, sq)
    x = mul(mul(u, v3), t)
    vxx = mul(v, sq(x))
    is_root = iszero(sub(vxx, u))
    is_neg_root = iszero(add(vxx, u))
    x = select(is_root, x, mul(x, const("FE_SQRTM1", n)))  # both run in the quad
    x = carry(x)
    x = select(parity(x) != sign, neg(x), x)
    X, Y = carry(x), carry(y)
    return (X, Y, one, mul(X, Y)), is_root | is_neg_root


def fe_abs(f):
    c = carry(f)
    return select(parity(c) == 1, neg(c), c)


def sqrt_ratio_m1(u, v, mul, sq):
    n = len(u[0])
    v3 = mul(sq(v), v)
    v7 = mul(sq(v3), v)
    r = mul(mul(u, v3), pow_p58(mul(u, v7), mul, sq))
    check = mul(v, sq(r))
    correct = iszero(sub(check, u))
    flipped = iszero(add(check, u))
    flipped_i = iszero(add(check, mul(u, const("FE_SQRTM1", n))))
    r = select(flipped | flipped_i, mul(r, const("FE_SQRTM1", n)), r)
    return fe_abs(r), correct | flipped


def ristretto_decode(enc, mul, sq):
    """ristretto_decode / coop_ristretto_decode: the point and the decode
    bit."""
    n = len(enc)
    s = from_bytes(enc, mask_top=False)
    canonical = np.array([v.to_bytes(32, "little") == bytes(e) for v, e in zip(canon(s), enc)])
    even = np.array([(e[0] & 1) == 0 for e in enc])
    one = small(1, n)
    ss = sq(s)
    u1, u2 = sub(one, ss), add(one, ss)
    u2_sqr = sq(u2)
    v = sub(neg(mul(mul(u1, const("FE_D", n)), u1)), u2_sqr)
    invsqrt, was_square = sqrt_ratio_m1(one, mul(v, u2_sqr), mul, sq)
    den_x = mul(invsqrt, u2)
    den_y = mul(mul(invsqrt, den_x), v)
    X = fe_abs(mul(add(s, s), den_x))
    Y = mul(u1, den_y)
    T = mul(X, Y)
    ok = canonical & even & was_square & (parity(T) == 0) & ~iszero(Y)
    return (X, Y, one, T), ok


def _non_square_y():
    y = 2
    while ref.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    return y.to_bytes(32, "little")


def ed_edge_keys():
    """(label, encoding): honest keys, small-order keys, and ZIP-215's edges."""
    rng = np.random.default_rng(29)
    keys = [("honest", ref.gen_privkey(rng.bytes(32))[32:]) for _ in range(4)]
    keys += [("small order", e) for e in ref.small_order_points()[:4]]
    keys.append(("non-square y", _non_square_y()))
    neg_zero = bytearray(ref.compress(ref.IDENTITY))
    neg_zero[31] |= 0x80
    keys.append(("x = 0 with the sign bit", bytes(neg_zero)))
    keys += [(f"non-canonical y = p + {k}", (ref.P + k).to_bytes(32, "little")) for k in (0, 1, 2)]
    keys.append(("y = 2^255 - 1", ((1 << 255) - 1).to_bytes(32, "little")))
    keys += [("random", rng.bytes(32)) for _ in range(4)]
    return keys


def sr_edge_keys():
    """(label, encoding): honest keys and R values, RFC 9496's bad
    encodings, and the zero encoding."""
    from tendermint_tpu_torch.crypto import sr25519 as sr

    rng = np.random.default_rng(31)
    keys = []
    for _ in range(3):
        priv = sr.Sr25519PrivKey(rng.bytes(32))
        keys.append(("honest", priv.pub_key().bytes()))
        keys.append(("honest R", priv.sign(b"m")[:32]))
    keys.append(("zero", bytes(32)))
    # RFC 9496 A.2's sections: non-canonical s (0-3), negative (odd) s
    # (4-6), a non-square x^2 (7, 8), a negative xy (9), s = -1 (10)
    bad = chip_smoke.RISTRETTO_BAD_ENCODINGS
    keys += [("non-canonical s", bytes.fromhex(e)) for e in bad[0:3]]
    keys.append(("non-canonical s = p", bytes.fromhex(bad[3])))
    keys += [("odd s", bytes.fromhex(e)) for e in bad[4:7]]
    keys += [("non-square", bytes.fromhex(e)) for e in bad[7:9]]
    keys.append(("negative T", bytes.fromhex(bad[9])))
    keys.append(("y = 0", bytes.fromhex(bad[10])))
    keys.append(("bad", bytes.fromhex(bad[11])))
    keys += [("random", rng.bytes(32)) for _ in range(3)]
    return keys


def _jax_point(jax_fn, encs):
    a = np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32).T.astype(np.int32)
    pt, ok = jax.jit(jax_fn)(a)
    pt = np.asarray(pt)
    return [[JF.limbs_to_int(pt[c, :, b]) % P for b in range(pt.shape[2])] for c in range(4)], np.asarray(ok)


@pytest.mark.parametrize("plane", ["ed25519", "sr25519"])
def test_quad_decoder_matches_jax_and_one_lane(plane):
    keys = ed_edge_keys() if plane == "ed25519" else sr_edge_keys()
    labels, encs = zip(*keys)
    decode = decompress if plane == "ed25519" else ristretto_decode
    jax_fn = (lambda a: JC.decompress(a, zip215=True)) if plane == "ed25519" else JR.decode
    quad_pt, quad_ok = decode(list(encs), coop_mul, coop_sq)
    lane_pt, lane_ok = decode(list(encs), fe_mul, lambda f: fe_mul(f, f))
    for c in range(4):
        for i in range(10):
            assert list(quad_pt[c][i]) == list(lane_pt[c][i]), f"coordinate {c} limb {i}"
    np.testing.assert_array_equal(quad_ok, lane_ok)
    want_pt, want_ok = _jax_point(jax_fn, encs)
    np.testing.assert_array_equal(quad_ok, want_ok)
    for c in range(4):
        assert canon(quad_pt[c]) == want_pt[c], f"coordinate {c}"
    ok = dict(zip(labels, quad_ok))
    x0 = dict(zip(labels, canon(quad_pt[0])))
    if plane == "ed25519":
        assert not ok["non-square y"]
        assert ok["x = 0 with the sign bit"] and x0["x = 0 with the sign bit"] == 0
        assert ok["non-canonical y = p + 1"] and ok["non-canonical y = p + 0"]
    else:
        for label in ("odd s", "non-canonical s", "non-canonical s = p", "non-square", "negative T",
                      "y = 0"):
            assert not ok[label], label
        assert ok["honest"] and ok["honest R"] and ok["zero"]


# -- the whole fill at S = 1 -------------------------------------------------------


def quad_decoder(decode):
    """A fill_model decoder: (32, B) byte limbs -> ((4, 32, B) point in the
    plain versions' limbs, (B,) decode bits), by the quad-split decode."""

    def run(a_limbs):
        encs = [bytes(a_limbs[:, b].tolist()) for b in range(a_limbs.shape[1])]
        pt, ok = decode(encs, coop_mul, coop_sq)
        limbs = [torch.from_numpy(np.stack([JF._int_to_limbs(v)[:, 0] for v in canon(c)], axis=1))
                 for c in pt]
        return torch.stack(limbs), torch.from_numpy(ok)

    return run


def _jax_tables(jt):
    jt = torch.from_numpy(np.asarray(jt).astype(np.int32))
    return F.fe_canonical(jt.movedim(-1, 0)).movedim(0, -1).to(torch.int16)


@pytest.mark.parametrize("plane", ["ed25519", "sr25519"])
def test_quad_fill_matches_jax_single_table(plane):
    if plane == "ed25519":
        pks, _, _ = chip_smoke.edge_batch(np.random.default_rng(73), 12)
        a = np.frombuffer(b"".join(pks), np.uint8).reshape(-1, 32)
        jt, jo = jax.jit(JV.build_pk_tables_impl)(a)
        decoder = quad_decoder(decompress)
    else:
        a, *_ = JVS.prepare_batch(*TVS.edge_jobs())
        a = np.array(a)
        jt, jo = jax.jit(JVS.build_sr_tables_impl)(a)
        decoder = quad_decoder(ristretto_decode)
    got, ok = TCL.fill_model(torch.from_numpy(a.copy()), 1, decode=decoder)
    assert tuple(got.shape) == (len(a), 1, 16, 4, 32)
    assert torch.equal(got[:, 0], _jax_tables(jt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jo))
    assert not ok.all()
