"""The four-lane cooperative designs (csrc/coop.cuh) modelled in plain
PyTorch and held to the JAX package.

A quad is four lanes; lane q holds coordinate q (X, Y, Z, T) of a point.
The model runs the kernels' round split lane by lane: coop_dbl in two
rounds (one squaring a lane, then one product a lane), coop_add in three
(one product a lane, the 2d product on lane 2, one product a lane), with
the addend read from memory (coop_add) or held by the quad (coop_add_reg),
every exchange an explicit shuffle between lanes. Each result must equal
C.point_double / C.point_add coordinate for coordinate modulo p (T
included), so projectively too.

On top of those operations:
  - row 12's fill (csrc/sr_tables.cu, coop_write_power_tables) as the
    kernel runs it: decode, negate, per power c >= 1 256/S quad doublings,
    then entries 0, P, P + P and 13 more register additions of P, each
    coordinate canonicalized by its lane; the tables must equal the JAX
    build_sr_tables_split's after canonicalization (the bytes the kernel
    writes) at S = 2, 4 and 8, and at S = 1 (row 10, csrc/sr_tables_single.cu,
    the same body) the JAX build_sr_tables's, and the decode bits must
    equal (test_torch_fill_quads.py models row 10's quad-split decode);
  - row 1's two-step schedule (csrc/verify.cu): step 1 decodes A and R and
    stores -A and -R; step 2 builds -A's multiples 0, 2, ..., 15 by quad
    register additions, runs the quad ladder, 63 windows of 4 doublings,
    B's entry and -A's entry, then adds -R, clears the cofactor with 3
    doublings and tests the identity. Its bitmap must
    equal the JAX verify_kernel's on chip_smoke.edge_batch's rows (the
    ZIP-215 edges: small-order, undecodable and non-canonical R, R plus a
    point of order 8, small-order keys, s >= L, a key that does not
    decode) and on a row whose k is tampered after the host prep;
  - row 2's fill (csrc/pk_tables.cu): row 12's schedule with ZIP-215
    decoding (the kernels share coop_fill and differ only in the decoder);
    its tables must equal the JAX build_pk_tables_split's after
    canonicalization at S = 2, 4 and 8 on chip_smoke.edge_batch's keys
    (small-order, y >= p, x = 0 with the sign bit, a non-point), at S = 1
    (row 5, csrc/pk_tables_single.cu) the JAX build_pk_tables's, and the
    decode bits must equal;
  - row 9's two-step schedule (csrc/verify_sr.cu): step 1 ristretto-decodes
    A and R and stores -A and R; step 2 runs row 1's quad ladder
    (coop_straus_base) and decides okA, okR and ristretto_equal(R, Q) on
    Q's X and Y from lanes 0 and 1. Its bitmap must equal the JAX
    verify_sr_kernel's (encode(Q) == R) on chip_smoke.sr_edge_batch's rows
    (RFC 9496's bad encodings as keys and as R, a missing marker bit,
    s >= L, an honest R made non-canonical, negated and random, the zero
    row) and on a row whose k is tampered after the host prep."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tendermint_tpu.ops import verify as JV
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.ops import curve as C
from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import ristretto as R
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS

import test_torch_verify_sr as TVS
from test_torch_split_lanes import ristretto_equal

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def _c(x):
    """One carry pass: keeps sums inside fe_mul's limb bound (mod p the
    same value)."""
    return F.fe_carry(x, passes=1)


def shfl(lanes, src):
    """Lane q reads lane src(q)'s value (__shfl_sync of width 4)."""
    return [lanes[src(q)] for q in range(4)]


def pick(q, *args):
    return args[q]


def coop_dbl(mine):
    """coordinate q of 2P on lane q: the four lanes' results."""
    x, y = shfl(mine, lambda q: 0), shfl(mine, lambda q: 1)
    h = [_c(x[q] + y[q]) for q in range(4)]
    # round 1: X^2, Y^2, Z^2, (X+Y)^2, one a lane; lane 2 doubles its own
    s = [F.fe_square(pick(q, x[q], y[q], mine[q], h[q])) for q in range(4)]
    s[2] = _c(s[2] + s[2])
    a, b, c, d = (shfl(s, lambda q, j=j: j) for j in range(4))
    e = [_c(d[q] - a[q] - b[q]) for q in range(4)]
    g = [_c(b[q] - a[q]) for q in range(4)]
    f = [_c(g[q] - c[q]) for q in range(4)]
    hh = [_c(-(a[q] + b[q])) for q in range(4)]
    # round 2: X3 = EF, Y3 = GH, Z3 = FG, T3 = EH
    return [F.fe_mul(pick(q, e[q], g[q], f[q], e[q]), pick(q, f[q], hh[q], g[q], hh[q]))
            for q in range(4)]


def coop_add_xyw(mine, qx, qy, qw):
    """coordinate q of P + Q on lane q, given each lane's copy of Q's X and
    Y and its w (Q's T on lane 2, Q's Z on the others)."""
    partner = shfl(mine, lambda q: q ^ 1)
    f1 = [_c(partner[0] - mine[0]), _c(mine[1] + partner[1]), partner[2], partner[3]]
    f2 = [_c(qy[0] - qx[0]), _c(qy[1] + qx[1]), qw[2], qw[3]]
    r = [F.fe_mul(f1[q], f2[q]) for q in range(4)]  # round 1: A, B, T1 T2, Z1 Z2
    r[2] = F.fe_mul_const(r[2], F.D2_LIMBS)  # round 2, lane 2: C
    r[3] = _c(r[3] + r[3])  # D
    a, b, c, d = (shfl(r, lambda q, j=j: j) for j in range(4))
    e = [_c(b[q] - a[q]) for q in range(4)]
    f = [_c(d[q] - c[q]) for q in range(4)]
    g = [_c(d[q] + c[q]) for q in range(4)]
    h = [_c(b[q] + a[q]) for q in range(4)]
    # round 3: X3 = EF, Y3 = GH, Z3 = FG, T3 = EH
    return [F.fe_mul(pick(q, e[q], g[q], f[q], e[q]), pick(q, f[q], h[q], g[q], h[q]))
            for q in range(4)]


def coop_add(mine, point):
    """The addend Q a point (4, 32, B) in memory: each lane loads Q's X, Y
    and its w."""
    return coop_add_xyw(mine, [point[0]] * 4, [point[1]] * 4,
                        [point[3] if q == 2 else point[2] for q in range(4)])


def coop_add_reg(mine, theirs):
    """The addend held by the quad as P is: X, Y and w by shuffles."""
    return coop_add_xyw(mine, shfl(theirs, lambda q: 0), shfl(theirs, lambda q: 1),
                        shfl(theirs, lambda q: 3 if q == 2 else 2))


def lanes(p):
    return [p[q] for q in range(4)]


def canonical(p):
    return torch.stack([F.fe_canonical(c) for c in p])


def _scale(p, lam: int):
    """The same point under another projective representative."""
    lam_limbs = F._int_to_limbs(lam % F.P_INT)
    return torch.stack([F.fe_mul_const(p[q], lam_limbs) for q in range(4)])


@pytest.fixture(scope="module")
def points():
    """(P, Q) columns: random multiples of B, the identity, small-order
    points, Q = P and Q = -P, each coordinate scaled by a random factor."""
    rng = np.random.default_rng(71)
    encs_p, encs_q = [], []
    so = ref.small_order_points()
    for i in range(8):
        x = int.from_bytes(rng.bytes(32), "little") % ref.L
        y = int.from_bytes(rng.bytes(32), "little") % ref.L
        encs_p.append(ref.compress(ref.scalar_mult(x, ref.BASE)))
        encs_q.append(ref.compress(ref.scalar_mult(y, ref.BASE)))
    encs_p += [ref.compress(ref.IDENTITY), so[2], so[3], encs_p[0], encs_p[1]]
    encs_q += [encs_q[0], so[4], encs_q[1], encs_p[0], so[1]]
    to_limbs = lambda encs: torch.from_numpy(
        np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32).T.astype(np.int32))
    p, ok_p = C.decompress(to_limbs(encs_p))
    q, ok_q = C.decompress(to_limbs(encs_q))
    assert bool(ok_p.all()) and bool(ok_q.all())
    q[..., -1] = C.point_neg(p[..., -1:])[..., 0]  # Q = -P in the last column
    return _scale(p, 0x1234567), _scale(q, 0xBEEF)


def test_coop_dbl_equals_point_double(points):
    p, _ = points
    got = torch.stack(coop_dbl(lanes(p)))
    want = C.point_double(p, out_t=True)
    assert torch.equal(canonical(got), canonical(want))
    assert bool(C.point_equal(got, want).all())


@pytest.mark.parametrize("addend", ["memory", "register"])
def test_coop_add_equals_point_add(points, addend):
    p, q = points
    got = coop_add(lanes(p), q) if addend == "memory" else coop_add_reg(lanes(p), lanes(q))
    got = torch.stack(got)
    want = C.point_add(p, q, out_t=True)
    assert torch.equal(canonical(got), canonical(want))
    assert bool(C.point_equal(got, want).all())


# -- row 12: the sr25519 split fill --------------------------------------------


def fill_model(a_enc, splits, decode=R.decode):
    """(B, S, 16, 4, 32) int16 canonical tables and (B,) decode bits, as
    build_sr_tables (csrc/sr_tables.cu) computes and writes them, or, with
    decode=C.decompress, build_tables (csrc/pk_tables.cu)."""
    a_pt, ok = decode(V._limb_major(a_enc))
    neg = C.point_neg(a_pt)
    p = lanes(neg)
    ident = lanes(C.identity_point(a_pt.shape[2:]))
    chunks = []
    for c in range(splits):
        if c > 0:
            for _ in range(256 // splits):
                p = coop_dbl(p)
        acc = coop_add_reg(p, p)
        entries = [ident, p, acc]
        for _ in range(13):
            acc = coop_add_reg(acc, p)
            entries.append(acc)
        # each lane canonicalizes and writes its own coordinate
        chunks.append(torch.stack([torch.stack([F.fe_canonical(e[q]) for q in range(4)])
                                   for e in entries]))
    tabs = torch.stack(chunks)  # (S, 16, 4, 32, B)
    return tabs.permute(4, 0, 1, 2, 3).to(torch.int16).contiguous(), ok


def _jax_fill(monkeypatch, single, split, a, splits):
    """The JAX fill's tables, canonicalized, as (B, S, 16, 4, 32) int16, and
    its decode bits: at S = 1 the single-table program (row 5's or row
    10's), else the split program at PK_SPLITS = S."""
    if splits == 1:
        jt, jo = jax.jit(single)(a)
        jt = jt[:, None]
    else:
        monkeypatch.setattr(JV, "PK_SPLITS", splits)
        jt, jo = jax.jit(lambda x: split(x))(a)
    jt = torch.from_numpy(np.asarray(jt).astype(np.int32))
    return F.fe_canonical(jt.movedim(-1, 0)).movedim(0, -1).to(torch.int16), jo


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_sr_fill_model_matches_jax(monkeypatch, splits):
    a, *_ = JVS.prepare_batch(*TVS.edge_jobs())
    want, jo = _jax_fill(monkeypatch, JVS.build_sr_tables_impl, JVS.build_sr_tables_split_impl,
                         a, splits)
    got, ok = fill_model(torch.from_numpy(np.array(a)), splits)
    assert tuple(got.shape) == (8, splits, 16, 4, 32)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jo))


# -- row 2: the ed25519 split fill --------------------------------------------------


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_pk_fill_model_matches_jax(monkeypatch, splits):
    pks, _, _ = chip_smoke.edge_batch(np.random.default_rng(73), 12)
    a = np.frombuffer(b"".join(pks), np.uint8).reshape(-1, 32)
    want, jo = _jax_fill(monkeypatch, JV.build_pk_tables_impl, JV.build_pk_tables_split_impl, a,
                         splits)
    got, ok = fill_model(torch.from_numpy(a.copy()), splits, decode=C.decompress)
    assert tuple(got.shape) == (12, splits, 16, 4, 32)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jo))
    assert not ok.all()  # the non-point key


# -- rows 1 and 9: the uncached bitmaps -------------------------------------------


def quad_ladder(neg_a, s_bytes, k_bytes):
    """The quads' [s]B + [k]A' (coop_straus_base): -A's multiples 0, 2, ...,
    15 by register additions, each lane its coordinate, then 63 windows of
    4 doublings, B's entry and A''s entry; the four lanes' coordinates."""
    n = neg_a[0].shape[-1]
    entries = [lanes(C.identity_point((n,))), neg_a]
    acc = neg_a
    for _ in range(14):
        acc = coop_add_reg(acc, neg_a)
        entries.append(acc)
    a_tab = torch.stack([torch.stack(e) for e in entries])  # (16, 4, 32, B)
    nib_s = C.scalar_to_nibbles(V._limb_major(s_bytes))
    nib_k = C.scalar_to_nibbles(V._limb_major(k_bytes))
    base = torch.as_tensor(C.base_table())[..., None]  # (16, 4, 32, 1)
    mine = lanes(C._select16(base, nib_s[63]))
    mine = coop_add(mine, C._select16(a_tab, nib_k[63]))
    for w in range(62, -1, -1):
        for _ in range(4):
            mine = coop_dbl(mine)
        mine = coop_add(mine, C._select16(base, nib_s[w]))
        mine = coop_add(mine, C._select16(a_tab, nib_k[w]))
    return mine


def verify_model(a_enc, r_enc, s_bytes, k_bytes):
    """(B,) bool: csrc/verify.cu's two steps on (B, 32) uint8 rows."""
    a, r = V._limb_major(a_enc), V._limb_major(r_enc)
    n = a.shape[1]
    # step 1: one thread a point of -A | R
    pts, oks = C.decompress(torch.cat([a, r], dim=1))
    neg_a = lanes(C.point_neg(pts[..., :n]))
    neg_r = C.point_neg(pts[..., n:])
    # step 2: a quad a row
    mine = quad_ladder(neg_a, s_bytes, k_bytes)
    mine = coop_add(mine, neg_r)
    for _ in range(3):
        mine = coop_dbl(mine)
    identity = F.fe_is_zero(mine[0]) & F.fe_is_zero(F.fe_sub(mine[1], mine[2]))
    return oks[:n] & oks[n:] & identity


def test_verify_model_matches_jax_on_edge_rows():
    rng = np.random.default_rng(72)
    pks, msgs, sigs = chip_smoke.edge_batch(rng, 24)
    oracle = [ref.verify(*j) for j in zip(pks, msgs, sigs)]
    a, r, s, k, pre = V.prepare_batch(pks, msgs, sigs)
    tampered_k = next(i for i in range(len(sigs)) if oracle[i])
    k = k.copy()
    k[tampered_k, 5] ^= 0x10
    rows = V.pad_pow2_rows([a, r, s, k], len(sigs))
    want = np.asarray(JV.verify_kernel(*rows))
    got = verify_model(*(torch.from_numpy(np.array(x)) for x in rows))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = list(oracle)
    expect[tampered_k] = False
    assert (got.numpy()[:len(sigs)] & pre).tolist() == expect


def verify_sr_model(a_enc, r_enc, s_bytes, k_bytes):
    """(B,) bool: csrc/verify_sr.cu's two steps on (B, 32) uint8 rows."""
    a, r = V._limb_major(a_enc), V._limb_major(r_enc)
    n = a.shape[1]
    # step 1: one thread a point of A | R, -A stored, R as decoded
    pts, oks = R.decode(torch.cat([a, r], dim=1))
    neg_a = lanes(C.point_neg(pts[..., :n]))
    r_pt = pts[..., n:]
    # step 2: a quad a row; lane 0 decides on Q's X and Y from lanes 0, 1
    mine = quad_ladder(neg_a, s_bytes, k_bytes)
    return oks[:n] & oks[n:] & ristretto_equal(r_pt, mine[:2])


def test_verify_sr_model_matches_jax_on_edge_rows():
    rng = np.random.default_rng(74)
    pks, msgs, sigs = chip_smoke.sr_edge_batch(rng, 30)
    oracle = [tsr.verify(*j) for j in zip(pks, msgs, sigs)]
    a, r, s, k, pre = VS.prepare_batch(pks, msgs, sigs)
    tampered_k, h = [i for i in range(len(sigs)) if oracle[i]][:2]
    k = k.copy()
    k[tampered_k, 5] ^= 0x10
    # row h's R made odd (p - R) and non-canonical (R + p) after the host
    # prep, so k stays R's: decode rejects both, though the odd encoding's
    # candidate is R's point, so only R's decode bit makes that row false
    r_int = int.from_bytes(r[h].tobytes(), "little")
    bad_r = [(tsr.P - r_int).to_bytes(32, "little"), (r_int + tsr.P).to_bytes(32, "little")]
    a, s, k = (np.concatenate([x, x[[h, h]]]) for x in (a, s, k))
    r = np.concatenate([r, np.frombuffer(b"".join(bad_r), np.uint8).reshape(2, 32)])
    n = len(a)
    rows = V.pad_pow2_rows([a, r, s, k], n)
    want = np.asarray(JVS.verify_sr_kernel(*rows))
    got = verify_sr_model(*(torch.from_numpy(np.array(x)) for x in rows))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = list(oracle) + [False, False]
    expect[tampered_k] = False
    assert (got.numpy()[:n] & np.concatenate([pre, pre[[h, h]]])).tolist() == expect
