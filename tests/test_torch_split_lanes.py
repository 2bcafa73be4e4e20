"""The split cache hits' lane-parallel design (kernels 3 and 13,
csrc/ladder.cuh ge_split_lanes) modelled in plain PyTorch and held to the
JAX package at 12 rows, for S = 2, 4 and 8 on both signature planes.

The model sums in the kernel's order: per row, 2 S lanes each run a Horner
chain of 64/S windows (lane c < S over comb row per c with s's chunk c,
lane S + c over the cache entry's power table c with k's chunk c), then a
butterfly tree over the lanes adds lane i and lane i ^ off for off = 1, 2,
..., S. Its point must equal C.double_scalar_mul_split's projectively, and
its bitmap (the cofactored equality for ed25519; decode(R) and the RFC 9496
equality for sr25519) must equal the JAX programs' exactly, on rows with a
tampered s and k, a small-order R, a non-canonical R, R plus a point of
order 8, an R that does not decode, a slot past the end of the cache (the
gather clamps it) and a slot whose oks is false.

The sr25519 decision the kernel takes, decode(R) ok and
ristretto_equal(decode(R), Q), must equal encode(Q) == R (the JAX
package's R.encode comparison) on RFC 9496's bad encodings, Q's encoding
made non-canonical, -Q, the identity and random bytes."""

import jax
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ristretto as JR
from tendermint_tpu.ops import verify as JV
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.ops import curve as C
from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import ristretto as R
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS

from test_torch_sr25519 import BAD_ENCODINGS

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

SPLITS = (2, 4, 8)
CAPACITY = 16
# rows -> slots of a 16-slot cache (row 8's slot is past the end)
SLOTS = np.array([3, 0, 7, 12, 5, 9, 14, 1, CAPACITY + 3, 10, 6, 2], np.int32)
OKS_FALSE_ROW = 9  # its slot's oks is cleared
TAMPERED_K_ROW = 1


def _tamper(sig: bytes, at: int = 40) -> bytes:
    return sig[:at] + bytes([sig[at] ^ 0x01]) + sig[at + 1:]


def ed_jobs():
    """12 ed25519 rows: honest (0, 1, 9, 10, 11; row 1's k is tampered
    after the host prep, row 9's slot has oks false), tampered s (2), a
    small-order R (3), a non-canonical R over a small-order key with s = 0
    (4, valid), R = [r]B plus a point of order 8 (5, valid), an R that does
    not decode (6), a small-order key with the identity R (7, valid), and
    an honest row whose slot is past the end of the cache (8)."""
    rng = np.random.default_rng(61)
    privs = [ref.gen_privkey(rng.bytes(32)) for _ in range(12)]
    msgs = [b"lanes-%d" % i + rng.bytes(8) for i in range(12)]
    pks = [p[32:] for p in privs]
    sigs = [ref.sign(p, m) for p, m in zip(privs, msgs)]
    so = ref.small_order_points()
    sigs[2] = _tamper(sigs[2])
    sigs[3] = so[2] + sigs[3][32:]
    pks[4], sigs[4] = so[1], (ref.P + 1).to_bytes(32, "little") + bytes(32)
    t8 = next(p for p in map(ref.decompress, so) if not ref.point_is_identity(ref.scalar_mult(4, p)))
    a = ref._clamp(ref._sha512(privs[5][:32]))
    r = int.from_bytes(rng.bytes(64), "little") % ref.L
    r_enc = ref.compress(ref.point_add(ref.scalar_mult(r, ref.BASE), t8))
    sigs[5] = r_enc + ((r + ref.challenge_scalar(r_enc, pks[5], msgs[5]) * a) % ref.L).to_bytes(32, "little")
    y = 2
    while ref.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    sigs[6] = y.to_bytes(32, "little") + sigs[6][32:]
    pks[7], sigs[7] = so[3], ref.compress(ref.IDENTITY) + bytes(32)
    return pks, msgs, sigs


def sr_jobs():
    """12 sr25519 rows: honest (0, 1, 9, 10, 11, as above), tampered s (2),
    an R that does not decode (3, RFC 9496), row 0's R made non-canonical
    (4), row 0's R negated (5), random bytes as R (6), the zero row
    (identity key and R, s = 0: valid, 7), and a slot past the end (8)."""
    rng = np.random.default_rng(62)
    privs = [tsr.Sr25519PrivKey(rng.bytes(32)) for _ in range(12)]
    msgs = [b"sr-lanes-%d" % i + rng.bytes(8) for i in range(12)]
    pks = [p.pub_key().bytes() for p in privs]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[2] = _tamper(sigs[2])
    sigs[3] = bytes.fromhex(BAD_ENCODINGS[9]) + sigs[3][32:]
    r0 = sigs[0][:32]
    for i, r_bad in ((4, (int.from_bytes(r0, "little") + tsr.P).to_bytes(32, "little")),
                     (5, tsr.ristretto_encode(tsr.point_neg(tsr.ristretto_decode(r0)))),
                     (6, rng.bytes(32))):
        pks[i], msgs[i], sigs[i] = pks[0], msgs[0], r_bad + sigs[0][32:]
    pks[7], msgs[7], sigs[7] = bytes(32), b"zero", bytes(63) + b"\x80"
    return pks, msgs, sigs


ED_ORACLE = [True, True, False, False, True, True, False, True, True, True, True, True]
SR_ORACLE = [True, True, False, False, False, False, False, True, True, True, True, True]
PLANES = {
    "ed25519": (ed_jobs, V.prepare_batch, V.build_pk_tables_split_plain, JV,
                JV.verify_kernel_cached_split_impl, ED_ORACLE),
    "sr25519": (sr_jobs, VS.prepare_batch, VS.build_sr_tables_split_plain, JVS,
                JVS.verify_sr_kernel_cached_split_impl, SR_ORACLE),
}


def ristretto_equal(p, q):
    """RFC 9496 section 4.5: X1 Y2 == Y1 X2 or Y1 Y2 == X1 X2 (the kernels'
    ristretto_equal, csrc/ristretto.cuh)."""
    xy = F.fe_eq(F.fe_mul(p[0], q[1]), F.fe_mul(p[1], q[0]))
    yy = F.fe_eq(F.fe_mul(p[1], q[1]), F.fe_mul(p[0], q[0]))
    return xy | yy


def lane_model(s_bytes, k_bytes, a_tables, splits):
    """[s]B + [k]A' of each row summed in the kernel's order: (4, 32, B).
    s_bytes, k_bytes (32, B); a_tables (S, 16, 4, 32, B), the rows' cache
    entries. All 2 S lanes of all rows run as one batch of 2 S B columns."""
    per = 64 // splits
    b = s_bytes.shape[1]
    nibs_s, nibs_k = C.scalar_to_nibbles(s_bytes), C.scalar_to_nibbles(k_bytes)
    comb = torch.as_tensor(C.fixed_base_table())
    tables = torch.cat([comb[per * c][..., None].expand(16, 4, 32, b) for c in range(splits)]
                       + [a_tables[c] for c in range(splits)], dim=-1)
    nibs = torch.cat([nibs_s[per * c:per * (c + 1)] for c in range(splits)]
                     + [nibs_k[per * c:per * (c + 1)] for c in range(splits)], dim=-1)
    acc = C._select16(tables, nibs[per - 1])
    for w in range(per - 2, -1, -1):
        for last in (False, False, False, True):
            acc = C.point_double(acc, out_t=last)
        acc = C.point_add(acc, C._select16(tables, nibs[w]), out_t=w == 0)
    lanes = list(acc.split(b, dim=-1))
    off = 1
    while off < 2 * splits:
        lanes = [C.point_add(lanes[i], lanes[i ^ off], out_t=off < splits) for i in range(2 * splits)]
        off *= 2
    return lanes[0]


def lane_model_bitmap(plane, tables, oks, slots, r_enc, s_bytes, k_bytes):
    """The kernel's bitmap from the lane model: slots clamped into the
    cache, oks[slot] and R's decode bit gating the decision."""
    slots = slots.clamp(0, tables.shape[0] - 1)
    r = V._limb_major(r_enc)
    s, k = V._limb_major(s_bytes), V._limb_major(k_bytes)
    q = lane_model(s, k, V._cached_a_tables(tables, slots), tables.shape[1])
    if plane == "ed25519":
        r_pt, r_ok = C.decompress(r)
        return V._cofactored_accept(q, r_pt, oks[slots.long()], r_ok, r.shape[1]), q
    r_pt, r_ok = R.decode(r)
    return oks[slots.long()] & r_ok & ristretto_equal(r_pt, q), q


@pytest.fixture(scope="module", params=list(PLANES))
def batch(request):
    """A plane's rows and a 16-slot cache holding its keys' entries at each
    split, row 1's k tampered and row 9's oks cleared."""
    plane = request.param
    jobs_fn, prepare, fill, *_, oracle = PLANES[plane]
    jobs = jobs_fn()
    a, r, s, k, pre = prepare(*jobs)
    assert [tsr.verify(*j) if plane == "sr25519" else ref.verify(*j) for j in zip(*jobs)] == oracle
    k = k.copy()
    k[TAMPERED_K_ROW, 3] ^= 0x20
    caches = {}
    for splits in SPLITS:
        tabs, ok = fill(torch.from_numpy(a), splits)
        t = np.zeros((CAPACITY,) + tuple(tabs.shape[1:]), np.int16)
        o = np.zeros((CAPACITY,), bool)
        t[SLOTS.clip(0, CAPACITY - 1)], o[SLOTS.clip(0, CAPACITY - 1)] = tabs.numpy(), ok.numpy()
        o[SLOTS[OKS_FALSE_ROW]] = False
        caches[splits] = t, o
    return plane, (r, s, k, pre), caches


@pytest.mark.parametrize("splits", SPLITS)
def test_lane_model_point_equals_split_ladder(batch, splits):
    plane, (r, s, k, _), caches = batch
    tables, _ = caches[splits]
    slots = torch.from_numpy(SLOTS).clamp(0, CAPACITY - 1)
    s_t, k_t = V._limb_major(torch.from_numpy(s)), V._limb_major(torch.from_numpy(k))
    a_tabs = V._cached_a_tables(torch.from_numpy(tables), slots)
    got = lane_model(s_t, k_t, a_tabs, splits)
    want = C.double_scalar_mul_split(s_t, k_t, a_tabs, splits=splits)
    assert C.point_equal(got, want).all()


def _jit_fresh(body):
    """A new jax.jit of a new function: traces the body now, reading the
    module globals (PK_SPLITS) as they are."""
    return jax.jit(lambda *args: body(*args))


@pytest.mark.parametrize("splits", SPLITS)
def test_lane_model_bitmap_matches_jax(batch, monkeypatch, splits):
    plane, (r, s, k, pre), caches = batch
    *_, jmod, jhit_impl, oracle = PLANES[plane]
    tables, oks = caches[splits]
    monkeypatch.setattr(JV, "PK_SPLITS", splits)
    want = np.asarray(_jit_fresh(jhit_impl)(tables, oks, SLOTS, r, s, k))
    got, _ = lane_model_bitmap(plane, *(torch.from_numpy(np.array(x)) for x in (tables, oks, SLOTS, r, s, k)))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = list(oracle)
    expect[TAMPERED_K_ROW] = expect[OKS_FALSE_ROW] = False
    assert (got.numpy() & pre).tolist() == expect


def _limbs(encs):
    """(B, 32) bytes -> (32, B) int32 limbs."""
    return torch.from_numpy(np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32).T.astype(np.int32))


def test_sr_decode_equal_matches_encode_compare():
    """For Q = [x]B at random x and the identity, each against wire bytes
    R: RFC 9496's bad encodings, Q's encoding, its non-canonical twin
    (s + p), -Q's encoding, the identity's and random bytes. decode(R) ok
    and ristretto_equal(decode(R), Q) equals encode(Q) == R, the latter
    taken with the JAX package's encoder."""
    rng = np.random.default_rng(63)
    points = [ref.scalar_mult(int.from_bytes(rng.bytes(32), "little") % ref.L, ref.BASE)
              for _ in range(3)] + [ref.IDENTITY]
    qs, rs = [], []
    for pt in points:
        enc = tsr.ristretto_encode(pt)
        cands = [bytes.fromhex(h) for h in BAD_ENCODINGS] + [
            enc, (int.from_bytes(enc, "little") + tsr.P).to_bytes(32, "little"),
            tsr.ristretto_encode(tsr.point_neg(pt)), bytes(32)] + [rng.bytes(32) for _ in range(4)]
        # Q itself as the ladder leaves it: a projective multiple (Z = 3)
        x, y, z, t = pt
        qs += [(x * 3 % ref.P, y * 3 % ref.P, z * 3 % ref.P, t * 3 % ref.P)] * len(cands)
        rs += cands
    q = torch.stack([_limbs([c.to_bytes(32, "little") for c in coord]) for coord in zip(*qs)])
    r_pt, r_ok = R.decode(_limbs(rs))
    got = r_ok & ristretto_equal(r_pt, q)
    want = np.all(np.asarray(JR.encode(q.numpy())) == _limbs(rs).numpy(), axis=0)
    np.testing.assert_array_equal(got.numpy(), want)
    # Q's own encoding for each point; the identity's also as -Q and as 32 zero bytes
    assert int(want.sum()) == 6
