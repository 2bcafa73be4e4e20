"""The single-table cache hits (csrc/verify_cached_single.cu, row 6, and
csrc/verify_sr_cached_single.cu, row 11) modelled as the kernels run them
and held to the JAX programs.

Both kernels run coop.cuh's coop_cached_hit: a block's decode warp decodes
R, one lane a row, and stores it (-R for ed25519, R for sr25519) with its
decode bit, while each quad maps its slot as the reference's gather does
(cache_slot) and runs the 63 Straus windows of coop_straus_with with A''s
entries read straight from the int16 cache entry (coop_load_cached: each
lane loads X, Y and its w, T on lane 2 and Z on the others, limbs as
stored, read modulo p). Then lane 0 of the quad decides:
  - ed25519: add -R, 3 doublings, X = 0 and Y = Z (the cofactored
    equality [8]([s]B - [k]A) == [8]R);
  - sr25519: ristretto_equal(R, Q) on Q's X and Y from lanes 0 and 1, in
    place of the reference's encode(Q) == R bytes;
and the row is oks[slot] && R's decode bit && that verdict.

The model runs that schedule round by round with test_torch_coop_lanes'
quad operations (exact mod p), and its bitmap must equal the JAX
verify_kernel_cached / verify_sr_kernel_cached on chip_smoke.edge_batch /
sr_edge_batch rows with a tampered k, slots that are not rows, the raw
slots -1, -5, -C, -C - 1, INT32_MIN, C, C + 3 and INT32_MAX and slots
counted from the end (slot - C), through both cache forms: the port's
canonical bytes (what its fill kernels write) and a JAX cache carried
across by cache_from_reference (the reference's signed limbs). On
sr25519 an honest row's R is also made odd (p - R) and non-canonical
(R + p) after the host prep, so k stays R's: both encodings' decode
candidates equal R's point, so only R's decode bit makes those rows
false, and the model without it must fail there."""

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

import test_torch_coop_lanes as TC
from test_torch_split_lanes import ristretto_equal

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

CAPACITY = 48
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
EDGE_SLOTS = [-1, -5, -CAPACITY, -CAPACITY - 1, INT32_MIN, CAPACITY, CAPACITY + 3, INT32_MAX]

# plane -> (edge batch, host prep, oracle, JAX single fill, JAX single hit,
#           port plain single fill)
PLANES = {
    "ed25519": (chip_smoke.edge_batch, V.prepare_batch, ref.verify, JV.build_pk_tables,
                JV.verify_kernel_cached, V.build_pk_tables_plain),
    "sr25519": (chip_smoke.sr_edge_batch, VS.prepare_batch, tsr.verify, JVS.build_sr_tables,
                JVS.verify_sr_kernel_cached, VS.build_sr_tables_plain),
}


def load_cached(entry, nib):
    """coop_load_cached for every quad: each lane's copy of X and Y of
    entry nib of its row's table and its w (T on lane 2, Z on the others);
    entry is the rows' cache entries (16, 4, 32, B) as stored."""
    e = C._select16(entry, nib)
    return [e[0]] * 4, [e[1]] * 4, [e[3] if q == 2 else e[2] for q in range(4)]


def window_loop(entry, s_bytes, k_bytes):
    """coop_straus_with on the cache loader: 63 windows of 4 quad doublings,
    B's entry and A''s entry from the cache; the four lanes' coordinates."""
    nib_s = C.scalar_to_nibbles(V._limb_major(s_bytes))
    nib_k = C.scalar_to_nibbles(V._limb_major(k_bytes))
    base = torch.as_tensor(C.base_table())[..., None]  # (16, 4, 32, 1)
    mine = TC.lanes(C._select16(base, nib_s[63]))
    mine = TC.coop_add_xyw(mine, *load_cached(entry, nib_k[63]))
    for w in range(62, -1, -1):
        for _ in range(4):
            mine = TC.coop_dbl(mine)
        mine = TC.coop_add(mine, C._select16(base, nib_s[w]))
        mine = TC.coop_add_xyw(mine, *load_cached(entry, nib_k[w]))
    return mine


def hit_model(plane, tables, oks, slots, r_enc, s_bytes, k_bytes, r_bit=True):
    """(B,) bool: coop_cached_hit on (C, 16, 4, 32) int16 tables, (C,) oks,
    (B,) raw int32 slots and (B, 32) uint8 rows; r_bit=False drops R's
    decode bit from the decision (the mutant)."""
    r = V._limb_major(r_enc)
    # the quads: the slot rule, the window loop on the cache entry
    idx = V.cache_slots(slots, tables.shape[0])
    entry = tables[idx].to(torch.int32).permute(1, 2, 3, 0)
    mine = window_loop(entry, s_bytes, k_bytes)
    if plane == "ed25519":
        # the decode warp stores -R; lane 0 tests [8](Q - R) for the identity
        r_pt, r_ok = C.decompress(r)
        mine = TC.coop_add(mine, C.point_neg(r_pt))
        for _ in range(3):
            mine = TC.coop_dbl(mine)
        verdict = F.fe_is_zero(mine[0]) & F.fe_is_zero(F.fe_sub(mine[1], mine[2]))
    else:
        # the decode warp stores R; lane 0 compares with Q's X and Y
        r_pt, r_ok = R.decode(r)
        verdict = ristretto_equal(r_pt, mine[:2])
    if not r_bit:
        r_ok = torch.ones_like(r_ok)
    return oks[idx] & r_ok & verdict


@pytest.fixture(scope="module")
def batches():
    """Each plane's rows: (a, r, s, k) as numpy arrays, the host-prep mask,
    the expected bitmap (oracle, the tampered k false), the tampered row,
    and for sr25519 the two rows whose R is made odd and non-canonical."""
    out = {}
    for plane, (edges, prep, oracle_fn, *_) in PLANES.items():
        rng = np.random.default_rng(91 if plane == "ed25519" else 92)
        pks, msgs, sigs = edges(rng, 24 if plane == "ed25519" else 30)
        oracle = [oracle_fn(*j) for j in zip(pks, msgs, sigs)]
        a, r, s, k, pre = prep(pks, msgs, sigs)
        valid = [i for i in range(len(sigs)) if oracle[i]]
        tampered, h = valid[:2]
        k = k.copy()
        k[tampered, 5] ^= 0x10
        expect = list(oracle)
        expect[tampered] = False
        mutants = []
        if plane == "sr25519":
            r_int = int.from_bytes(r[h].tobytes(), "little")
            bad_r = [(tsr.P - r_int).to_bytes(32, "little"), (r_int + tsr.P).to_bytes(32, "little")]
            a, s, k = (np.concatenate([x, x[[h, h]]]) for x in (a, s, k))
            r = np.concatenate([r, np.frombuffer(b"".join(bad_r), np.uint8).reshape(2, 32)])
            pre = np.concatenate([pre, pre[[h, h]]])
            expect += [False, False]
            mutants = [len(a) - 2, len(a) - 1]
        out[plane] = (a, r, s, k), pre, expect, tampered, mutants
    return out


def _cache(plane, form, a):
    """The rows' keys at a permutation of the slots of a CAPACITY-slot
    cache, in one of the two forms a hit kernel reads, as numpy arrays,
    with the permutation."""
    _, _, _, jfill, _, fill_plain = PLANES[plane]
    if form == "canonical":
        t, o = fill_plain(torch.from_numpy(a.copy()))
        t = F.fe_canonical(t.to(torch.int32).movedim(-1, 0)).movedim(0, -1).to(torch.int16)
        t, o = t.numpy(), o.numpy()
    else:
        jt, jo = jfill(a)
        t, o = np.asarray(jt), np.asarray(jo)
    perm = np.random.default_rng(93).permutation(CAPACITY)[:len(a)].astype(np.int32)
    tables = np.zeros((CAPACITY, 16, 4, 32), np.int16)
    oks = np.zeros(CAPACITY, bool)
    tables[perm], oks[perm] = t, o
    if form == "jax":
        # carried across as the port takes a snapshot of a JAX cache
        cache = V.cache_from_reference(tables, oks, {}, device="cpu", plane=plane)
        tables, oks = cache.tables.numpy(), cache.oks.numpy()
    return tables, oks, perm


def _edge_slots(perm, expect, skip):
    """Raw slots: the keys' own slots, four valid rows' counted from the end
    (slot - C) and the edge slots at the last rows outside those and
    `skip`."""
    slots = perm.copy()
    valid = [i for i, e in enumerate(expect) if e]
    for i in valid[:4]:
        slots[i] -= CAPACITY
    edge_rows = [i for i in range(len(expect)) if i not in valid[:4] + skip][-len(EDGE_SLOTS):]
    slots[edge_rows] = EDGE_SLOTS
    return slots, valid[:4], edge_rows


@pytest.mark.parametrize("form", ["canonical", "jax"])
@pytest.mark.parametrize("plane", list(PLANES))
def test_quad_hit_model_matches_jax(batches, plane, form):
    (a, r, s, k), pre, expect, tampered, mutants = batches[plane]
    jhit = PLANES[plane][4]
    tables, oks, perm = _cache(plane, form, a)
    slots, wrapped, edge_rows = _edge_slots(perm, expect, [tampered] + mutants)
    want = np.asarray(jhit(tables, oks, slots, r, s, k))
    got = hit_model(plane, *(torch.from_numpy(np.array(x)) for x in (tables, oks, slots, r, s, k)))
    np.testing.assert_array_equal(got.numpy(), want)
    # every row that reads its own key's entry gives the oracle's verdict
    own = [i for i in range(len(a)) if i not in edge_rows]
    assert [bool(got[i]) and bool(pre[i]) for i in own] == [expect[i] for i in own]
    assert all(bool(got[i]) for i in wrapped) and not bool(got[tampered])


def test_sr_quad_hit_needs_r_decode_bit(batches):
    """The odd and the non-canonical R decode to candidates equal to R's
    point: without R's decode bit the model accepts both rows, which the
    JAX program rejects."""
    (a, r, s, k), _, _, _, mutants = batches["sr25519"]
    tables, oks, perm = _cache("sr25519", "canonical", a)
    rows = [torch.from_numpy(np.array(x)) for x in (tables, oks, perm, r, s, k)]
    want = np.asarray(JVS.verify_sr_kernel_cached(tables, oks, perm, r, s, k))
    got = hit_model("sr25519", *rows)
    mutant = hit_model("sr25519", *rows, r_bit=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[mutants].any()
    assert mutant[mutants].all()
    assert not np.array_equal(mutant.numpy(), want)
