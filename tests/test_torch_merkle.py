"""The port's merkle plane (crypto/merkle.py on native/prep.c's SHA-256 and
merkle entry points) against the JAX package's, on seeded items: roots,
sha256_batch, per-item proofs and multiproofs for n in {0, 1, 2, 3, 15, 16,
17, 100, 1000}, on the native route and under TM_TPU_NATIVE=0, the
reference on its default route; tampered proofs fail on both; the trees
held by TreeLevels and TreeCache give the same proofs; the native wrappers
return None only under TM_TPU_NATIVE=0, and a failed build or allocation
raises; HashMetrics and ProofMetrics render the reference's series, and a
build counts as the reference's does."""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu import metrics as JM
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu_torch import metrics as M
from tendermint_tpu_torch import native as N
from tendermint_tpu_torch.crypto import merkle as tmerkle

SIZES = (0, 1, 2, 3, 15, 16, 17, 100, 1000)
ROUTES = ("native", "python")


def items(n, seed=81):
    """n items of 0-200 bytes, with one of 5,000 (the heap path) from 100 on."""
    rng = np.random.default_rng(seed + n)
    out = [rng.bytes(int(rng.integers(0, 201))) for _ in range(n)]
    if n >= 100:
        out[n // 2] = rng.bytes(5000)
    return out


def indices(n, seed=82):
    """A sorted distinct subset: first, last, a run of neighbours, random."""
    rng = np.random.default_rng(seed + n)
    pick = {0, n - 1, n // 2, min(n - 1, n // 2 + 1)} | set(rng.integers(0, n, size=min(n, 9)).tolist())
    return sorted(pick)


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setenv("TM_TPU_NATIVE", "0")
    else:
        monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    return request.param


def proof_tuple(p):
    return p.total, p.index, p.leaf_hash, list(p.aunts)


def multiproof_tuple(mp):
    return mp.total, mp.indices, mp.leaf_hashes, mp.nodes


@pytest.mark.parametrize("n", SIZES)
def test_roots_and_proofs_match_reference(route, n):
    xs = items(n)
    root = jmerkle.hash_from_byte_slices(xs)
    assert tmerkle.hash_from_byte_slices(xs, site="test") == root
    assert tmerkle.sha256_batch(xs) == jmerkle.sha256_batch(xs)
    got_root, proofs = tmerkle.proofs_from_byte_slices(xs)
    want_root, want = jmerkle.proofs_from_byte_slices(xs)
    assert got_root == want_root == root
    assert [proof_tuple(p) for p in proofs] == [proof_tuple(p) for p in want]
    assert tmerkle.TreeLevels.build(xs).root == root
    if n == 0:
        with pytest.raises(ValueError, match="at least one index"):
            tmerkle.multiproof_from_byte_slices(xs, [])
        return
    for p, x in zip(proofs, xs):
        assert p.verify(root, x) and p.to_proto().encode() == want[p.index].to_proto().encode()
        assert tmerkle.Proof.from_proto(p.to_proto()).compute_root_hash() == root
    idx = indices(n)
    got_root, mp = tmerkle.multiproof_from_byte_slices(xs, idx)
    want_root, want_mp = jmerkle.multiproof_from_byte_slices(xs, idx)
    assert got_root == want_root == root
    assert multiproof_tuple(mp) == multiproof_tuple(want_mp)
    assert mp.verify(root, [xs[i] for i in idx])
    tree = tmerkle.TreeLevels.build(xs)
    assert multiproof_tuple(tree.multiproof(idx)) == multiproof_tuple(mp)
    assert [proof_tuple(tree.proof(i)) for i in range(n)] == [proof_tuple(p) for p in proofs]


@pytest.mark.parametrize("n", [1, 2, 17, 100])
def test_tampered_proofs_fail(route, n):
    xs = items(n)
    root, proofs = tmerkle.proofs_from_byte_slices(xs)
    p = proofs[n // 2]
    assert p.verify(root, xs[n // 2])
    assert not p.verify(root, xs[n // 2] + b"x")
    assert not p.verify(bytes(32), xs[n // 2])
    wrong = [bytes(32)] + p.aunts[1:] if p.aunts else [bytes(32)]
    assert not tmerkle.Proof(p.total, p.index, p.leaf_hash, wrong).verify(root, xs[n // 2])
    idx = indices(n)
    _, mp = tmerkle.multiproof_from_byte_slices(xs, idx)
    leaves = [xs[i] for i in idx]
    assert not mp.verify(root, [leaves[0] + b"x"] + leaves[1:])
    if mp.nodes:
        bad = tmerkle.MultiProof(mp.total, mp.indices, mp.leaf_hashes, [bytes(32)] + mp.nodes[1:])
        assert not bad.verify(root, leaves)
        assert tmerkle.MultiProof(mp.total, mp.indices, mp.leaf_hashes, mp.nodes[:-1]).compute_root_hash() is None
    with pytest.raises(ValueError, match="ascending"):
        tmerkle.multiproof_from_byte_slices(xs, [0, 0] if n > 1 else [0, -1])


def test_tree_cache_counts_events(monkeypatch):
    monkeypatch.setattr(M, "_GLOBAL_REGISTRY", M.Registry())
    monkeypatch.setattr(M, "_PROOF_METRICS", None)
    cache = tmerkle.TreeCache(capacity=2)
    builds = []
    for key in ("a", "a", "b", "c", "a"):
        cache.get_or_build(key, lambda key=key: builds.append(key) or items(20, seed=ord(key)))
    assert builds == ["a", "b", "c", "a"] and len(cache) == 2
    assert (cache.hits, cache.misses, cache.evictions) == (1, 4, 2)
    events = {lb["event"]: v for _, lb, v in M.proof_metrics().tree_cache_events.samples()}
    assert events == {"hit": 1, "miss": 4, "evict": 2}
    with pytest.raises(ValueError):
        tmerkle.TreeCache(capacity=0)


def test_wrappers_return_none_only_when_disabled(monkeypatch):
    xs = items(20)
    calls = [lambda: N.sha256_batch(xs), lambda: N.merkle_root(xs), lambda: N.merkle_proofs(xs),
             lambda: N.merkle_multiproof(xs, [1, 2])]
    monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    assert all(call() is not None for call in calls)
    assert N.merkle_root([]) == jmerkle.hash_from_byte_slices([]) and N.sha256_batch([]) == []
    for bad in ([2, 1], [1, 1], [-1, 2], [0, 20]):
        with pytest.raises(ValueError, match="ascend strictly"):
            N.merkle_multiproof(xs, bad)
    monkeypatch.setenv("TM_TPU_NATIVE", "0")
    assert all(call() is None for call in calls)


def test_forced_build_failure_raises(monkeypatch, tmp_path):
    """A compile error surfaces through the merkle plane: no Python fallback."""
    monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    bad_src = tmp_path / "prep.c"
    bad_src.write_text("int tm_merkle_root(void) { return }\n")
    monkeypatch.setattr(N, "SRC", bad_src)
    xs = items(40)
    with pytest.raises(RuntimeError, match=r"(?s)failed \(rc [1-9].*error"):
        tmerkle.hash_from_byte_slices(xs)
    with pytest.raises(RuntimeError, match="failed"):
        tmerkle.proofs_from_byte_slices(xs)
    assert N._lib is None


@pytest.mark.parametrize("n", [1, 4096])
def test_failed_allocation_raises(n):
    """The last item claims 2^62 bytes: its prefixed buffer cannot be
    allocated (no byte of it is read), and every tree builder returns -1 on
    the serial (1 item) and the threaded (4,096 items) leaf hashing (plain
    SHA-256 batches hash in place and allocate nothing)."""
    lib = N.load_prep()
    offsets = np.arange(n + 1, dtype=np.int64)
    offsets[n] = offsets[n - 1] + 2**62
    blob, off = b"x" * n, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    u8 = lambda k: np.zeros(k, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    stride = max(1, (n - 1).bit_length())
    assert lib.tm_merkle_root(blob, off, n, u8(32)) == -1
    counts = np.zeros(n, np.int32).ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    assert lib.tm_merkle_proofs(blob, off, n, stride, u8(32), u8(32 * n), u8(32 * n * stride), counts) == -1
    idx = np.zeros(1, np.int64)
    n_nodes = np.zeros(1, np.int64)
    assert lib.tm_merkle_multiproof(blob, off, n, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 1,
                                    u8(32), u8(32), u8(32 * stride),
                                    n_nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))) == -1


def test_status_raises_memory_error(monkeypatch):
    monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    fake = SimpleNamespace(**{fn: (lambda *a: -1) for fn in (
        "tm_sha256_batch", "tm_merkle_root", "tm_merkle_proofs", "tm_merkle_multiproof")})
    monkeypatch.setattr(N, "load_prep", lambda: fake)
    xs = items(3)
    for call in (lambda: N.sha256_batch(xs), lambda: N.merkle_root(xs), lambda: N.merkle_proofs(xs),
                 lambda: N.merkle_multiproof(xs, [0])):
        with pytest.raises(MemoryError, match="could not be allocated"):
            call()


@pytest.mark.parametrize("group", ["HashMetrics", "ProofMetrics"])
def test_metrics_gather_equals_reference(group):
    port_reg, ref_reg = M.Registry(), JM.Registry()
    port, want = getattr(M, group)(port_reg), getattr(JM, group)(ref_reg)
    assert port_reg.gather() == ref_reg.gather()
    for p_metric, r_metric in ((getattr(port, a), getattr(want, a)) for a in vars(want)
                               if hasattr(getattr(want, a), "label_names")):
        labels = tuple(f"l{i}" for i in range(len(r_metric.label_names)))
        for metric in (p_metric, r_metric):
            if metric.kind == "histogram":
                metric.observe(0.75, *labels)
            else:
                metric.add(2, *labels)
    assert port_reg.gather() == ref_reg.gather()


def test_builds_count_as_reference(route, monkeypatch):
    """The same builds in both packages count the same builds, leaves and
    SHA-256 batches by site and backend (the times aside)."""
    for mod in (M, JM):
        monkeypatch.setattr(mod, "_GLOBAL_REGISTRY", mod.Registry())
        monkeypatch.setattr(mod, "_HASH_METRICS", None)
    for merkle in (tmerkle, jmerkle):
        monkeypatch.setattr(merkle, "_HM", None)
    for merkle in (tmerkle, jmerkle):
        merkle.hash_from_byte_slices(items(3), site="header")
        merkle.hash_from_byte_slices(items(40), site="validator_set")
        merkle.proofs_from_byte_slices(items(5), site="parts")
        merkle.multiproof_from_byte_slices(items(17), [1, 2], site="txs")
        merkle.sha256_batch(items(20))
    keep = lambda reg: [line for line in reg.gather().splitlines()
                        if not line.startswith(("tendermint_hash_merkle_build_seconds", "# "))]
    assert keep(M.global_registry()) == keep(JM.global_registry())
    assert any(f'backend="{route}"' in line for line in keep(M.global_registry()))
