"""RFC-6962 merkle trees and inclusion proofs (ref: crypto/merkle/tree.go,
crypto/merkle/proof.go), the JAX package's crypto/merkle.py.

Leaf hash = SHA256(0x00 || leaf); inner hash = SHA256(0x01 || left || right).
Trees over n items split at the largest power of two < n.

Two byte-identical builders serve every tree:

  - native (the default): one GIL-released ctypes call into native/prep.c
    (tm_merkle_root / tm_merkle_proofs / tm_merkle_multiproof /
    tm_sha256_batch): a contiguous buffer a level, no recursion,
    libcrypto's SHA-256 where it resolves, threaded leaf hashing for big
    trees. Roots and SHA-256 batches route there from _NATIVE_MIN_LEAVES
    items, proofs and multiproofs from one. A failed build, load or
    allocation raises (native/): nothing falls back quietly.
  - pure Python, which TM_TPU_NATIVE=0 selects, the oracle the native
    plane is tested against: level-iterative pairing with odd-node
    promotion. Bottom-up pairing with promotion builds exactly the
    split-at-the-largest-power-of-two-below-n tree (both place 2^k leaves
    in every maximal left subtree).

Every build lands in HashMetrics (site and backend counters, leaf-count
and latency histograms) and a `hash.merkle_build` trace span.

`multiproof_from_byte_slices` proves k sorted distinct indices in one
call, emitting the deduplicated shared-node set `MultiProof.verify`
consumes; `TreeLevels` and `TreeCache` hold built trees so that repeated
proof requests against one tree are node assembly alone (committed trees
are immutable, so the LRU needs no invalidation).
"""

from __future__ import annotations

import hashlib
import time as _time

from .. import native as _native
from .. import trace as _trace

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"

# Below this leaf count the ctypes call's overhead (the bytes join and the
# offsets array) beats the native win, so tiny trees (a header's 14
# fields) hash in Python. The reference's crossover.
_NATIVE_MIN_LEAVES = 16

_HM = None


def _hash_metrics():
    global _HM
    if _HM is None:
        from ..metrics import hash_metrics

        _HM = hash_metrics()
    return _HM


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (ref: tree.go:93)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def sha256_batch(items: list[bytes]) -> list[bytes]:
    """SHA-256 of each item: one native call from _NATIVE_MIN_LEAVES items
    (unless TM_TPU_NATIVE=0), else one hashlib pass (types/tx.go Tx.Hash
    feeding txs_hash)."""
    if len(items) >= _NATIVE_MIN_LEAVES:
        out = _native.sha256_batch(items)
        if out is not None:
            _hash_metrics().sha256_batches.add(1, "native")
            return out
    _hash_metrics().sha256_batches.add(1, "python")
    sha = hashlib.sha256
    return [sha(it).digest() for it in items]


def _hash_level(level: list[bytes]) -> list[bytes]:
    """One pairing pass; an odd tail node is promoted unchanged."""
    sha = hashlib.sha256
    nxt = [
        sha(INNER_PREFIX + level[i] + level[i + 1]).digest()
        for i in range(0, len(level) - 1, 2)
    ]
    if len(level) & 1:
        nxt.append(level[-1])
    return nxt


def _hash_from_byte_slices_py(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _sha256(b"")
    sha = hashlib.sha256
    level = [sha(LEAF_PREFIX + it).digest() for it in items]
    while len(level) > 1:
        level = _hash_level(level)
    return level[0]


def hash_from_byte_slices(items: list[bytes], site: str = "merkle") -> bytes:
    """Merkle root (ref: HashFromByteSlices, crypto/merkle/tree.go:11).
    Empty list hashes to SHA256 of the empty string. `site` labels the
    build in HashMetrics/tmtrace (header, txs, commit, ...)."""
    n = len(items)
    t0 = _time.perf_counter()
    with _trace.span("hash.merkle_build", "hash", site=site, n=n) as sp:
        root = None
        backend = "python"
        if n >= _NATIVE_MIN_LEAVES:
            root = _native.merkle_root(items)
            if root is not None:
                backend = "native"
        if root is None:
            root = _hash_from_byte_slices_py(items)
        sp.annotate(backend=backend)
    m = _hash_metrics()
    m.merkle_builds.add(1, site, backend)
    m.merkle_leaves.observe(n, site)
    m.merkle_build_seconds.observe(_time.perf_counter() - t0, backend)
    return root


class Proof:
    """Inclusion proof (ref: crypto/merkle/proof.go:26)."""

    __slots__ = ("total", "index", "leaf_hash", "aunts")

    def __init__(self, total: int, index: int, leaf_hash_: bytes, aunts: list[bytes]):
        self.total = total
        self.index = index
        self.leaf_hash = leaf_hash_
        self.aunts = aunts

    def compute_root_hash(self) -> bytes | None:
        return _compute_hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)

    def verify(self, root_hash: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        return self.compute_root_hash() == root_hash

    def to_proto(self):
        from ..proto import messages as pb

        return pb.Proof(total=self.total, index=self.index, leaf_hash=self.leaf_hash, aunts=list(self.aunts))

    @classmethod
    def from_proto(cls, p):
        return cls(p.total, p.index, p.leaf_hash, list(p.aunts))


def _compute_hash_from_aunts(index: int, total: int, leaf: bytes, aunts: list[bytes]) -> bytes | None:
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        if aunts:
            return None
        return leaf
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_hash_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


class MultiProof:
    """Batched inclusion proof (tmproof): k sorted distinct indices
    against ONE tree, carrying the deduplicated shared-node set instead
    of k aunt lists. The k independent proofs of a batch recompute and
    re-transmit the same internal nodes near the root; the multiproof
    ships each needed node once (the RFC-6962 port of the polynomial
    multiproof shape — PAPERS.md, light-client DAS).

    `nodes` is in canonical order — bottom-up levels, ascending index
    within a level — exactly the order `verify` consumes, so two
    builders agreeing byte-for-byte on `nodes` is the cross-backend
    identity the property sweep pins."""

    __slots__ = ("total", "indices", "leaf_hashes", "nodes")

    def __init__(self, total: int, indices: list[int], leaf_hashes: list[bytes],
                 nodes: list[bytes]):
        self.total = total
        self.indices = list(indices)
        self.leaf_hashes = list(leaf_hashes)
        self.nodes = list(nodes)

    def _indices_ok(self) -> bool:
        if not self.indices or self.total <= 0:
            return False
        prev = -1
        for idx in self.indices:
            if not isinstance(idx, int) or isinstance(idx, bool):
                return False
            if idx <= prev or idx >= self.total:
                return False
            prev = idx
        return True

    def compute_root_hash(self) -> bytes | None:
        """Reconstruct the root from the proven leaf hashes + shared
        nodes, or None on any malformed shape (the aunt-walk analog of
        _compute_hash_from_aunts: structure errors are verdicts)."""
        if not self._indices_ok() or len(self.leaf_hashes) != len(self.indices):
            return None
        sha = hashlib.sha256
        cur = list(zip(self.indices, self.leaf_hashes))
        count = self.total
        pos = 0
        while count > 1:
            nxt = []
            i, m = 0, len(cur)
            while i < m:
                idx, h = cur[i]
                sib = idx ^ 1
                if (idx & 1) == 0 and i + 1 < m and cur[i + 1][0] == sib:
                    h = sha(INNER_PREFIX + h + cur[i + 1][1]).digest()
                    i += 2
                elif sib < count:
                    if pos >= len(self.nodes):
                        return None  # truncated node set
                    other = self.nodes[pos]
                    pos += 1
                    h = sha(
                        INNER_PREFIX + (other + h if idx & 1 else h + other)
                    ).digest()
                    i += 1
                else:
                    i += 1  # promoted odd tail: ancestor rises unchanged
                nxt.append((idx >> 1, h))
            cur = nxt
            count = (count + 1) // 2
        if pos != len(self.nodes):
            return None  # surplus nodes: not the proof this tree emitted
        return cur[0][1]

    def verify(self, root_hash: bytes, leaves: list[bytes]) -> bool:
        """Accept iff every (index, leaf) pair is proven under
        root_hash — accept/reject identical to the k independent
        `Proof.verify` calls the batch replaces."""
        if len(leaves) != len(self.indices) or len(self.leaf_hashes) != len(self.indices):
            return False
        if not self._indices_ok():
            return False
        for lh, leaf in zip(self.leaf_hashes, leaves):
            if leaf_hash(leaf) != lh:
                return False
        return self.compute_root_hash() == root_hash


def _multiproof_nodes_from_levels(levels: list[list[bytes]], indices: list[int]) -> list[bytes]:
    """The shared-node set for `indices` assembled from prebuilt tree
    levels (bottom-up, leaf hashes first) — pure list walking, zero
    hashing: the hot-tree-cache serve path. Mirrors tm_merkle_multiproof
    exactly (same emission order, same pair/promote rules)."""
    nodes: list[bytes] = []
    cur = list(indices)
    for level in levels[:-1]:
        count = len(level)
        nxt = []
        i, m = 0, len(cur)
        while i < m:
            idx = cur[i]
            if (idx & 1) == 0 and i + 1 < m and cur[i + 1] == idx + 1:
                i += 2
            else:
                sib = idx ^ 1
                if sib < count:
                    nodes.append(level[sib])
                i += 1
            nxt.append(idx >> 1)
        cur = nxt
    return nodes


def _levels_from_byte_slices_py(items: list[bytes]) -> list[list[bytes]]:
    """Every tree level bottom-up (leaf hashes first, [root] last); leaf
    hashing through sha256_batch (native from _NATIVE_MIN_LEAVES items)."""
    n = len(items)
    if n == 0:
        return [[_sha256(b"")]]
    prefixed = [LEAF_PREFIX + it for it in items]
    levels = [sha256_batch(prefixed)]
    while len(levels[-1]) > 1:
        levels.append(_hash_level(levels[-1]))
    return levels


def _validate_indices(total: int, indices) -> list[int]:
    """Sorted-distinct-in-range contract shared by every multiproof
    producer (generation RAISES where verification returns False: a
    caller asking to prove garbage is a bug, not a forgery)."""
    out = []
    prev = -1
    for idx in indices:
        if not isinstance(idx, int) or isinstance(idx, bool):
            raise ValueError(f"multiproof index {idx!r} is not an int")
        if idx <= prev:
            raise ValueError(
                f"multiproof indices must be sorted strictly ascending "
                f"(got {idx} after {prev})"
            )
        if idx >= total:
            raise ValueError(f"multiproof index {idx} out of range for {total} leaves")
        out.append(idx)
        prev = idx
    if not out:
        raise ValueError("multiproof requires at least one index")
    return out


def multiproof_from_byte_slices(items: list[bytes], indices, site: str = "merkle") -> tuple[bytes, MultiProof]:
    """Root plus ONE batched proof for the given sorted distinct
    indices: the k-request analog of proofs_from_byte_slices that shares
    internal nodes instead of recomputing them per index. One native call
    (tm_merkle_multiproof), or under TM_TPU_NATIVE=0 the level-iterative
    Python builder, byte-identical."""
    n = len(items)
    idxs = _validate_indices(n, indices)
    t0 = _time.perf_counter()
    with _trace.span("hash.merkle_build", "hash", site=site, n=n, k=len(idxs), multiproof=True) as sp:
        res = None
        backend = "python"
        if n >= 1:
            res = _native.merkle_multiproof(items, idxs)
            if res is not None:
                backend = "native"
        if res is None:
            levels = _levels_from_byte_slices_py(items)
            res = (
                levels[-1][0],
                [levels[0][i] for i in idxs],
                _multiproof_nodes_from_levels(levels, idxs),
            )
        sp.annotate(backend=backend)
    root, leaves, nodes = res
    m = _hash_metrics()
    m.merkle_builds.add(1, site, backend)
    m.merkle_leaves.observe(n, site)
    m.merkle_build_seconds.observe(_time.perf_counter() - t0, backend)
    return root, MultiProof(n, idxs, leaves, nodes)


# ------------------------------------------------------- hot-tree cache


class TreeLevels:
    """An immutable built tree: every level bottom-up (leaf hashes
    first, [root] last). Committed trees never change, so holding the
    levels turns every later proof request against the same tree into
    pure node assembly — zero hashing (the tmproof serve path)."""

    __slots__ = ("levels", "total", "root", "backend")

    def __init__(self, levels: list[list[bytes]], total: int, backend: str = "python"):
        self.levels = levels
        self.total = total
        self.root = levels[-1][0]
        self.backend = backend

    @classmethod
    def build(cls, items: list[bytes], site: str = "merkle") -> "TreeLevels":
        n = len(items)
        t0 = _time.perf_counter()
        # the label says which plane the level builder's leaf hashing
        # takes: sha256_batch gives None only under TM_TPU_NATIVE=0
        backend = "native" if (
            n >= _NATIVE_MIN_LEAVES and _native.sha256_batch([b""]) is not None
        ) else "python"
        with _trace.span("hash.merkle_build", "hash", site=site, n=n, levels=True) as sp:
            levels = _levels_from_byte_slices_py(items)
            sp.annotate(backend=backend)
        m = _hash_metrics()
        m.merkle_builds.add(1, site, backend)
        m.merkle_leaves.observe(n, site)
        m.merkle_build_seconds.observe(_time.perf_counter() - t0, backend)
        return cls(levels, n, backend)

    def proof(self, index: int) -> Proof:
        """One classic aunt-list proof assembled from the levels."""
        if not 0 <= index < self.total:
            raise ValueError(f"proof index {index} out of range for {self.total} leaves")
        aunts = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx ^ 1
            if sib < len(level):
                aunts.append(level[sib])
            idx >>= 1
        return Proof(self.total, index, self.levels[0][index], aunts)

    def multiproof(self, indices) -> MultiProof:
        """Batched proof assembled from the levels — no hashing."""
        idxs = _validate_indices(self.total, indices)
        return MultiProof(
            self.total,
            idxs,
            [self.levels[0][i] for i in idxs],
            _multiproof_nodes_from_levels(self.levels, idxs),
        )


class TreeCache:
    """LRU of recently built trees keyed by the caller's
    (site, height, root)-style tuple. Values are TreeLevels, or
    whatever immutable bundle the caller serves from. Trees are
    immutable once committed, so there is NO invalidation story, only
    capacity eviction. Hits/misses/evictions land in ProofMetrics
    (the pk-cache discipline: a cache whose hit rate is invisible is a
    cache that silently stopped working)."""

    def __init__(self, capacity: int = 32):
        import collections
        import threading

        if capacity <= 0:
            raise ValueError(f"tree cache capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._trees: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _metrics(self):
        from ..metrics import proof_metrics

        return proof_metrics()

    def get(self, key):
        with self._lock:
            tree = self._trees.get(key)
            if tree is not None:
                self._trees.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        self._metrics().tree_cache_events.add(1, "hit" if tree is not None else "miss")
        return tree

    def put(self, key, tree) -> None:
        evicted = 0
        with self._lock:
            self._trees[key] = tree
            self._trees.move_to_end(key)
            while len(self._trees) > self.capacity:
                self._trees.popitem(last=False)
                evicted += 1
            self.evictions += evicted
        if evicted:
            self._metrics().tree_cache_events.add(evicted, "evict")

    def get_or_build(self, key, items_fn, site: str = "merkle") -> TreeLevels:
        """Cached tree for `key`, building from items_fn() on a miss.
        The build runs OUTSIDE the lock (two racing requests for one
        cold height may both build; last insert wins — cheaper than
        serializing every proof request behind one build)."""
        tree = self.get(key)
        if tree is None:
            tree = TreeLevels.build(items_fn(), site=site)
            self.put(key, tree)
        return tree

    def __len__(self) -> int:
        with self._lock:
            return len(self._trees)


def _proofs_from_byte_slices_py(items: list[bytes]):
    """(root, leaf hashes, per-item aunt lists), level-iterative. At
    each level item i's ancestor sits at index idx; its sibling (idx^1,
    when present) is the next aunt, bottom-up; a promoted odd tail
    contributes no aunt at that level (matches the recursive builder's
    flatten_aunts skipping parents with no sibling pointer)."""
    n = len(items)
    sha = hashlib.sha256
    leaves = [sha(LEAF_PREFIX + it).digest() for it in items]
    aunts: list[list[bytes]] = [[] for _ in range(n)]
    if n == 0:
        return _sha256(b""), leaves, aunts
    idxs = list(range(n))
    level = leaves
    while len(level) > 1:
        count = len(level)
        for i in range(n):
            idx = idxs[i]
            sib = idx ^ 1
            if sib < count:
                aunts[i].append(level[sib])
            idxs[i] = idx >> 1
        level = _hash_level(level)
    return level[0], leaves, aunts


def proofs_from_byte_slices(items: list[bytes], site: str = "merkle") -> tuple[bytes, list[Proof]]:
    """Root plus one inclusion proof per item
    (ref: ProofsFromByteSlices, crypto/merkle/proof.go:82)."""
    n = len(items)
    t0 = _time.perf_counter()
    with _trace.span("hash.merkle_build", "hash", site=site, n=n, proofs=True) as sp:
        res = None
        backend = "python"
        if n >= 1:  # the batched plane pays off even for small trees
            res = _native.merkle_proofs(items)
            if res is not None:
                backend = "native"
        if res is None:
            res = _proofs_from_byte_slices_py(items)
        sp.annotate(backend=backend)
    root, leaves, aunt_lists = res
    proofs = [Proof(n, i, leaves[i], aunt_lists[i]) for i in range(n)]
    m = _hash_metrics()
    m.merkle_builds.add(1, site, backend)
    m.merkle_leaves.observe(n, site)
    m.merkle_build_seconds.observe(_time.perf_counter() - t0, backend)
    return root, proofs
