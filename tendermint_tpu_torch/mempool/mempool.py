"""TxMempool — concurrent priority mempool
(ref: internal/mempool/mempool.go:36-700).

Semantics preserved: CheckTx gates admission and assigns priority/gas
from the app's response; LRU cache dedups seen txs (cache.go:35);
ReapMaxBytesMaxGas returns txs in priority order (mempool.go:325);
Update removes committed txs and re-checks the remainder; TxsAvailable
fires once per height when the pool becomes non-empty.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from .. import trace as _trace
from ..crypto.batch import is_fault, mark_fault
from ..abci import types as abci
from ..abci.client import Client


def tx_key(tx: bytes) -> bytes:
    """ref: types.Tx.Key — SHA-256 of the raw tx."""
    return hashlib.sha256(tx).digest()


# Below this many txs the hashlib loop beats the native call's
# marshaling; above it tm_sha256_batch hashes the whole batch in one
# GIL-released call (threaded in C for large totals).
_NATIVE_HASH_MIN = 8

# CheckTx requests pipelined per wire burst: bounds the socket client's
# pending deque (and the server's response backlog, and how long a
# consensus-critical ABCI call can queue FIFO behind one admission
# burst on a shared connection) while still amortizing the round trip
# ~1000 ways.
ADMIT_PIPELINE_CHUNK = 1024


def tx_keys_batch(txs) -> list[bytes]:
    """SHA-256 keys for a whole admission batch through the native hash
    plane (native.sha256_batch) — one ctypes call instead of one hashlib
    round per tx; the hashlib loop below the cutover or under
    TM_TPU_NATIVE=0. Byte-identical to tx_key per item."""
    if len(txs) >= _NATIVE_HASH_MIN:
        from .. import native

        out = native.sha256_batch(txs)
        if out is not None:
            return out
    return [hashlib.sha256(tx).digest() for tx in txs]


@dataclass
class WrappedTx:
    """ref: internal/mempool/tx.go WrappedTx."""

    tx: bytes
    key: bytes
    height: int  # height when added
    priority: int = 0
    gas_wanted: int = 0
    sender: str = ""
    timestamp: float = 0.0
    peers: set = field(default_factory=set)  # peer IDs that sent us this tx


class LRUTxCache:
    """Fixed-size LRU of tx keys (ref: internal/mempool/cache.go:35)."""

    def __init__(self, size: int):
        self._size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()
        self._lock = threading.Lock()

    def push(self, key: bytes) -> bool:
        """Returns False if already present (and refreshes recency)."""
        with self._lock:
            return self.push_unlocked(key)

    def remove(self, key: bytes) -> None:
        with self._lock:
            self.remove_unlocked(key)

    def has(self, key: bytes) -> bool:
        with self._lock:
            return key in self._map

    def has_many(self, keys) -> list[bool]:
        """Presence snapshot for a whole batch under ONE lock hold (no
        recency refresh — pure read, like has())."""
        with self._lock:
            return [k in self._map for k in keys]

    # Batch admission settles thousands of push/remove ops back to back;
    # lock_batch() + the *_unlocked twins let it hold the cache lock
    # ONCE for the whole settle instead of paying a handoff per tx.
    # Lock order is always mempool._mtx -> cache lock (check_tx's
    # standalone push takes the cache lock without _mtx and releases it
    # before taking _mtx, so the order never reverses).

    def lock_batch(self):
        return self._lock

    def push_unlocked(self, key: bytes) -> bool:
        m = self._map
        if key in m:
            m.move_to_end(key)
            return False
        m[key] = None
        if len(m) > self._size:
            m.popitem(last=False)
        return True

    def remove_unlocked(self, key: bytes) -> None:
        self._map.pop(key, None)

    def reset(self) -> None:
        with self._lock:
            self._map.clear()


class TxMempool:
    """ref: mempool.TxMempool (internal/mempool/mempool.go:36)."""

    def __init__(
        self,
        app_client: Client,
        size: int = 5000,
        max_tx_bytes: int = 1024 * 1024,
        max_txs_bytes: int = 1024 * 1024 * 1024,
        cache_size: int = 10000,
        keep_invalid_txs_in_cache: bool = False,
        post_check=None,
        metrics=None,
        ttl_duration: float = 0.0,
        ttl_num_blocks: int = 0,
        max_gas: int = -1,
        pre_verify=None,
    ):
        # block gas cap for admission (PostCheckMaxGas analog); the node
        # refreshes it when on-chain ConsensusParams change
        self.max_gas = max_gas
        self._app = app_client
        self._metrics = metrics  # MempoolMetrics (ref: mempool/metrics.go)
        self._size = size
        self._max_tx_bytes = max_tx_bytes
        self._max_txs_bytes = max_txs_bytes
        self._cache = LRUTxCache(cache_size)
        self._keep_invalid = keep_invalid_txs_in_cache
        self._post_check = post_check
        # ref: config.MempoolConfig TTLDuration/TTLNumBlocks — a tx is
        # purged at Update once it has sat in the pool for more than
        # ttl_num_blocks heights OR longer than ttl_duration seconds.
        self._ttl_duration = ttl_duration
        self._ttl_num_blocks = ttl_num_blocks
        # Opt-in tx signature pre-verification hook: a callable taking a
        # list of txs and returning a parallel list of verdicts — True
        # (signature valid), False (invalid: reject before the app ever
        # sees the tx), or None (tx carries no recognized signature
        # envelope: pass through). mempool/preverify.py provides the
        # engine-routed ed25519 implementation; None (the default, and
        # the kvstore wiring) disables the phase entirely.
        self._pre_verify = pre_verify

        self._mtx = threading.RLock()
        self._txs: dict[bytes, WrappedTx] = {}  # key -> wtx, insertion-ordered
        self._height = 0
        self._total_bytes = 0
        self._seq = 0  # FIFO tiebreak within equal priority
        self._order: dict[bytes, int] = {}
        # Priority-ordered reap view, built lazily and kept until the
        # next insert/remove/priority change — proposer reaps at a full
        # steady-state pool stop paying O(n log n) per block.
        self._ordered_cache: list[WrappedTx] | None = None
        # Callbacks fired (outside the lock) after admissions insert new
        # txs — the gossip reactor's condition-driven wakeup.
        self._new_tx_listeners: list = []

        self._txs_available_cond = threading.Condition(self._mtx)
        self._notified_txs_available = False
        self._txs_signal_pending = False  # un-consumed notification
        self._txs_available_enabled = False

    # -------------------------------------------------------- properties

    def size(self) -> int:
        with self._mtx:
            return len(self._txs)

    def has_txs(self) -> bool:
        with self._mtx:
            return bool(self._txs)

    def total_bytes(self) -> int:
        with self._mtx:
            return self._total_bytes

    def is_full(self, tx_size: int) -> Exception | None:
        with self._mtx:
            if len(self._txs) >= self._size or tx_size + self._total_bytes > self._max_txs_bytes:
                return RuntimeError(
                    f"mempool is full: number of txs {len(self._txs)} (max: {self._size}), "
                    f"total txs bytes {self._total_bytes} (max: {self._max_txs_bytes})"
                )
        return None

    def lock(self):
        self._mtx.acquire()

    def unlock(self):
        self._mtx.release()

    def flush(self) -> None:
        with self._mtx:
            self._txs.clear()
            self._order.clear()
            self._total_bytes = 0
            self._ordered_cache = None
            self._cache.reset()

    def add_new_tx_listener(self, cb) -> None:
        """Register cb() to run after an admission inserts new txs.
        Called OUTSIDE the mempool lock; exceptions are swallowed (a
        listener must never fail an admission)."""
        with self._mtx:
            self._new_tx_listeners.append(cb)

    def remove_new_tx_listener(self, cb) -> None:
        with self._mtx:
            try:
                self._new_tx_listeners.remove(cb)
            except ValueError:
                pass

    def _fire_new_txs(self) -> None:
        for cb in list(self._new_tx_listeners):
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass

    def enable_txs_available(self) -> None:
        """ref: EnableTxsAvailable — consensus subscribes to the signal."""
        with self._mtx:
            self._txs_available_enabled = True

    def wait_txs_available(self, timeout: float | None = None) -> bool:
        """One-shot delivery per height, like the reference's cap-1
        TxsAvailable channel: the pending notification is CONSUMED by the
        waiter (mempool.go notifyTxsAvailable fires once; re-armed on the
        next Update), so the consensus watcher doesn't spin re-delivering
        the same signal for the whole block interval."""
        with self._txs_available_cond:
            if self._txs_signal_pending:
                self._txs_signal_pending = False
                return True
            if not self._txs_available_cond.wait(timeout):
                return False
            if self._txs_signal_pending:
                self._txs_signal_pending = False
                return True
            return False

    def _notify_txs_available(self) -> None:
        if self._txs and self._txs_available_enabled and not self._notified_txs_available:
            self._notified_txs_available = True
            self._txs_signal_pending = True
            self._txs_available_cond.notify_all()

    # ----------------------------------------------------------- checktx

    def _over_gas_cap(self, res) -> bool:
        """PostCheckMaxGas predicate, shared by admission and recheck."""
        return res.is_ok and self.max_gas > -1 and res.gas_wanted > self.max_gas

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """Admission path (ref: CheckTx mempool.go:175). Raises on
        oversize/full/duplicate; returns the app's response otherwise."""
        if len(tx) > self._max_tx_bytes:
            raise ValueError(f"tx size {len(tx)} exceeds max {self._max_tx_bytes}")
        err = self.is_full(len(tx))
        if err is not None:
            raise err
        key = tx_key(tx)
        if not self._cache.push(key):
            # record the alternate sender for gossip routing (mempool.go:233)
            with self._mtx:
                wtx = self._txs.get(key)
                if wtx is not None and sender:
                    wtx.peers.add(sender)
            raise TxInCacheError()
        res = None
        if self._pre_verify is not None:
            try:
                verdict = self._run_pre_verify([tx])[0]
            except Exception:
                # a fault judged nothing: the tx may be submitted again
                self._cache.remove(key)
                raise
            if verdict is False:
                res = _sig_reject_response()
        if res is None:
            res = self._app.check_tx(abci.RequestCheckTx(tx=tx, type=0))
        # ref: PostCheckMaxGas (types.go:131, wired by the node from
        # ConsensusParams.Block.MaxGas): a tx wanting more gas than a
        # block may carry can never be reaped — reject at admission
        # instead of polluting the pool forever. A POLICY rejection, not
        # a peer fault: gossiping peers may hold the older cap (the
        # reference's postCheck failures never punish the sender).
        if self._over_gas_cap(res):
            if not self._keep_invalid:
                self._cache.remove(key)
            if self._metrics is not None:
                self._metrics.failed_txs.add(1)
            raise TxPolicyError(
                f"gas wanted {res.gas_wanted} exceeds block max gas {self.max_gas}"
            )
        if res.is_ok:
            with self._mtx:
                wtx = WrappedTx(
                    tx=tx,
                    key=key,
                    height=self._height,
                    priority=res.priority,
                    gas_wanted=res.gas_wanted,
                    sender=sender or res.sender,
                    timestamp=time.monotonic(),
                )
                if sender:
                    wtx.peers.add(sender)
                self._insert(wtx)
                self._notify_txs_available()
            if self._metrics is not None:
                self._metrics.size.set(self.size())
                self._metrics.tx_size_bytes.observe(len(tx))
            self._fire_new_txs()
        else:
            if not self._keep_invalid:
                self._cache.remove(key)
            if self._metrics is not None:
                self._metrics.failed_txs.add(1)
        return res

    # ------------------------------------------------------ batched checktx

    def _client_check_tx_batch(self, reqs):
        """Route a CheckTx batch through the client's pipelined batch
        call when it has one (LocalClient: one mutex hold; SocketClient:
        submit N, one flush, collect N), else a plain loop — any object
        with a check_tx method works."""
        fn = getattr(self._app, "check_tx_batch", None)
        if fn is not None:
            return fn(reqs)
        return [self._app.check_tx(r) for r in reqs]

    def check_tx_batch(self, txs, senders=None, keys=None) -> list:
        """Coalesced admission: the batched counterpart of N sequential
        check_tx calls, with identical per-tx accept/reject outcomes.

        Returns a list parallel to txs where each entry is either the
        ResponseCheckTx check_tx would have returned or the exception
        instance it would have raised (ValueError oversize / RuntimeError
        full / TxInCacheError / TxPolicyError) — batch callers route
        per-tx outcomes instead of catching.

        Pipeline: (1) size-gate + cache-presence snapshot, (2) hash every
        key through the native SHA-256 batch plane, (3) optional
        engine-routed signature pre-verification of the whole batch,
        (4) ONE pipelined ABCI round — capped at the pool's free slots,
        so the app never sees a tx the sequential path would have
        full-rejected before its CheckTx (stateful check-state stays
        untouched; the byte-budget gate can still over-send in the rare
        byte-capped-pool case), (5) settle in input order under one
        mempool lock hold, evolving pool state exactly as the sequential
        path would (full-pool and intra-batch-duplicate gates see the
        same intermediate state). Callers that already hashed the batch
        (the gossip recv path marks peer sent-sets) pass `keys` to skip
        the rehash. Entries with no pipelined response on
        hand at settle (beyond the free-slot cap because earlier rejects
        freed room, or a stale cache snapshot) replay through the plain
        sequential check_tx AFTER the settle, with no locks held. No
        phase holds the mempool lock across an ABCI call, so consensus
        reaps proceed while a flood is in flight."""
        n = len(txs)
        if n == 0:
            return []
        if senders is None:
            senders = [""] * n
        elif isinstance(senders, str):
            senders = [senders] * n
        elif len(senders) != n:
            raise ValueError(f"{len(senders)} senders for {n} txs")
        t0 = time.monotonic()
        m = self._metrics
        sp = _trace.span("mempool.admit_batch", "mempool", n=n)
        with sp:
            outcomes: list = [None] * n
            if keys is None:
                keys = tx_keys_batch(txs)
            elif len(keys) != n:
                raise ValueError(f"{len(keys)} keys for {n} txs")

            # Phase 1 (no lock): size gate; candidates = entries that
            # would reach the app under the PRE-BATCH cache state.
            # Intra-batch duplicates stay candidates — the sequential
            # path calls the app again for a later occurrence when the
            # earlier one was rejected and uncached, so each occurrence
            # needs its own response on hand.
            cached = self._cache.has_many(keys)
            candidates = []
            for i, tx in enumerate(txs):
                if len(tx) > self._max_tx_bytes:
                    outcomes[i] = ValueError(
                        f"tx size {len(tx)} exceeds max {self._max_tx_bytes}"
                    )
                elif not cached[i]:
                    candidates.append(i)

            # Phase 2 (no lock): opt-in signature pre-verification — one
            # engine submit for the whole batch, so concurrent RPC and
            # gossip admitters coalesce into single launches.
            sig_failed = set()
            if self._pre_verify is not None and candidates:
                verdicts = self._run_pre_verify([txs[i] for i in candidates])
                for i, ok in zip(candidates, verdicts):
                    if ok is False:
                        sig_failed.add(i)

            # Phase 3 (no lock): pipelined ABCI round, chunked to bound
            # the in-flight window; capped at the pool's free slots and
            # at ONE submission per distinct key — sequential admission
            # never calls the app for a tx it would full-reject or
            # cache-dedupe first, and stateful check-state (nonce
            # tracking) must not advance twice for one duplicated tx.
            # A later duplicate whose first occurrence gets rejected-
            # and-uncached settles through the deferred sequential pass
            # below, which calls the app exactly when sequential would.
            with self._mtx:
                free = max(0, self._size - len(self._txs))
            app_idx: list[int] = []
            first_of_key: set[bytes] = set()
            for i in candidates:
                if i in sig_failed or keys[i] in first_of_key:
                    continue
                first_of_key.add(keys[i])
                app_idx.append(i)
                if len(app_idx) >= free:
                    break
            responses: dict[int, object] = {}
            for lo in range(0, len(app_idx), ADMIT_PIPELINE_CHUNK):
                chunk = app_idx[lo : lo + ADMIT_PIPELINE_CHUNK]
                reqs = [abci.RequestCheckTx(tx=txs[i], type=0) for i in chunk]
                if m is not None:
                    m.admit_pipeline_depth.set(len(reqs))
                try:
                    ress = self._client_check_tx_batch(reqs)
                finally:
                    if m is not None:
                        m.admit_pipeline_depth.set(0)
                responses.update(zip(chunk, ress))

            # Phase 4: settle in input order under ONE lock hold. Gate
            # order matches check_tx exactly: full -> cache dedupe ->
            # (pre-verify verdict) -> app response -> gas cap.
            admitted = 0
            failed = 0
            admitted_sizes: list[int] = []
            deferred: list[int] = []
            deferred_keys: set[bytes] = set()
            now = time.monotonic()  # one admission timestamp per batch
            with self._mtx:
                # locals hoisted: this loop runs once per tx of a 50k
                # flood, and attribute lookups per iteration are the
                # difference between ~4x and ~2x over the per-tx path
                pool = self._txs
                order = self._order
                cache = self._cache
                keep_invalid = self._keep_invalid
                size_cap = self._size
                bytes_cap = self._max_txs_bytes
                height = self._height
                gas_cap = self.max_gas
                total_bytes = self._total_bytes
                seq = self._seq
                with cache.lock_batch():
                    push = cache.push_unlocked
                    uncache = cache.remove_unlocked
                    for i, tx in enumerate(txs):
                        if outcomes[i] is not None:
                            continue  # oversize
                        key = keys[i]
                        if len(pool) >= size_cap or len(tx) + total_bytes > bytes_cap:
                            outcomes[i] = RuntimeError(
                                f"mempool is full: number of txs {len(pool)} "
                                f"(max: {size_cap}), total txs bytes "
                                f"{total_bytes} (max: {bytes_cap})"
                            )
                            continue
                        if key in deferred_keys:
                            # a deferred earlier occurrence of this key
                            # must settle first to keep input order
                            deferred.append(i)
                            continue
                        if not push(key):
                            wtx = pool.get(key)
                            if wtx is not None and senders[i]:
                                wtx.peers.add(senders[i])
                            outcomes[i] = TxInCacheError()
                            continue
                        if i in sig_failed:
                            res = _sig_reject_response()
                        else:
                            res = responses.get(i)
                            if res is None:
                                # no pipelined response on hand (beyond
                                # the free-slot cap, or the cache
                                # snapshot went stale): undo the push so
                                # the deferred sequential pass — which
                                # NEVER runs under these locks — replays
                                # this entry from scratch
                                uncache(key)
                                deferred.append(i)
                                deferred_keys.add(key)
                                continue
                        if res.is_ok and -1 < gas_cap < res.gas_wanted:
                            if not keep_invalid:
                                uncache(key)
                            failed += 1
                            outcomes[i] = TxPolicyError(
                                f"gas wanted {res.gas_wanted} exceeds block "
                                f"max gas {gas_cap}"
                            )
                            continue
                        if res.is_ok:
                            sender = senders[i]
                            wtx = WrappedTx(
                                tx=tx,
                                key=key,
                                height=height,
                                priority=res.priority,
                                gas_wanted=res.gas_wanted,
                                sender=sender or res.sender,
                                timestamp=now,
                            )
                            if sender:
                                wtx.peers.add(sender)
                            # inlined _insert (key is fresh: push() proved
                            # it absent from cache, and pool membership
                            # implies cache membership between updates —
                            # but re-check anyway to stay exact)
                            if key not in pool:
                                pool[key] = wtx
                                seq += 1
                                order[key] = seq
                                total_bytes += len(tx)
                                admitted += 1
                                admitted_sizes.append(len(tx))
                            outcomes[i] = res
                        else:
                            if not keep_invalid:
                                uncache(key)
                            failed += 1
                            outcomes[i] = res
                self._seq = seq
                self._total_bytes = total_bytes
                if admitted:
                    self._ordered_cache = None
                    self._notify_txs_available()
            # Deferred pass (NO locks held): the plain sequential path,
            # in input order — these entries gate/cache/app/metric/notify
            # exactly as a standalone check_tx, because they ARE one.
            for i in deferred:
                try:
                    outcomes[i] = self.check_tx(txs[i], sender=senders[i])
                except Exception as e:  # noqa: BLE001 - outcome, not raise
                    if is_fault(e):
                        raise  # the pre-verifier's fault is no tx's outcome
                    outcomes[i] = e
            sp.annotate(admitted=admitted, failed=failed, deferred=len(deferred))
        if m is not None:
            if failed:
                m.failed_txs.add(failed)
            if admitted:
                m.size.set(self.size())
                m.tx_size_bytes.observe_many(admitted_sizes)
            m.admit_batch_size.observe(n)
            m.admit_seconds.observe(time.monotonic() - t0)
        if admitted:
            self._fire_new_txs()
        return outcomes

    def _run_pre_verify(self, txs) -> list:
        """The pre-verifier's verdicts on txs. Its errors (the engine's: a
        kernel wrapper's guard, a failed launch) are marked as verifier
        faults, so no caller reads them as a tx's outcome."""
        try:
            return self._pre_verify(txs)
        except Exception as e:
            mark_fault(e)
            raise

    def _insert(self, wtx: WrappedTx) -> None:
        if wtx.key in self._txs:
            return
        self._txs[wtx.key] = wtx
        self._seq += 1
        self._order[wtx.key] = self._seq
        self._total_bytes += len(wtx.tx)
        self._ordered_cache = None

    def _remove(self, key: bytes) -> None:
        wtx = self._txs.pop(key, None)
        if wtx is not None:
            self._order.pop(key, None)
            self._total_bytes -= len(wtx.tx)
            self._ordered_cache = None

    def remove_tx_by_key(self, key: bytes) -> None:
        with self._mtx:
            if key not in self._txs:
                raise KeyError("transaction not found in mempool")
            self._remove(key)
            self._cache.remove(key)

    def get_tx(self, key: bytes) -> bytes | None:
        with self._mtx:
            wtx = self._txs.get(key)
            return wtx.tx if wtx else None

    def all_txs(self) -> list[WrappedTx]:
        """Insertion-ordered snapshot (for gossip walkers)."""
        with self._mtx:
            return list(self._txs.values())

    # -------------------------------------------------------------- reap

    def _ordered_txs(self) -> list[WrappedTx]:
        """Priority-ordered view (FIFO tiebreak), cached until the next
        insert/remove/priority change — back-to-back proposer reaps at a
        full pool sort once, not once per call. Lock held by caller."""
        if self._ordered_cache is None:
            self._ordered_cache = sorted(
                self._txs.values(), key=lambda w: (-w.priority, self._order[w.key])
            )
        return self._ordered_cache

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        """Priority-ordered reap under byte/gas budgets
        (ref: ReapMaxBytesMaxGas mempool.go:325)."""
        with self._mtx:
            ordered = self._ordered_txs()
            out: list[bytes] = []
            total_bytes = 0
            total_gas = 0
            for wtx in ordered:
                if max_bytes > -1 and total_bytes + len(wtx.tx) > max_bytes:
                    break
                gas = total_gas + wtx.gas_wanted
                if max_gas > -1 and gas > max_gas:
                    break
                total_gas = gas
                total_bytes += len(wtx.tx)
                out.append(wtx.tx)
            return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._mtx:
            ordered = self._ordered_txs()
            if n < 0:
                n = len(ordered)
            return [w.tx for w in ordered[:n]]

    # ------------------------------------------------------------ update

    def update(
        self,
        height: int,
        txs: list[bytes],
        tx_results: list[abci.ExecTxResult],
        recheck: bool = True,
    ) -> None:
        """Post-commit bookkeeping (ref: Update mempool.go:594): drop
        committed txs (cache valid ones), then re-CheckTx survivors.
        Caller must hold the mempool lock (BlockExecutor.Commit does)."""
        self._height = height
        self._notified_txs_available = False
        for tx, res in zip(txs, tx_results):
            key = tx_key(tx)
            if res.is_ok:
                self._cache.push(key)  # committed: keep in cache to reject replays
            elif not self._keep_invalid:
                self._cache.remove(key)
            if key in self._txs:
                self._remove(key)
        self._purge_expired_txs(height)
        if recheck and self._txs:
            t0 = time.monotonic()
            self._recheck_txs()
            if self._metrics is not None:
                self._metrics.recheck_times.add(1)
                self._metrics.recheck_duration.observe(time.monotonic() - t0)
        if self._metrics is not None:
            self._metrics.size.set(self.size())
        self._notify_txs_available()

    def _purge_expired_txs(self, block_height: int) -> None:
        """ref: purgeExpiredTxs (mempool.go:735) — TTL eviction by age in
        blocks and/or wall time; expired txs also leave the cache so they
        can be resubmitted later."""
        if self._ttl_num_blocks == 0 and self._ttl_duration == 0:
            return
        now = time.monotonic()
        for wtx in list(self._txs.values()):
            expired = (
                self._ttl_num_blocks > 0
                and (block_height - wtx.height) > self._ttl_num_blocks
            ) or (
                self._ttl_duration > 0 and (now - wtx.timestamp) > self._ttl_duration
            )
            if expired:
                self._remove(wtx.key)
                self._cache.remove(wtx.key)
                if self._metrics is not None:
                    self._metrics.evicted_txs.add(1)

    def _recheck_txs(self) -> None:
        """ref: updateReCheckTxs mempool.go:675 — re-run CheckTx(Recheck)
        on every remaining tx, evicting newly-invalid ones. The gas cap
        applies here too (the reference runs postCheck on recheck): a
        lowered on-chain Block.MaxGas must flush now-over-cap txs, or a
        high-priority one would stop every reap at the front of the
        queue forever.

        The ABCI round runs PIPELINED (all requests on the wire, then
        responses collected) and with the mempool lock fully RELEASED —
        update()'s caller holds it across commit, and a big-pool recheck
        against a socket app used to stall every RPC/gossip admission
        for the whole sweep. The settle loop re-checks membership per
        tx, so admissions and removals that landed while unlocked are
        honored (a tx admitted mid-recheck keeps its fresh CheckTx
        verdict and is simply skipped this round)."""
        with self._mtx:
            wtxs = list(self._txs.values())
        if not wtxs:
            return
        reqs = [abci.RequestCheckTx(tx=w.tx, type=1) for w in wtxs]
        # Fully release the caller-held RLock (whatever its recursion
        # count) while responses are in flight — the same
        # _release_save/_acquire_restore pair Condition.wait itself
        # depends on, via the condition already bound to this lock.
        # They are CPython-private: if an interpreter ever drops them,
        # degrade to holding the lock across the recheck (slower, never
        # incorrect). If the caller did not
        # hold the lock there is nothing to release.
        release = getattr(self._txs_available_cond, "_release_save", None)
        restore = getattr(self._txs_available_cond, "_acquire_restore", None)
        saved = None
        if release is not None and restore is not None:
            try:
                saved = release()
            except RuntimeError:
                saved = None  # lock not held by this thread
        try:
            responses = self._client_check_tx_batch(reqs)
        finally:
            if saved is not None:
                restore(saved)
        with self._mtx:
            for wtx, res in zip(wtxs, responses):
                if wtx.key not in self._txs:
                    continue  # removed while the lock was released
                if not res.is_ok or self._over_gas_cap(res):
                    self._remove(wtx.key)
                    if not self._keep_invalid:
                        self._cache.remove(wtx.key)
                    if self._metrics is not None:
                        self._metrics.failed_txs.add(1)
                else:
                    if wtx.priority != res.priority:
                        self._ordered_cache = None
                    wtx.priority = res.priority
                    wtx.gas_wanted = res.gas_wanted


def _sig_reject_response() -> abci.ResponseCheckTx:
    """Synthetic rejection for a tx whose signature pre-verification
    failed: shaped like an app rejection (the tx never reaches the app)
    so admission handles it through the ordinary not-ok path."""
    return abci.ResponseCheckTx(
        code=1, log="tx signature pre-verification failed", codespace="mempool"
    )


class AsyncBatchAdmitter:
    """Bounded fire-and-forget admission queue for broadcast_tx_async:
    one worker drains whatever has accumulated into check_tx_batch
    calls, so a flood of async RPC submissions coalesces into pipelined
    batches with backpressure (queue full -> submit() returns False)
    instead of spawning one daemon thread per request.

    A fault of the pre-verifier (the engine's: a kernel wrapper's guard, a
    failed launch) is not swallowed as the app's errors are: the worker
    stops, hands it to on_fatal (the node's, through the RPC), and every
    later submit() raises it."""

    def __init__(self, mempool: TxMempool, maxsize: int = 10000, max_batch: int = 1024, on_fatal=None):
        self.mempool = mempool
        self.on_fatal = on_fatal
        self._max_batch = max_batch
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._start_lock = threading.Lock()
        self._started = False
        self.fault: BaseException | None = None

    def submit(self, tx: bytes, sender: str = "") -> bool:
        """Enqueue one tx; False means the admission queue is full and
        the caller should surface backpressure to the client. Raises the
        pre-verifier's fault once the worker has stopped on one."""
        if self.fault is not None:
            raise self.fault
        try:
            self._q.put_nowait((tx, sender))
        except queue.Full:
            return False
        self._ensure_started()
        self._set_depth()
        return True

    def pending(self) -> int:
        return self._q.qsize()

    def _set_depth(self) -> None:
        m = self.mempool._metrics
        if m is not None:
            m.admit_queue_depth.set(self._q.qsize())

    def _ensure_started(self) -> None:
        if self._started:
            return
        with self._start_lock:
            if self._started:
                return
            self._started = True
            threading.Thread(
                target=self._worker, daemon=True, name="mempool-admit"
            ).start()

    def _worker(self) -> None:
        while True:
            batch = [self._q.get()]  # block for the first item
            while len(batch) < self._max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._set_depth()
            try:
                self.mempool.check_tx_batch(
                    [tx for tx, _ in batch], [s for _, s in batch]
                )
            except Exception as e:  # noqa: BLE001 - fire-and-forget semantics
                if is_fault(e):
                    self.fault = e
                    if self.on_fatal is not None:
                        self.on_fatal(e)
                    return


class TxInCacheError(Exception):
    """ref: types.ErrTxInCache."""

    def __str__(self):
        return "tx already exists in cache"


class TxPolicyError(ValueError):
    """Admission-policy rejection (pre/postCheck analog): the tx is
    refused but the SENDER is not at fault — gossip peers may hold
    different caps mid-params-change, so reactors must not evict on
    this (unlike protocol violations)."""
