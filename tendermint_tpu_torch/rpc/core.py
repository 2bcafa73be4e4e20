"""RPC core: environment + the ~30 route handlers
(ref: internal/rpc/core/env.go, routes.go:28-80).

A copy of the JAX package's rpc/core.py. JSON conventions follow the
reference's RPC: hashes hex-upper, txs base64, heights as strings.

One rule is the port's own: a verifier fault (an error that
crypto/batch.py mark_fault marked: a kernel wrapper's guard, a failed
build or launch) is never a verdict. Where broadcast_tx_sync,
broadcast_tx_commit, broadcast_tx_async or broadcast_evidence meets one,
it is answered as a JSON-RPC internal error (-32603), never as a CheckTx
code, and handed to the environment's `on_fatal` (the node's, which
halts it). Every other error keeps the reference's answer.
"""

from __future__ import annotations

import base64
import time as _time

from ..abci import types as abci
from ..crypto.batch import is_fault
from ..eventbus.event_bus import (
    EventDataNewBlock,
    EventDataNewBlockHeader,
    EventDataTx,
    tx_hash,
)
from ..pubsub.query import parse_query
from .server import RPCError

ERR_TX_NOT_FOUND = -32603
ERR_INTERNAL = -32603


# ------------------------------------------------------------- JSON encoding


def _b64(b: bytes | None) -> str:
    return base64.b64encode(b or b"").decode()


def _hex(b: bytes | None) -> str:
    return (b or b"").hex().upper()


def block_id_to_json(bid) -> dict:
    if bid is None:
        return {"hash": "", "parts": {"total": 0, "hash": ""}}
    return {
        "hash": _hex(bid.hash),
        "parts": {
            "total": bid.part_set_header.total if bid.part_set_header else 0,
            "hash": _hex(bid.part_set_header.hash if bid.part_set_header else b""),
        },
    }


def header_to_json(h) -> dict:
    return {
        "version": {"block": str(h.version_block), "app": str(h.version_app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": str(h.time),
        "last_block_id": block_id_to_json(h.last_block_id),
        "last_commit_hash": _hex(h.last_commit_hash),
        "data_hash": _hex(h.data_hash),
        "validators_hash": _hex(h.validators_hash),
        "next_validators_hash": _hex(h.next_validators_hash),
        "consensus_hash": _hex(h.consensus_hash),
        "app_hash": _hex(h.app_hash),
        "last_results_hash": _hex(h.last_results_hash),
        "evidence_hash": _hex(h.evidence_hash),
        "proposer_address": _hex(h.proposer_address),
    }


def commit_to_json(c) -> dict:
    if c is None:
        return None
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_to_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": s.block_id_flag,
                "validator_address": _hex(s.validator_address),
                "timestamp": str(s.timestamp),
                "signature": _b64(s.signature),
            }
            for s in c.signatures
        ],
    }


def block_to_json(b) -> dict:
    return {
        "header": header_to_json(b.header),
        "data": {"txs": [_b64(tx) for tx in b.txs]},
        "evidence": {"evidence": [ev.to_proto().encode().hex() for ev in b.evidence]},
        "last_commit": commit_to_json(b.last_commit),
    }


def validator_to_json(v) -> dict:
    return {
        "address": _hex(v.address),
        "pub_key": {"type": v.pub_key.type_name, "value": _b64(v.pub_key.bytes())},
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }


def tx_result_to_json(r) -> dict:
    return {
        "code": getattr(r, "code", 0),
        "data": _b64(getattr(r, "data", b"")),
        "log": getattr(r, "log", ""),
        "info": getattr(r, "info", ""),
        "gas_wanted": str(getattr(r, "gas_wanted", 0)),
        "gas_used": str(getattr(r, "gas_used", 0)),
        "events": [
            {
                "type": e.type,
                "attributes": [{"key": a.key, "value": a.value, "index": a.index} for a in e.attributes],
            }
            for e in (getattr(r, "events", None) or [])
        ],
        "codespace": getattr(r, "codespace", ""),
    }


def multiproof_to_json(mp) -> dict:
    """Wire form of a crypto/merkle.MultiProof (tmproof gateway)."""
    return {
        "total": str(mp.total),
        "indices": list(mp.indices),
        "leaf_hashes": [_b64(h) for h in mp.leaf_hashes],
        "nodes": [_b64(nd) for nd in mp.nodes],
    }


def multiproof_from_json(d: dict):
    """Inverse of multiproof_to_json — the light client/proxy side
    rebuilds the proof to verify it against a VERIFIED header's
    data_hash before trusting anything the primary relayed."""
    from ..crypto.merkle import MultiProof

    return MultiProof(
        int(d.get("total") or 0),
        [int(i) for i in d.get("indices") or []],
        [base64.b64decode(h) for h in d.get("leaf_hashes") or []],
        [base64.b64decode(nd) for nd in d.get("nodes") or []],
    )


def event_to_json(data) -> dict:
    """Event payloads for ws subscriptions (ref: coretypes result events)."""
    if isinstance(data, EventDataNewBlock):
        return {
            "type": "tendermint/event/NewBlock",
            "value": {
                "block": block_to_json(data.block) if data.block else None,
                "block_id": block_id_to_json(data.block_id),
            },
        }
    if isinstance(data, EventDataNewBlockHeader):
        return {
            "type": "tendermint/event/NewBlockHeader",
            "value": {"header": header_to_json(data.header), "num_txs": str(data.num_txs)},
        }
    if isinstance(data, EventDataTx):
        return {
            "type": "tendermint/event/Tx",
            "value": {
                "TxResult": {
                    "height": str(data.height),
                    "index": data.index,
                    "tx": _b64(data.tx),
                    "result": tx_result_to_json(data.result) if data.result else None,
                }
            },
        }
    return {"type": type(data).__name__, "value": str(data)}


# --------------------------------------------------------------- environment


class RPCEnvironment:
    """Holds every subsystem the routes touch (ref: env.go Environment)."""

    def __init__(
        self,
        chain_id: str = "",
        state_store=None,
        block_store=None,
        consensus_state=None,
        mempool=None,
        evidence_pool=None,
        event_bus=None,
        tx_indexer=None,
        app_client=None,
        gen_doc=None,
        peer_manager=None,
        node_info=None,
        pub_key=None,
        router=None,
        unsafe=False,
        flight_recorder=None,
        on_fatal=None,
    ):
        self.chain_id = chain_id
        self.state_store = state_store
        self.block_store = block_store
        self.consensus_state = consensus_state
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.tx_indexer = tx_indexer
        self.app_client = app_client
        self.gen_doc = gen_doc
        self.peer_manager = peer_manager
        self.node_info = node_info
        self.pub_key = pub_key
        self.router = router
        self.unsafe = unsafe
        self.flight_recorder = flight_recorder
        self.on_fatal = on_fatal
        self.start_time = _time.time()

    def fault(self, exc: BaseException) -> RPCError:
        """A verifier fault met by a route: handed to on_fatal, answered
        as an internal error."""
        if self.on_fatal is not None:
            self.on_fatal(exc)
        return RPCError(ERR_INTERNAL, f"verifier fault: {type(exc).__name__}: {exc}")


def _as_int(v, name: str) -> int:
    if v is None:
        return None
    try:
        return int(v)
    except (TypeError, ValueError):
        raise RPCError(-32602, f"invalid {name}: {v!r}")


def _as_bytes_hex(v, name: str) -> bytes:
    if v is None:
        raise RPCError(-32602, f"missing required parameter {name}")
    if isinstance(v, bytes):
        return v
    s = str(v)
    if s.startswith("0x") or s.startswith("0X"):
        s = s[2:]
    try:
        return bytes.fromhex(s)
    except ValueError:
        try:
            return base64.b64decode(s, validate=True)
        except Exception:
            raise RPCError(-32602, f"invalid {name}: {v!r}")


def build_routes(env: RPCEnvironment) -> dict:
    """ref: internal/rpc/core/routes.go:28-80."""

    # ---------------------------------------------------------------- info

    def health():
        """Liveness probe: empty result while the node serves RPC."""
        return {}

    def status():
        """ref: internal/rpc/core/status.go."""
        latest_height = env.block_store.height() if env.block_store else 0
        latest_meta = env.block_store.load_block_meta(latest_height) if latest_height else None
        base = env.block_store.base() if env.block_store else 0
        base_meta = env.block_store.load_block_meta(base) if base else None
        val_info = {}
        if env.pub_key is not None and env.state_store is not None:
            state = env.state_store.load()
            addr = env.pub_key.address()
            idx, val = state.validators.get_by_address(addr) if state else (None, None)
            val_info = {
                "address": _hex(addr),
                "pub_key": {"type": env.pub_key.type_name, "value": _b64(env.pub_key.bytes())},
                "voting_power": str(val.voting_power) if val else "0",
            }
        ni = env.node_info
        node_info_json = (
            {
                "protocol_version": {
                    "p2p": str(ni.protocol_version.p2p),
                    "block": str(ni.protocol_version.block),
                    "app": str(ni.protocol_version.app),
                },
                "id": ni.node_id,
                "listen_addr": ni.listen_addr,
                "network": ni.network,
                "version": ni.version,
                "channels": ni.channels.hex(),
                "moniker": ni.moniker,
                "other": {"tx_index": ni.tx_index, "rpc_address": ni.rpc_address},
            }
            if ni
            else {}
        )
        return {
            "node_info": node_info_json,
            "sync_info": {
                "latest_block_hash": _hex(latest_meta.block_id.hash if latest_meta else b""),
                "latest_app_hash": _hex(latest_meta.header.app_hash if latest_meta else b""),
                "latest_block_height": str(latest_height),
                "latest_block_time": str(latest_meta.header.time) if latest_meta else "",
                "earliest_block_height": str(base),
                "earliest_block_time": str(base_meta.header.time) if base_meta else "",
                "catching_up": False,
            },
            "validator_info": val_info,
        }

    def net_info():
        """Connected peer listing."""
        peers = env.peer_manager.peers() if env.peer_manager else []
        return {
            "listening": True,
            "n_peers": str(len(peers)),
            "peers": [{"node_id": p} for p in peers],
        }

    def genesis():
        """The full genesis document."""
        import json as _json

        if env.gen_doc is None:
            raise RPCError(-32603, "genesis doc unavailable")
        return {"genesis": _json.loads(env.gen_doc.to_json())}

    def genesis_chunked(chunk=0):
        """Genesis in base64 chunks for large documents."""
        if env.gen_doc is None:
            raise RPCError(-32603, "genesis doc unavailable")
        data = env.gen_doc.to_json().encode()
        size = 16 * 1024
        chunks = [data[i : i + size] for i in range(0, len(data), size)] or [b""]
        idx = _as_int(chunk, "chunk") or 0
        if idx < 0 or idx >= len(chunks):
            raise RPCError(-32603, f"there are {len(chunks)} chunks; {idx} is invalid")
        return {"chunk": str(idx), "total": str(len(chunks)), "data": _b64(chunks[idx])}

    # --------------------------------------------------------------- blocks

    def _height_or_latest(height) -> int:
        h = _as_int(height, "height")
        if h is None or h == 0:
            return env.block_store.height()
        if h < 0:
            raise RPCError(-32603, f"height must be greater than 0, but got {h}")
        if h > env.block_store.height():
            raise RPCError(
                -32603,
                f"height {h} must be less than or equal to the head height {env.block_store.height()}",
            )
        base = env.block_store.base()
        if h < base:
            raise RPCError(
                -32603,
                f"height {h} is not available, lowest height is {base} "
                f"(blocks pruned or state-synced past it)",
            )
        return h

    def block(height=None):
        """Block ID + full block at a height (latest by default).

        Mirrors the reference exactly (blocks.go:90-102): a missing
        META yields the empty result; a present meta with a missing full
        block (e.g. a backfilled light block on a state-synced node)
        yields the REAL BlockID with a null block."""
        h = _height_or_latest(height)
        meta = env.block_store.load_block_meta(h)
        if meta is None:
            return {"block_id": block_id_to_json(None), "block": None}
        blk = env.block_store.load_block(h)
        return {
            "block_id": block_id_to_json(meta.block_id),
            "block": block_to_json(blk) if blk is not None else None,
        }

    def block_by_hash(hash=None):
        """Block ID + block for a block hash."""
        h = _as_bytes_hex(hash, "hash")
        blk = env.block_store.load_block_by_hash(h)
        if blk is None:
            return {"block_id": block_id_to_json(None), "block": None}
        meta = env.block_store.load_block_meta(blk.header.height)
        return {"block_id": block_id_to_json(meta.block_id), "block": block_to_json(blk)}

    def header(height=None):
        """ref: internal/rpc/core/blocks.go Header (routes.go:37)."""
        h = _height_or_latest(height)
        meta = env.block_store.load_block_meta(h)
        return {"header": header_to_json(meta.header) if meta else None}

    def header_by_hash(hash=None):
        """ref: internal/rpc/core/blocks.go HeaderByHash (routes.go:38)."""
        hb = _as_bytes_hex(hash, "hash")
        blk = env.block_store.load_block_by_hash(hb)
        return {"header": header_to_json(blk.header) if blk else None}

    def events(filter=None, maxItems=None, before=None, after=None, waitTime=None):
        """Cursor-paged polling over the event log
        (ref: internal/rpc/core/events.go Events, routes.go:31)."""
        from ..eventbus.eventlog import Cursor
        from ..pubsub.query import parse_query

        log = getattr(env.event_bus, "event_log", None) if env.event_bus else None
        if log is None:
            raise RPCError(-32603, "event log is not enabled on this node")
        max_items = _as_int(maxItems, "maxItems") or 10
        query = None
        if filter and isinstance(filter, dict) and filter.get("query"):
            query = parse_query(filter["query"])
        match = (lambda it: query.matches(it.events)) if query is not None else None
        wait = float(waitTime) / 1e9 if waitTime else 0.0  # duration ns like the reference
        after_c = Cursor.parse(after) if after else None
        before_c = Cursor.parse(before) if before else None
        if before_c is not None and not before_c.is_zero():
            items, more, oldest, newest = log.scan(
                before=before_c, after=after_c, max_items=max_items, match=match
            )
        else:
            items, more, oldest, newest = log.wait_scan(
                after=after_c, max_items=max_items, match=match, timeout=min(wait, 10.0)
            )
        return {
            "items": [
                {"cursor": str(it.cursor), "event": it.type, "data": event_to_json(it.data)}
                for it in items
            ],
            "more": more,
            "oldest": str(oldest),
            "newest": str(newest),
        }

    def debug_threads():
        """Per-thread stack traces — the goroutine-profile analog of the
        reference's pprof endpoint (node/node.go:446 pprof server)."""
        import sys
        import threading as _threading
        import traceback as _tb

        frames = sys._current_frames()
        by_ident = {t.ident: t for t in _threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            t = by_ident.get(ident)
            out.append(
                {
                    "name": t.name if t else str(ident),
                    "daemon": bool(t.daemon) if t else None,
                    "stack": _tb.format_stack(frame),
                }
            )
        return {"count": len(out), "threads": out}

    def dump_traces(clear=False, enable=None, min_height=None, max_height=None):
        """Snapshot the process-wide span tracer (the port's trace/)
        as Chrome-trace JSON — the timeline counterpart of
        debug_threads. `enable` flips the tracer at runtime (a node
        started without TM_TPU_TRACE can be instrumented live); `clear`
        drops the ring after the snapshot so the next dump starts
        fresh. `min_height`/`max_height` keep only height-tagged events
        (args.height) inside the range plus thread-name metadata — a
        journey snapshot of one block's life on a live node without
        shipping the whole ring (events carrying no height, e.g. raw
        engine spans, are dropped when a bound is set). The snapshot is
        read-only and always available; the mutating params require
        rpc.unsafe, like the other state-mutating debug routes. Save
        the `trace` object to a file and open it in Perfetto
        (ui.perfetto.dev) or chrome://tracing."""
        from .. import trace as _trace

        # same token set the repo's env gates accept for "off" — the
        # URI interface hands both params over as raw strings, so
        # clear="no" must parse false, not truthy
        def _truthy(v):
            return str(v).lower() not in ("false", "0", "", "off", "no", "none")

        clear = clear is not None and clear is not False and _truthy(clear)
        if (clear or enable is not None) and not env.unsafe:
            raise RPCError(
                -32603, "dump_traces clear/enable require rpc.unsafe"
            )
        lo = _as_int(min_height, "min_height")
        hi = _as_int(max_height, "max_height")
        doc = _trace.export()
        if lo is not None or hi is not None:

            def keep(e):
                if e.get("ph") == "M":
                    return True  # thread names: tiny, needed to render
                h = (e.get("args") or {}).get("height")
                if h is None:
                    return False
                return (lo is None or h >= lo) and (hi is None or h <= hi)

            doc = {
                "traceEvents": [e for e in doc["traceEvents"] if keep(e)],
                "displayTimeUnit": doc.get("displayTimeUnit", "ms"),
            }
        if clear:
            _trace.clear()
        if enable is not None:
            _trace.set_enabled(_truthy(enable))
        return {
            "enabled": _trace.enabled(),
            "events": len(doc["traceEvents"]),
            "trace": doc,
        }

    def flight_recorder(tail=None):
        """State + recent records of the in-run flight recorder
        (metrics/flight.py): whether it is sampling, its interval and
        artifact path, and the last `tail` (default 32, max 256)
        timeseries records straight from the in-memory ring — a live
        tail for `tmlens watch` without touching the node's disk.
        Read-only; enabled/disabled is node config
        (instrumentation.flight-interval)."""
        fr = env.flight_recorder
        n = _as_int(tail, "tail")
        n = 32 if n is None else max(0, min(n, 256))
        if fr is None:
            return {"enabled": False, "records": 0, "tail": []}
        return {
            "enabled": True,
            "interval_s": fr.interval,
            "path": fr.path,
            "records": fr.records_written,
            "tail": fr.tail(n),
        }

    def device_stats(tail=None):
        """Device-plane counters + recent compile events from the tmdev
        observatory (the port's devobs/): compiles, compile seconds,
        h2d/d2h transfer bytes, live-buffer residency and high water,
        plus the last `tail` (default 32, max 256) compile events with
        their fn/rows attribution — the flight_recorder-style live tail
        for `tmlens device` against a running node. Read-only;
        enabled/disabled is process env (TM_TPU_DEVOBS)."""
        from .. import devobs

        n = _as_int(tail, "tail")
        n = 32 if n is None else max(0, min(n, 256))
        return devobs.status(tail=n)

    def block_results(height=None):
        """FinalizeBlock results (tx results, events, updates) at a height."""
        h = _height_or_latest(height)
        f_res = env.state_store.load_finalize_block_responses(h)
        if f_res is None:
            raise RPCError(-32603, f"no results for height {h}")
        return {
            "height": str(h),
            "txs_results": [tx_result_to_json(r) for r in f_res.tx_results],
            "finalize_block_events": [
                {"type": e.type, "attributes": [{"key": a.key, "value": a.value} for a in e.attributes]}
                for e in (getattr(f_res, "events", None) or [])
            ],
            "validator_updates": [
                {"pub_key_type": u.pub_key_type, "power": str(u.power)} for u in f_res.validator_updates
            ],
            "app_hash": _hex(getattr(f_res, "app_hash", b"")),
        }

    def blockchain(minHeight=None, maxHeight=None):
        """ref: internal/rpc/core/blocks.go BlockchainInfo."""
        base = env.block_store.base()
        head = env.block_store.height()
        max_h = min(_as_int(maxHeight, "maxHeight") or head, head)
        min_h = max(_as_int(minHeight, "minHeight") or base, base)
        min_h = max(min_h, max_h - 20 + 1)
        metas = []
        for h in range(max_h, min_h - 1, -1):
            meta = env.block_store.load_block_meta(h)
            if meta is not None:
                metas.append(
                    {
                        "block_id": block_id_to_json(meta.block_id),
                        "block_size": str(meta.block_size),
                        "header": header_to_json(meta.header),
                        "num_txs": str(meta.num_txs),
                    }
                )
        return {"last_height": str(head), "block_metas": metas}

    def commit(height=None):
        """Signed header + canonical commit at a height."""
        h = _height_or_latest(height)
        meta = env.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"no header at height {h}")
        c = env.block_store.load_block_commit(h)
        canonical = True
        if c is None:
            c = env.block_store.load_seen_commit(h)
            canonical = False
        return {
            "signed_header": {"header": header_to_json(meta.header), "commit": commit_to_json(c)},
            "canonical": canonical,
        }

    # ------------------------------------------------------------- tmproof
    # Batched proof-serving gateway (docs/observability.md#tmproof):
    # proofs_batch proves k tx indices at a height in ONE multiproof —
    # the internal nodes that k independent proofs recompute and
    # re-transmit are emitted once — served from a hot-tree LRU of
    # committed (immutable) tx trees; light_batch bundles a whole
    # light-client verification step (header + commit + full validator
    # set + optional proofs) into one round trip.

    MAX_PROOF_INDICES = 1024
    _tree_cache: list = []

    def _get_tree_cache():
        if not _tree_cache:
            from ..crypto.merkle import TreeCache

            _tree_cache.append(TreeCache(capacity=32))
        return _tree_cache[0]

    def _serve_tx_proofs(h: int, indices, route: str) -> dict:
        """Multiproof over the data_hash tree at height h (leaves are
        the txs' SHA-256 digests, types/tx.go Txs.Hash shape). Counts
        ProofMetrics served/batch-size; the caller owns serve_seconds."""
        from ..crypto import merkle as _merkle
        from ..metrics import proof_metrics

        if not isinstance(indices, (list, tuple)) or not indices:
            raise RPCError(-32602, "indices must be a non-empty list of tx indices")
        if len(indices) > MAX_PROOF_INDICES:
            raise RPCError(
                -32602, f"at most {MAX_PROOF_INDICES} indices per request, got {len(indices)}"
            )
        try:
            idxs = [int(i) for i in indices]
        except (TypeError, ValueError):
            raise RPCError(-32602, f"invalid indices: {indices!r}")
        cache = _get_tree_cache()
        # get/put spelled out rather than TreeCache.get_or_build: the
        # served counter's backend label needs the hit/miss outcome,
        # which the helper hides. The entry caches the TXS alongside
        # the tree — a hit must skip the block store entirely (a full
        # block decode per request would dwarf the zero-hash assembly
        # win); memory is bounded by capacity x consensus max_bytes.
        entry = cache.get(("txs", h))
        backend = "cache"
        if entry is None:
            blk = env.block_store.load_block(h)
            if blk is None:
                raise RPCError(-32603, f"no block at height {h}")
            txs = list(blk.txs)
            # committed tx trees are immutable: build once, serve from
            # the LRU for every later request against this height
            tree = _merkle.TreeLevels.build(
                _merkle.sha256_batch(txs), site="proof_gateway"
            )
            cache.put(("txs", h), (tree, txs))
            backend = tree.backend
        else:
            tree, txs = entry
        try:
            mp = tree.multiproof(idxs)
        except ValueError as e:
            raise RPCError(-32602, str(e))
        m = proof_metrics()
        m.served.add(len(idxs), route, backend)
        m.batch_size.observe(len(idxs))
        return {
            "height": str(h),
            "root": _hex(tree.root),
            "multiproof": multiproof_to_json(mp),
            "txs": [_b64(txs[i]) for i in idxs],
        }

    def proofs_batch(height=None, indices=None):
        """k tx inclusion proofs at a height as ONE batched multiproof
        over the block's data_hash tree (tmproof gateway); verify with
        MultiProof.verify(data_hash, [sha256(tx), ...])."""
        from ..metrics import proof_metrics

        t0 = _time.perf_counter()
        h = _height_or_latest(height)
        out = _serve_tx_proofs(h, indices, "proofs_batch")
        proof_metrics().serve_seconds.observe(_time.perf_counter() - t0, "proofs_batch")
        return out

    def light_batch(height=None, indices=None):
        """A whole light-client verification step in one round trip:
        signed header + commit + FULL validator set, plus an optional
        tx multiproof when `indices` is given (tmproof gateway)."""
        from ..metrics import proof_metrics

        t0 = _time.perf_counter()
        h = _height_or_latest(height)
        # header + commit + canonical come from the commit route — ONE
        # copy of the block-commit/seen-commit fallback semantics
        out = commit(height=h)
        vals = env.state_store.load_validators(h)
        if vals is None:
            raise RPCError(-32603, f"no validator set at height {h}")
        out["validators"] = [validator_to_json(v) for v in vals.validators]
        out["total_validators"] = str(vals.size())
        if indices:
            out["proofs"] = _serve_tx_proofs(h, indices, "light_batch")
        proof_metrics().serve_seconds.observe(_time.perf_counter() - t0, "light_batch")
        return out

    def state_batch(height=None, keys=None):
        """k authenticated app-STATE reads at a height as ONE batched
        multiproof over the application's account/validator merkle tree
        (tmstate, docs/state.md). The proof root IS the header's
        app_hash at `height` — which commits the state FinalizeBlock
        (height-1) produced — so a light client that verified the
        header can verify the values with no extra trust. `keys` are
        hex-encoded raw state keys (e.g. the bytes of `acct:<addr-hex>`),
        sorted and distinct (the multiproof index contract, shared with
        proofs_batch via crypto/merkle._validate_indices). Verify with
        MultiProof.verify(app_hash, [key + b"=" + value, ...])."""
        from ..metrics import proof_metrics

        t0 = _time.perf_counter()
        h = _height_or_latest(height)
        if not isinstance(keys, (list, tuple)) or not keys:
            raise RPCError(-32602, "keys must be a non-empty list of hex-encoded state keys")
        if len(keys) > MAX_PROOF_INDICES:
            raise RPCError(
                -32602, f"at most {MAX_PROOF_INDICES} keys per request, got {len(keys)}"
            )
        raw_keys = [_as_bytes_hex(k, "keys") for k in keys]
        meta = env.block_store.load_block_meta(h)
        if meta is None:
            raise RPCError(-32603, f"no header at height {h}")
        # in-process apps expose the statetree's root-keyed history;
        # external/socket apps (and the kvstore's varint hash) don't
        app = getattr(env.app_client, "_app", None)
        view_at = getattr(app, "state_view_at", None)
        if view_at is None:
            raise RPCError(-32603, "app does not serve an authenticated state plane")
        view = view_at(meta.header.app_hash)
        if view is None:
            raise RPCError(
                -32603,
                f"state at height {h} is not retained "
                f"(app hash {_hex(meta.header.app_hash)} aged out of the history window)",
            )
        idxs = []
        for k_hex, rk in zip(keys, raw_keys):
            try:
                idxs.append(view.index_of(rk))
            except KeyError:
                raise RPCError(-32602, f"unknown state key {k_hex!r} at height {h}")
        try:
            # unsorted / duplicate keys surface here as the shared
            # _validate_indices contract (key order == leaf order)
            mp = view.multiproof(idxs)
        except ValueError as e:
            raise RPCError(-32602, str(e))
        m = getattr(app, "_state_metrics", None)
        if m is not None:
            m.proofs_served.add(len(idxs), "state_batch")
        proof_metrics().serve_seconds.observe(_time.perf_counter() - t0, "state_batch")
        return {
            "height": str(h),
            "root": _hex(view.root),
            "total": str(len(view)),
            "keys": [rk.hex() for rk in raw_keys],
            "values": [view.value_at(i).hex() for i in idxs],
            "multiproof": multiproof_to_json(mp),
        }

    def validators(height=None, page=1, per_page=30):
        """Paginated validator set at a height."""
        h = _height_or_latest(height)
        vals = env.state_store.load_validators(h)
        if vals is None:
            raise RPCError(-32603, f"no validator set at height {h}")
        page_i = max(1, _as_int(page, "page") or 1)
        per = min(100, max(1, _as_int(per_page, "per_page") or 30))
        start = (page_i - 1) * per
        sel = vals.validators[start : start + per]
        return {
            "block_height": str(h),
            "validators": [validator_to_json(v) for v in sel],
            "count": str(len(sel)),
            "total": str(vals.size()),
        }

    def consensus_params(height=None):
        """On-chain consensus parameters at a height."""
        h = _height_or_latest(height)
        params = env.state_store.load_consensus_params(h)
        if params is None:
            state = env.state_store.load()
            params = state.consensus_params
        return {
            "block_height": str(h),
            "consensus_params": {
                "block": {"max_bytes": str(params.block.max_bytes), "max_gas": str(params.block.max_gas)},
                "evidence": {
                    "max_age_num_blocks": str(params.evidence.max_age_num_blocks),
                    "max_age_duration": str(params.evidence.max_age_duration),
                    "max_bytes": str(params.evidence.max_bytes),
                },
                "validator": {"pub_key_types": list(params.validator.pub_key_types)},
            },
        }

    def consensus_state():
        """Compact live round-state summary."""
        cs = env.consensus_state
        if cs is None:
            raise RPCError(-32603, "consensus state unavailable")
        rs = cs.rs
        return {
            "round_state": {
                "height/round/step": f"{rs.height}/{rs.round}/{rs.step}",
                "start_time": str(rs.start_time),
                "proposal_block_hash": _hex(rs.proposal_block.hash() if rs.proposal_block else b""),
                "locked_block_hash": _hex(rs.locked_block.hash() if rs.locked_block else b""),
                "valid_block_hash": _hex(rs.valid_block.hash() if rs.valid_block else b""),
            }
        }

    def dump_consensus_state():
        """Full round state plus peer round states."""
        base = consensus_state()
        base["peers"] = [{"node_id": p} for p in (env.peer_manager.peers() if env.peer_manager else [])]
        return base

    # ------------------------------------------------------------- txs

    # Fire-and-forget admissions drain through ONE bounded queue and
    # worker (mempool.AsyncBatchAdmitter -> check_tx_batch): a flood of
    # async submissions coalesces into pipelined CheckTx batches with
    # backpressure, instead of spawning an unbounded daemon thread per
    # request. Created lazily so route construction stays side-effect
    # free for nodes that never see async traffic.
    _admitter: list = []

    def _get_admitter():
        if not _admitter:
            from ..mempool.mempool import AsyncBatchAdmitter

            _admitter.append(AsyncBatchAdmitter(env.mempool, on_fatal=env.on_fatal))
        return _admitter[0]

    def broadcast_tx_async(tx=None):
        """Fire-and-forget CheckTx; returns immediately. Queue-full is
        surfaced as a nonzero code (backpressure, like the reference's
        mempool-full CheckTx error) rather than silently dropped."""
        raw = _as_bytes_hex(tx, "tx")
        try:
            queued = _get_admitter().submit(raw)
        except Exception as e:
            if is_fault(e):
                raise env.fault(e) from e
            raise
        if not queued:
            return {
                "code": 1,
                "data": "",
                "log": "async admission queue full",
                "hash": _hex(tx_hash(raw)),
            }
        return {"code": 0, "data": "", "log": "", "hash": _hex(tx_hash(raw))}

    def broadcast_tx_sync(tx=None):
        """Run CheckTx, return its result (alias: broadcast_tx)."""
        raw = _as_bytes_hex(tx, "tx")
        try:
            res = env.mempool.check_tx(raw, sender="")
        except Exception as e:
            if is_fault(e):
                raise env.fault(e) from e
            return {"code": 1, "data": "", "log": str(e), "hash": _hex(tx_hash(raw))}
        return {
            "code": res.code,
            "data": _b64(res.data),
            "log": res.log,
            "codespace": res.codespace,
            "hash": _hex(tx_hash(raw)),
        }

    def remove_tx(txKey=None):
        """ref: mempool.go:190 RemoveTx -> Mempool.RemoveTxByKey."""
        env.mempool.remove_tx_by_key(_as_bytes_hex(txKey, "txKey"))
        return {}

    MAX_TX_COMMIT_TIMEOUT = 60.0

    def broadcast_tx_commit(tx=None, timeout=30.0):
        """CheckTx, then wait for the tx to be committed
        (ref: internal/rpc/core/mempool.go BroadcastTxCommit)."""
        raw = _as_bytes_hex(tx, "tx")
        try:
            timeout = min(float(timeout), MAX_TX_COMMIT_TIMEOUT)
        except (TypeError, ValueError):
            raise RPCError(-32602, f"invalid timeout: {timeout!r}")
        if env.event_bus is None:
            raise RPCError(-32603, "event bus unavailable; use broadcast_tx_sync")
        import os as _os

        h = tx_hash(raw)
        # unique per request: concurrent re-submissions of the SAME tx
        # must not collide on the subscriber name
        subscriber = f"tx-commit-{h.hex()[:16]}-{_os.urandom(4).hex()}"
        sub = env.event_bus.subscribe(subscriber, f"tm.event = 'Tx' AND tx.hash = '{h.hex().upper()}'")
        try:
            try:
                check = env.mempool.check_tx(raw, sender="")
            except Exception as e:
                if is_fault(e):
                    raise env.fault(e) from e
                return {"check_tx": {"code": 1, "log": str(e)}, "hash": _hex(h)}
            if check.code != abci.CODE_TYPE_OK:
                return {"check_tx": tx_result_to_json(check), "hash": _hex(h)}
            deadline = _time.monotonic() + float(timeout)
            while _time.monotonic() < deadline:
                msg = sub.next(timeout=0.25)
                if msg is None:
                    continue
                data = msg.data
                return {
                    "check_tx": tx_result_to_json(check),
                    "tx_result": tx_result_to_json(data.result),
                    "hash": _hex(h),
                    "height": str(data.height),
                }
            raise RPCError(-32603, "timed out waiting for tx to be included in a block")
        finally:
            env.event_bus.unsubscribe_all(subscriber)

    def check_tx(tx=None):
        """Run CheckTx without inserting into the mempool."""
        raw = _as_bytes_hex(tx, "tx")
        res = env.app_client.check_tx(abci.RequestCheckTx(tx=raw, type=0))
        return tx_result_to_json(res)

    def unconfirmed_txs(page=1, per_page=30):
        """Paginated mempool contents."""
        txs = [w.tx for w in env.mempool.all_txs()]
        page_i = max(1, _as_int(page, "page") or 1)
        per = min(100, max(1, _as_int(per_page, "per_page") or 30))
        sel = txs[(page_i - 1) * per : (page_i - 1) * per + per]
        return {
            "count": str(len(sel)),
            "total": str(len(txs)),
            "total_bytes": str(env.mempool.total_bytes()),
            "txs": [_b64(t) for t in sel],
        }

    def num_unconfirmed_txs():
        """Mempool size and byte totals."""
        return {
            "count": str(env.mempool.size()),
            "total": str(env.mempool.size()),
            "total_bytes": str(env.mempool.total_bytes()),
        }

    def tx(hash=None, prove=False):
        """Indexed transaction by hash, optional inclusion proof."""
        if env.tx_indexer is None:
            raise RPCError(-32603, "transaction indexing is disabled")
        h = _as_bytes_hex(hash, "hash")
        doc = env.tx_indexer.get_tx_by_hash(h)
        if doc is None:
            raise RPCError(ERR_TX_NOT_FOUND, f"tx {h.hex().upper()} not found")
        return {
            "hash": _hex(h),
            "height": str(doc["height"]),
            "index": doc["index"],
            "tx_result": {
                "code": doc["code"],
                "log": doc["log"],
                "gas_wanted": str(doc["gas_wanted"]),
                "gas_used": str(doc["gas_used"]),
                "events": doc["events"],
            },
            "tx": _b64(bytes.fromhex(doc["tx"])),
        }

    def tx_search(query=None, prove=False, page=1, per_page=30, order_by="asc"):
        """Query the tx index (events query language), paginated."""
        if env.tx_indexer is None:
            raise RPCError(-32603, "transaction indexing is disabled")
        q = parse_query(query or "")
        docs = env.tx_indexer.search_tx_events(q, limit=10_000)
        if order_by == "desc":
            docs = list(reversed(docs))
        page_i = max(1, _as_int(page, "page") or 1)
        per = min(100, max(1, _as_int(per_page, "per_page") or 30))
        sel = docs[(page_i - 1) * per : (page_i - 1) * per + per]
        return {
            "txs": [
                {
                    "hash": _hex(tx_hash(bytes.fromhex(d["tx"]))),
                    "height": str(d["height"]),
                    "index": d["index"],
                    "tx_result": {"code": d["code"], "log": d["log"], "events": d["events"]},
                    "tx": _b64(bytes.fromhex(d["tx"])),
                }
                for d in sel
            ],
            "total_count": str(len(docs)),
        }

    def block_search(query=None, page=1, per_page=30, order_by="asc"):
        """Query the block index (events query language), paginated."""
        if env.tx_indexer is None:
            raise RPCError(-32603, "block indexing is disabled")
        q = parse_query(query or "")
        heights = env.tx_indexer.search_block_events(q, limit=10_000)
        if order_by == "desc":
            heights = list(reversed(heights))
        page_i = max(1, _as_int(page, "page") or 1)
        per = min(100, max(1, _as_int(per_page, "per_page") or 30))
        sel = heights[(page_i - 1) * per : (page_i - 1) * per + per]
        blocks = []
        for h in sel:
            meta = env.block_store.load_block_meta(h)
            blk = env.block_store.load_block(h)
            if meta and blk:
                blocks.append({"block_id": block_id_to_json(meta.block_id), "block": block_to_json(blk)})
        return {"blocks": blocks, "total_count": str(len(heights))}

    # ------------------------------------------------------------ evidence

    def broadcast_evidence(evidence=None):
        """Submit verified misbehavior evidence."""
        from ..proto import messages as pb
        from ..types.evidence import evidence_from_proto

        if env.evidence_pool is None:
            raise RPCError(-32603, "evidence pool unavailable")
        raw = _as_bytes_hex(evidence, "evidence")
        ev = evidence_from_proto(pb.Evidence.decode(raw))
        try:
            env.evidence_pool.add_evidence(ev)
        except Exception as e:
            if is_fault(e):
                raise env.fault(e) from e
            raise
        return {"hash": _hex(ev.hash())}

    # ----------------------------------------------------------------- abci

    def abci_query(path="", data="", height=0, prove=False):
        """App-level query through ABCI Query."""
        raw = _as_bytes_hex(data, "data") if data else b""
        res = env.app_client.query(
            abci.RequestQuery(data=raw, path=path, height=_as_int(height, "height") or 0, prove=bool(prove))
        )
        return {
            "response": {
                "code": res.code,
                "log": res.log,
                "info": res.info,
                "index": str(res.index),
                "key": _b64(res.key),
                "value": _b64(res.value),
                "height": str(res.height),
                "codespace": res.codespace,
            }
        }

    def abci_info():
        """App name/version/height via ABCI Info."""
        res = env.app_client.info(abci.RequestInfo())
        return {
            "response": {
                "data": res.data,
                "version": res.version,
                "app_version": str(res.app_version),
                "last_block_height": str(res.last_block_height),
                "last_block_app_hash": _b64(res.last_block_app_hash),
            }
        }

    routes = {
        "health": health,
        "status": status,
        "net_info": net_info,
        "genesis": genesis,
        "genesis_chunked": genesis_chunked,
        "blockchain": blockchain,
        "block": block,
        "block_by_hash": block_by_hash,
        "header": header,
        "header_by_hash": header_by_hash,
        "events": events,
        "debug_threads": debug_threads,
        "dump_traces": dump_traces,
        "flight_recorder": flight_recorder,
        "device_stats": device_stats,
        "block_results": block_results,
        "commit": commit,
        "proofs_batch": proofs_batch,
        "light_batch": light_batch,
        "state_batch": state_batch,
        "validators": validators,
        "consensus_params": consensus_params,
        "consensus_state": consensus_state,
        "dump_consensus_state": dump_consensus_state,
        "broadcast_tx_async": broadcast_tx_async,
        "broadcast_tx_sync": broadcast_tx_sync,
        # ref: routes.go:62 — broadcast_tx is the modern alias of the
        # sync variant
        "broadcast_tx": broadcast_tx_sync,
        "remove_tx": remove_tx,
        "broadcast_tx_commit": broadcast_tx_commit,
        "check_tx": check_tx,
        "unconfirmed_txs": unconfirmed_txs,
        "num_unconfirmed_txs": num_unconfirmed_txs,
        "tx": tx,
        "tx_search": tx_search,
        "block_search": block_search,
        "broadcast_evidence": broadcast_evidence,
        "abci_query": abci_query,
        "abci_info": abci_info,
    }
    if env.unsafe:
        routes.update(_unsafe_routes(env))
    return routes


def _unsafe_routes(env: RPCEnvironment) -> dict:
    """Routes behind rpc.unsafe (ref: routes.go:75-79 RPCUnsafe +
    config.go:429). unsafe_partition/unsafe_heal are the fault-injection
    hooks the e2e runner drives for REAL per-link network partitions
    (the analog of the reference's container-level docker network
    disconnect, test/e2e/runner/perturb.go:40-72)."""

    def unsafe_flush_mempool():
        """ref: UnsafeFlushMempool (internal/rpc/core/mempool.go:185)."""
        if env.mempool is None:
            raise RPCError(ERR_INTERNAL, "mempool not configured")
        env.mempool.flush()
        return {}

    def unsafe_partition(peers=None):
        """Veto connections to the given peer ids (asymmetric partition:
        only this node refuses). peers: list of hex node ids."""
        if env.router is None:
            raise RPCError(ERR_INTERNAL, "router not configured")
        if not isinstance(peers, list) or not all(isinstance(p, str) for p in peers):
            raise RPCError(-32602, "peers must be a list of node id strings")
        env.router.set_peer_veto(peers)
        return {"vetoed": sorted(env.router.peer_veto)}

    def unsafe_heal():
        """Lift every partition veto."""
        if env.router is None:
            raise RPCError(ERR_INTERNAL, "router not configured")
        env.router.set_peer_veto(())
        return {}

    return {
        "unsafe_flush_mempool": unsafe_flush_mempool,
        "unsafe_partition": unsafe_partition,
        "unsafe_heal": unsafe_heal,
    }
