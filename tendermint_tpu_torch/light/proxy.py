"""Light proxy — an RPC façade backed by the light client
(ref: light/proxy/proxy.go + light/rpc/client.go).

Serves the node's JSON-RPC surface locally while routing data through a
verifying light client: header-bearing results (block, commit, header,
validators) are checked against light-client-verified headers before
being returned; pass-through calls (broadcast_tx*, abci_query, status)
are forwarded to the primary untouched, with status' latest-block info
rewritten to the verified view.
"""

from __future__ import annotations

import base64
import hashlib
import time as _time

from ..rpc.client import HTTPClient
from ..rpc.server import JSONRPCServer, RPCError
from ..types.block import BlockID, Header, PartSetHeader, txs_hash
from ..utils.log import new_logger
from ..utils.tmtime import Time


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _header_from_json(d: dict) -> Header:
    """Inverse of rpc.core.header_to_json — the proxy must RECOMPUTE
    hashes from the primary's response, never trust its self-reported
    block_id (ref: light/rpc/client.go Block recomputes res.Block.Hash())."""
    hx = lambda s: bytes.fromhex(s) if s else b""
    lbi = d.get("last_block_id") or {}
    parts = lbi.get("parts") or {}
    return Header(
        version_block=int(d["version"]["block"]),
        version_app=int(d["version"].get("app") or 0),
        chain_id=d.get("chain_id", ""),
        height=int(d["height"]),
        time=Time.parse_rfc3339(d["time"]),
        last_block_id=BlockID(
            hash=hx(lbi.get("hash")),
            part_set_header=PartSetHeader(total=parts.get("total") or 0, hash=hx(parts.get("hash"))),
        ),
        last_commit_hash=hx(d.get("last_commit_hash")),
        data_hash=hx(d.get("data_hash")),
        validators_hash=hx(d.get("validators_hash")),
        next_validators_hash=hx(d.get("next_validators_hash")),
        consensus_hash=hx(d.get("consensus_hash")),
        app_hash=hx(d.get("app_hash")),
        last_results_hash=hx(d.get("last_results_hash")),
        evidence_hash=hx(d.get("evidence_hash")),
        proposer_address=hx(d.get("proposer_address")),
    )


class LightProxy:
    """ref: light/proxy/proxy.go Proxy."""

    # divergence-report ring bound: enough to show the attack shape
    # without an adversary growing proxy memory without limit
    MAX_DIVERGENCES = 256

    def __init__(self, client, primary_addr: str, host: str = "127.0.0.1", port: int = 0, logger=None):
        self.client = client  # LightClient
        self.primary = HTTPClient(primary_addr)
        self.logger = logger or new_logger("light-proxy")
        # every refused relay, newest last: [{"at": unix_s, "msg": ...}]
        # — the tmbyz divergence report (docs/byzantine.md); a forged
        # header from the primary must land HERE, never in a response
        self.divergences: list[dict] = []
        self.divergence_count = 0
        self.server = JSONRPCServer(self._routes(), host=host, port=port)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    @property
    def address(self) -> tuple[str, int]:
        return self.server.address

    # ------------------------------------------------------------ helpers

    def _verified_header(self, height: int):
        """Light-verify the chain up to `height` and return the trusted
        light block (ref: light/rpc/client.go updateLightClientIfNeededTo)."""
        lb = self.client.verify_light_block_at_height(int(height))
        return lb

    @staticmethod
    def _check_input(cond: bool, msg: str) -> None:
        """Client-input validation — a caller mistake, not a primary
        divergence (kept out of the divergence report)."""
        if not cond:
            raise RPCError(-32603, f"light proxy verification failed: {msg}")

    def record_divergence(self, msg: str) -> None:
        """One refused primary response. Also the entry point for the
        host's update loop (cli.py cmd_light): a forged header caught
        by bisection verification is the same attack surface as a
        forged relay, and belongs in the same report."""
        self.divergence_count += 1
        self.divergences.append({"at": _time.time(), "msg": msg})
        del self.divergences[: -self.MAX_DIVERGENCES]
        self.logger.error(f"divergence: {msg}")

    def _require(self, cond: bool, msg: str) -> None:
        if not cond:
            self.record_divergence(msg)
            raise RPCError(-32603, f"light proxy verification failed: {msg}")

    def divergence_report(self) -> dict:
        """The proxy's half of the tmbyz divergence report: refusals it
        issued instead of relaying unverifiable primary responses."""
        return {
            "divergences": self.divergence_count,
            "recent": list(self.divergences),
        }

    # ------------------------------------------------------------ routes

    def _routes(self) -> dict:
        def status():
            res = self.primary.call("status")
            head = self.client.update() or self.client.latest_trusted()
            if head is not None:
                res["sync_info"]["latest_block_height"] = str(head.height)
                res["sync_info"]["latest_block_hash"] = head.signed_header.hash().hex().upper()
            return res

        def block(height=None):
            self._check_input(height is not None, "light proxy requires an explicit height")
            res = self.primary.call("block", height=str(height))
            lb = self._verified_header(int(height))
            want = lb.signed_header.hash()
            # RECOMPUTE the hash from the returned header — the primary's
            # self-reported block_id is attacker-controlled
            try:
                hdr = _header_from_json(res["block"]["header"])
            except Exception as e:
                raise RPCError(-32603, f"light proxy: malformed block from primary: {e}")
            got = hdr.hash() or b""
            self._require(got == want, f"primary returned block {got.hex()} != verified {want.hex()}")
            # and the tx payload must match the header's own data_hash
            txs = [base64.b64decode(t) for t in (res["block"].get("data") or {}).get("txs") or []]
            self._require(
                txs_hash(txs) == hdr.data_hash,
                "primary block txs do not hash to the header's data_hash",
            )
            # never relay the primary's self-reported block_id — rebuild
            # it from the light-verified commit
            from ..rpc.core import block_id_to_json

            res["block_id"] = block_id_to_json(lb.signed_header.commit.block_id)
            return res

        def commit(height=None):
            """Serve the LIGHT-VERIFIED signed header directly — the
            client already holds a commit whose signatures were checked
            against the validator set; relaying the primary's commit body
            would hand back attacker-controlled signatures
            (ref: light/rpc/client.go Commit serves the trusted copy for
            verified heights)."""
            self._check_input(height is not None, "light proxy requires an explicit height")
            lb = self._verified_header(int(height))
            sh = lb.signed_header
            from ..rpc.core import commit_to_json, header_to_json

            return {
                "signed_header": {
                    "header": header_to_json(sh.header),
                    "commit": commit_to_json(sh.commit),
                },
                "canonical": True,
            }

        def header(height=None):
            self._check_input(height is not None, "light proxy requires an explicit height")
            lb = self._verified_header(int(height))
            h = lb.signed_header.header
            return {
                "header": {
                    "chain_id": h.chain_id,
                    "height": str(h.height),
                    "time": h.time.rfc3339(),
                    "app_hash": h.app_hash.hex().upper(),
                    "validators_hash": h.validators_hash.hex().upper(),
                    "next_validators_hash": h.next_validators_hash.hex().upper(),
                    "proposer_address": h.proposer_address.hex().upper(),
                    "last_block_id": {"hash": h.last_block_id.hash.hex().upper()},
                }
            }

        def _relay_verified_proofs(height, indices, route: str) -> dict:
            """Relay the primary's batched multiproof ONLY after it
            verifies against the light-verified header's data_hash —
            the primary's tree root, leaf hashes, and shared nodes are
            all attacker-controlled until they reconstruct the verified
            root (tmproof gateway, docs/observability.md#tmproof).
            Counts served/batch-size under `route` (matching the
            full-node gateway's labeling for nested light_batch
            serves); the caller owns serve_seconds."""
            from ..metrics import proof_metrics
            from ..rpc.core import multiproof_from_json

            # client-input validation FIRST, with the full-node route's
            # error semantics (-32602): bad params must never be
            # misreported as a primary fault after a wasted round trip
            if not isinstance(indices, (list, tuple)) or not indices:
                raise RPCError(-32602, "indices must be a non-empty list of tx indices")
            try:
                req_idxs = [int(i) for i in indices]
            except (TypeError, ValueError):
                raise RPCError(-32602, f"invalid indices: {indices!r}")
            lb = self._verified_header(int(height))
            res = self.primary.call("proofs_batch", height=str(height), indices=indices)
            try:
                mp = multiproof_from_json(res.get("multiproof") or {})
                txs = [base64.b64decode(t) for t in res.get("txs") or []]
            except Exception as e:
                raise RPCError(-32603, f"light proxy: malformed multiproof from primary: {e}")
            # a validly-proven but DIFFERENT index set is still a
            # substitution attack: the proof must cover exactly what
            # the client asked for, not whatever the primary chose
            self._require(
                mp.indices == req_idxs,
                "primary returned proofs for different indices than requested",
            )
            want = lb.signed_header.header.data_hash
            self._require(
                mp.verify(want, [_sha256(tx) for tx in txs]),
                "primary multiproof does not verify against the verified data_hash",
            )
            # never relay the primary's self-reported root
            res["root"] = want.hex().upper()
            m = proof_metrics()
            m.served.add(len(mp.indices), route, "proxy")
            m.batch_size.observe(len(mp.indices))
            return res

        def proofs_batch(height=None, indices=None):
            """k verified tx inclusion proofs relayed from the primary
            (tmproof gateway behind the verified-header store)."""
            from ..metrics import proof_metrics

            self._check_input(height is not None, "light proxy requires an explicit height")
            t0 = _time.perf_counter()
            res = _relay_verified_proofs(height, indices, "proofs_batch")
            proof_metrics().serve_seconds.observe(_time.perf_counter() - t0, "proofs_batch")
            return res

        def light_batch(height=None, indices=None):
            """One verification step served from the proxy's OWN
            verified-header store: the light-verified signed header +
            the validator set whose signatures were already checked —
            never the primary's copies. Heights past the verified head
            are refused (a verifying proxy must not relay what it
            cannot verify)."""
            from ..rpc.core import commit_to_json, header_to_json, validator_to_json

            self._check_input(height is not None, "light proxy requires an explicit height")
            t0 = _time.perf_counter()
            h = int(height)
            head = None
            try:
                head = self.client.update()
            except Exception:  # noqa: BLE001 - a dead primary: serve the stored head
                pass
            head = head or self.client.latest_trusted()
            self._require(
                head is not None and h <= head.height,
                f"height {h} is past the verified head "
                f"{head.height if head is not None else 0}",
            )
            lb = self._verified_header(h)
            out = {
                "signed_header": {
                    "header": header_to_json(lb.signed_header.header),
                    "commit": commit_to_json(lb.signed_header.commit),
                },
                "canonical": True,
                "validators": [validator_to_json(v) for v in lb.validator_set.validators],
                "total_validators": str(len(lb.validator_set.validators)),
            }
            if indices:
                out["proofs"] = _relay_verified_proofs(height, indices, "light_batch")
            from ..metrics import proof_metrics

            proof_metrics().serve_seconds.observe(_time.perf_counter() - t0, "light_batch")
            return out

        def state_batch(height=None, keys=None):
            """The light client's VERIFIED state read (tmstate,
            docs/state.md): relay the primary's batched account
            multiproof only after it reconstructs the app_hash of a
            light-verified header. Each leaf is key + "=" + value, so
            a substituted key OR value changes the leaf bytes and the
            proof stops verifying — the header_forge-style index
            substitution the tx plane refuses is refused here on state
            keys too. Heights past the verified head are refused."""
            from ..metrics import proof_metrics
            from ..rpc.core import multiproof_from_json

            self._check_input(height is not None, "light proxy requires an explicit height")
            # client-input validation FIRST with the full-node route's
            # -32602 semantics: caller mistakes are not divergences
            if not isinstance(keys, (list, tuple)) or not keys:
                raise RPCError(-32602, "keys must be a non-empty list of hex-encoded state keys")
            try:
                req_keys = [bytes.fromhex(k) for k in keys]
            except (TypeError, ValueError):
                raise RPCError(-32602, f"invalid state keys: {keys!r}")
            t0 = _time.perf_counter()
            h = int(height)
            head = None
            try:
                head = self.client.update()
            except Exception:  # noqa: BLE001 - a dead primary: serve the stored head
                pass
            head = head or self.client.latest_trusted()
            self._require(
                head is not None and h <= head.height,
                f"height {h} is past the verified head "
                f"{head.height if head is not None else 0}",
            )
            lb = self._verified_header(h)
            res = self.primary.call("state_batch", height=str(h), keys=list(keys))
            try:
                mp = multiproof_from_json(res.get("multiproof") or {})
                got_keys = [bytes.fromhex(k) for k in res.get("keys") or []]
                values = [bytes.fromhex(v) for v in res.get("values") or []]
            except Exception as e:
                raise RPCError(-32603, f"light proxy: malformed state proof from primary: {e}")
            # a validly-proven but DIFFERENT key set is a substitution
            # attack: the proof must cover exactly the requested keys
            self._require(
                got_keys == req_keys and len(values) == len(req_keys),
                "primary returned state proofs for different keys than requested",
            )
            want = lb.signed_header.header.app_hash
            self._require(
                mp.verify(want, [k + b"=" + v for k, v in zip(got_keys, values)]),
                "primary state multiproof does not verify against the verified app_hash",
            )
            # never relay the primary's self-reported root
            res["root"] = want.hex().upper()
            proof_metrics().serve_seconds.observe(_time.perf_counter() - t0, "state_batch")
            return res

        def validators(height=None):
            self._check_input(height is not None, "light proxy requires an explicit height")
            lb = self._verified_header(int(height))
            vs = lb.validator_set
            return {
                "block_height": str(lb.height),
                "validators": [
                    {
                        "address": v.address.hex().upper(),
                        "pub_key": {"type": v.pub_key.type_name, "value": base64.b64encode(v.pub_key.bytes()).decode()},
                        "voting_power": str(v.voting_power),
                    }
                    for v in vs.validators
                ],
                "count": str(len(vs.validators)),
                "total": str(len(vs.validators)),
            }

        def passthrough(method):
            def fn(**params):
                return self.primary.call(method, **params)
            return fn

        routes = {
            "status": status,
            "block": block,
            "commit": commit,
            "header": header,
            "proofs_batch": proofs_batch,
            "light_batch": light_batch,
            "state_batch": state_batch,
            "validators": validators,
        }
        for m in ("broadcast_tx_sync", "broadcast_tx_async", "broadcast_tx_commit",
                  "abci_query", "abci_info", "tx", "net_info", "health", "genesis",
                  "unconfirmed_txs", "num_unconfirmed_txs"):
            routes[m] = passthrough(m)
        return routes
