"""HTTP light-block provider — fetches signed headers + validator sets
from a node's RPC (ref: light/provider/http/http.go)."""

from __future__ import annotations

import base64

from ..rpc.client import HTTPClient, RPCClientError
from ..types.block import (
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
)
from ..types.light_block import LightBlock, SignedHeader
from ..types.validator_set import Validator, ValidatorSet
from ..utils.tmtime import Time
from .provider import ErrLightBlockNotFound, ErrNoResponse, Provider


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s) if s else b""


def _unb64(s: str) -> bytes:
    return base64.b64decode(s) if s else b""


def _time(s: str) -> Time:
    return Time.parse_rfc3339(s) if s else Time()


def _block_id(d: dict) -> BlockID:
    return BlockID(
        hash=_unhex(d.get("hash", "")),
        part_set_header=PartSetHeader(
            total=int(d.get("parts", {}).get("total", 0)),
            hash=_unhex(d.get("parts", {}).get("hash", "")),
        ),
    )


def header_from_json(d: dict) -> Header:
    return Header(
        version_block=int(d["version"]["block"]),
        version_app=int(d["version"]["app"]),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=_time(d["time"]),
        last_block_id=_block_id(d.get("last_block_id", {})),
        last_commit_hash=_unhex(d.get("last_commit_hash", "")),
        data_hash=_unhex(d.get("data_hash", "")),
        validators_hash=_unhex(d.get("validators_hash", "")),
        next_validators_hash=_unhex(d.get("next_validators_hash", "")),
        consensus_hash=_unhex(d.get("consensus_hash", "")),
        app_hash=_unhex(d.get("app_hash", "")),
        last_results_hash=_unhex(d.get("last_results_hash", "")),
        evidence_hash=_unhex(d.get("evidence_hash", "")),
        proposer_address=_unhex(d.get("proposer_address", "")),
    )


def commit_from_json(d: dict) -> Commit:
    return Commit(
        height=int(d["height"]),
        round=int(d["round"]),
        block_id=_block_id(d["block_id"]),
        signatures=[
            CommitSig(
                block_id_flag=int(s["block_id_flag"]),
                validator_address=_unhex(s.get("validator_address", "")),
                timestamp=_time(s.get("timestamp", "")),
                signature=_unb64(s.get("signature", "")),
            )
            for s in d.get("signatures", [])
        ],
    )


def validator_set_from_json(vals: list[dict]) -> ValidatorSet:
    from ..crypto.ed25519 import Ed25519PubKey

    out = []
    for v in vals:
        pk = Ed25519PubKey(_unb64(v["pub_key"]["value"]))
        out.append(
            Validator(
                address=_unhex(v["address"]),
                pub_key=pk,
                voting_power=int(v["voting_power"]),
                proposer_priority=int(v.get("proposer_priority", 0)),
            )
        )
    vs = ValidatorSet(out)
    # trust the served priorities; recompute the proposer pointer
    if out:
        vs.proposer = min(out, key=lambda v: (-v.proposer_priority, v.address))
    return vs


class HTTPProvider(Provider):
    """ref: light/provider/http/http.go."""

    def __init__(self, chain_id: str, base_url: str, timeout: float = 10.0):
        self._chain_id = chain_id
        self.client = HTTPClient(base_url, timeout=timeout)
        self.base_url = base_url
        # tmproof: whether the server speaks light_batch (one round
        # trip per verification step). Probed on the first fetch; a
        # pre-tmproof server answers Method-not-found ONCE and the
        # provider pages commit+validators forever after.
        self._light_batch_ok: bool | None = None

    def chain_id(self) -> str:
        return self._chain_id

    def id(self) -> str:
        return f"http{{{self.base_url}}}"

    def _fetch_light_batch(self, height: int) -> tuple[dict, list[dict]] | None:
        """(signed_header json, validators json) via the batched route,
        or None when the server predates it. Method-not-found is
        resolved HERE — the caller's not-found error mapping must never
        see the string 'Method not found' (it pattern-matches
        'not found' for missing-height errors)."""
        try:
            res = self.client.call("light_batch", height=height or None)
        except RPCClientError as e:
            if e.code == -32601:
                self._light_batch_ok = False
                return None
            raise
        self._light_batch_ok = True
        return res["signed_header"], list(res["validators"])

    def light_block(self, height: int) -> LightBlock:
        try:
            batched = (
                self._fetch_light_batch(height)
                if self._light_batch_ok is not False
                else None
            )
            if batched is not None:
                signed_header, vals = batched
            else:
                commit_res = self.client.commit(height=height or None)
                signed_header = commit_res["signed_header"]
                h = int(signed_header["header"]["height"])
                vals_res = self.client.validators(height=h, per_page=100)
                vals = list(vals_res["validators"])
                total = int(vals_res["total"])
                page = 2
                while len(vals) < total:
                    more = self.client.validators(height=h, page=page, per_page=100)
                    got = more["validators"]
                    if not got:
                        break
                    vals.extend(got)
                    page += 1
        except RPCClientError as e:
            if "must be less than or equal" in str(e) or "not found" in str(e):
                raise ErrLightBlockNotFound(str(e))
            raise ErrNoResponse(str(e))
        except OSError as e:
            raise ErrNoResponse(str(e))
        return LightBlock(
            signed_header=SignedHeader(
                header=header_from_json(signed_header["header"]),
                commit=commit_from_json(signed_header["commit"]),
            ),
            validator_set=validator_set_from_json(vals),
        )

    def report_evidence(self, ev) -> None:
        import sys

        from ..types.evidence import evidence_to_proto

        try:
            # oneof wrapper: the RPC handler decodes pb.Evidence
            self.client.broadcast_evidence(evidence=evidence_to_proto(ev).encode().hex())
        except (RPCClientError, OSError) as e:
            # network/server failure only — programming errors must surface
            print(f"light: failed to report evidence to {self.base_url}: {e}", file=sys.stderr)
