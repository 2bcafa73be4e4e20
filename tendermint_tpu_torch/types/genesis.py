"""GenesisDoc (ref: types/genesis.go): the genesis file's document, read
and written in the reference's JSON, with validators of all three key
types."""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from ..crypto import PubKey
from ..crypto.ed25519 import Ed25519PubKey
from ..utils.tmtime import Time
from .params import ConsensusParams, default_consensus_params
from .validator_set import Validator

MAX_CHAIN_ID_LEN = 50  # ref: types/genesis.go:25


@dataclass
class GenesisValidator:
    address: bytes
    pub_key: PubKey
    power: int
    name: str = ""


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Time = field(default_factory=Time.now)
    initial_height: int = 1
    consensus_params: ConsensusParams | None = None
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b""

    def validate_and_complete(self) -> None:
        """ref: GenesisDoc.ValidateAndComplete (types/genesis.go:62)."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError(f"initial_height cannot be negative (got {self.initial_height})")
        if self.initial_height == 0:
            self.initial_height = 1
        if self.consensus_params is None:
            self.consensus_params = default_consensus_params()
        else:
            self.consensus_params.validate_consensus_params()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(f"genesis file cannot contain validators with no voting power: {v}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {i} in the genesis file")
            if not v.address:
                v.address = v.pub_key.address()
        if self.genesis_time.is_zero():
            self.genesis_time = Time.now()

    def validator_set(self) -> list[Validator]:
        return [Validator.new(v.pub_key, v.power) for v in self.validators]

    # -- JSON round-trip (the genesis file format) ------------------------

    def to_json(self) -> str:
        doc = {
            "genesis_time": self.genesis_time.rfc3339(),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": _params_to_json(self.consensus_params or default_consensus_params()),
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {"type": _PUBKEY_JSON_TYPES[v.pub_key.type_name], "value": _b64(v.pub_key.bytes())},
                    "power": str(v.power),
                    "name": v.name,
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state:
            doc["app_state"] = json.loads(self.app_state.decode())
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        doc = json.loads(data)
        validators = []
        for v in doc.get("validators") or []:
            ktype = v["pub_key"].get("type", "tendermint/PubKeyEd25519")
            if ktype == "tendermint/PubKeySecp256k1":
                from ..crypto.secp256k1 import Secp256k1PubKey

                pk = Secp256k1PubKey(_unb64(v["pub_key"]["value"]))
            elif ktype == "tendermint/PubKeySr25519":
                from ..crypto.sr25519 import Sr25519PubKey

                pk = Sr25519PubKey(_unb64(v["pub_key"]["value"]))
            elif ktype == "tendermint/PubKeyEd25519":
                pk = Ed25519PubKey(_unb64(v["pub_key"]["value"]))
            else:
                # fail fast, as the reference's jsontypes decoding does: a
                # mis-parsed key type would yield a bogus validator set
                raise ValueError(f"unsupported genesis validator key type {ktype!r}")
            validators.append(
                GenesisValidator(
                    address=bytes.fromhex(v["address"]) if v.get("address") else pk.address(),
                    pub_key=pk,
                    power=int(v["power"]),
                    name=v.get("name", ""),
                )
            )
        app_state = doc.get("app_state")
        gd = cls(
            chain_id=doc["chain_id"],
            genesis_time=Time.parse_rfc3339(doc["genesis_time"]) if doc.get("genesis_time") else Time(),
            initial_height=int(doc.get("initial_height", 1)),
            consensus_params=_params_from_json(doc.get("consensus_params")),
            validators=validators,
            app_hash=bytes.fromhex(doc.get("app_hash", "")),
            app_state=json.dumps(app_state).encode() if app_state is not None else b"",
        )
        gd.validate_and_complete()
        return gd

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())

    def hash(self) -> bytes:
        """Stable digest of the genesis document (used for chunked RPC)."""
        return hashlib.sha256(self.to_json().encode()).digest()


# Amino-era JSON type tags (ref: jsontypes registrations in crypto/*)
_PUBKEY_JSON_TYPES = {
    "ed25519": "tendermint/PubKeyEd25519",
    "secp256k1": "tendermint/PubKeySecp256k1",
    "sr25519": "tendermint/PubKeySr25519",
}


def _b64(data: bytes) -> str:
    import base64

    return base64.b64encode(data).decode()


def _unb64(s: str) -> bytes:
    import base64

    return base64.b64decode(s)


def _params_to_json(p: ConsensusParams) -> dict:
    return {
        "block": {"max_bytes": str(p.block.max_bytes), "max_gas": str(p.block.max_gas)},
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration),
            "max_bytes": str(p.evidence.max_bytes),
        },
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "version": {"app_version": str(p.version.app_version)},
        "synchrony": {
            "precision": str(p.synchrony.precision),
            "message_delay": str(p.synchrony.message_delay),
        },
        "timeout": {
            "propose": str(p.timeout.propose),
            "propose_delta": str(p.timeout.propose_delta),
            "vote": str(p.timeout.vote),
            "vote_delta": str(p.timeout.vote_delta),
            "commit": str(p.timeout.commit),
            "bypass_commit_timeout": p.timeout.bypass_commit_timeout,
        },
        "abci": {
            "vote_extensions_enable_height": str(p.abci.vote_extensions_enable_height),
            "recheck_tx": p.abci.recheck_tx,
        },
    }


def _params_from_json(doc: dict | None) -> ConsensusParams | None:
    if doc is None:
        return None
    from .params import (
        ABCIParams,
        BlockParams,
        EvidenceParams,
        SynchronyParams,
        TimeoutParams,
        ValidatorParams,
        VersionParams,
    )

    def geti(section: dict, key: str, default: int) -> int:
        v = section.get(key)
        return default if v is None else int(v)

    b = doc.get("block", {})
    e = doc.get("evidence", {})
    v = doc.get("validator", {})
    ver = doc.get("version", {})
    s = doc.get("synchrony", {})
    t = doc.get("timeout", {})
    a = doc.get("abci", {})
    d = ConsensusParams()
    return ConsensusParams(
        block=BlockParams(
            max_bytes=geti(b, "max_bytes", d.block.max_bytes), max_gas=geti(b, "max_gas", d.block.max_gas)
        ),
        evidence=EvidenceParams(
            max_age_num_blocks=geti(e, "max_age_num_blocks", d.evidence.max_age_num_blocks),
            max_age_duration=geti(e, "max_age_duration", d.evidence.max_age_duration),
            max_bytes=geti(e, "max_bytes", d.evidence.max_bytes),
        ),
        validator=ValidatorParams(pub_key_types=tuple(v.get("pub_key_types") or ("ed25519",))),
        version=VersionParams(app_version=geti(ver, "app_version", 0)),
        synchrony=SynchronyParams(
            precision=geti(s, "precision", d.synchrony.precision),
            message_delay=geti(s, "message_delay", d.synchrony.message_delay),
        ),
        timeout=TimeoutParams(
            propose=geti(t, "propose", d.timeout.propose),
            propose_delta=geti(t, "propose_delta", d.timeout.propose_delta),
            vote=geti(t, "vote", d.timeout.vote),
            vote_delta=geti(t, "vote_delta", d.timeout.vote_delta),
            commit=geti(t, "commit", d.timeout.commit),
            bypass_commit_timeout=bool(t.get("bypass_commit_timeout", False)),
        ),
        abci=ABCIParams(
            vote_extensions_enable_height=geti(a, "vote_extensions_enable_height", 0),
            recheck_tx=bool(a.get("recheck_tx", True)),
        ),
    )
