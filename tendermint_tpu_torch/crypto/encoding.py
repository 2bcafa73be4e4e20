"""Proto PublicKey <-> domain PubKey codec (ref: crypto/encoding/codec.go)."""

from __future__ import annotations

from ..proto import messages as pb
from . import PubKey
from .ed25519 import Ed25519PubKey
from .secp256k1 import Secp256k1PubKey
from .sr25519 import Sr25519PubKey


def pubkey_to_proto(pk: PubKey) -> pb.PublicKey:
    if pk.type_name == "ed25519":
        return pb.PublicKey(ed25519=pk.bytes())
    if pk.type_name == "secp256k1":
        return pb.PublicKey(secp256k1=pk.bytes())
    if pk.type_name == "sr25519":
        return pb.PublicKey(sr25519=pk.bytes())
    raise ValueError(f"unsupported key type {pk.type_name}")


def pubkey_from_proto(p: pb.PublicKey) -> PubKey:
    name, data = p.sum
    if name == "ed25519":
        return Ed25519PubKey(data)
    if name == "secp256k1":
        return Secp256k1PubKey(data)
    if name == "sr25519":
        return Sr25519PubKey(data)
    raise ValueError(f"unsupported proto pubkey arm {name!r}")
