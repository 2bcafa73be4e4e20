"""Deterministic protobuf wire runtime and the message schemas that canonical
vote sign bytes, header and commit hashes, validator sets and light blocks
need (byte-identical to the reference node's encoding,
types/canonical.go:57, types/vote.go:149)."""

from .message import Field, Message  # noqa: F401
from .wire import encode_varint, encode_tag  # noqa: F401
