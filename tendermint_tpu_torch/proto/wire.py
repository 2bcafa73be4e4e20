"""Protobuf wire-format primitives.

The subset of the protobuf wire format canonical sign bytes need, implemented
deterministically (ascending field tags, proto3 zero-value omission) so that
canonical sign-bytes match the reference byte for byte
(ref: internal/libs/protoio/writer.go, types/canonical.go).
"""

from __future__ import annotations

import struct

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5

_U64_MASK = (1 << 64) - 1


def encode_varint(value: int) -> bytes:
    """Encode an unsigned (or two's-complement negative int64) varint."""
    if value < 0:
        value &= _U64_MASK  # negative int64 → 10-byte varint, proto semantics
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode a varint at `offset`; returns (value, new_offset)."""
    result = 0
    shift = 0
    pos = offset
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result > _U64_MASK:
                raise ValueError("varint overflows 64 bits")
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def varint_to_int64(value: int) -> int:
    """Reinterpret a decoded u64 varint as a signed int64."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def encode_zigzag(value: int) -> bytes:
    return encode_varint((value << 1) ^ (value >> 63))


def decode_zigzag(buf: bytes, offset: int = 0) -> tuple[int, int]:
    raw, pos = decode_varint(buf, offset)
    return (raw >> 1) ^ -(raw & 1), pos


def encode_tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def decode_tag(buf: bytes, offset: int = 0) -> tuple[int, int, int]:
    raw, pos = decode_varint(buf, offset)
    return raw >> 3, raw & 0x07, pos


def encode_fixed64(value: int) -> bytes:
    return struct.pack("<q", value)


def decode_fixed64(buf: bytes, offset: int = 0) -> tuple[int, int]:
    if offset + 8 > len(buf):
        raise ValueError("truncated fixed64")
    return struct.unpack_from("<q", buf, offset)[0], offset + 8


def encode_fixed32(value: int) -> bytes:
    return struct.pack("<i", value)


def decode_fixed32(buf: bytes, offset: int = 0) -> tuple[int, int]:
    if offset + 4 > len(buf):
        raise ValueError("truncated fixed32")
    return struct.unpack_from("<i", buf, offset)[0], offset + 4


def encode_bytes(value: bytes) -> bytes:
    return encode_varint(len(value)) + value


def decode_bytes(buf: bytes, offset: int = 0) -> tuple[bytes, int]:
    n, pos = decode_varint(buf, offset)
    if pos + n > len(buf):
        raise ValueError("truncated length-delimited field")
    return bytes(buf[pos : pos + n]), pos + n


def marshal_delimited(payload: bytes) -> bytes:
    """Varint length-prefix a message (ref: protoio.MarshalDelimited)."""
    return encode_varint(len(payload)) + payload


def unmarshal_delimited(buf: bytes, offset: int = 0) -> tuple[bytes, int]:
    return decode_bytes(buf, offset)


def read_delimited(read_exact, max_size: int) -> bytes:
    """Read one uvarint-length-delimited message from a stream exposing
    `read_exact(n) -> bytes` (ref: internal/libs/protoio ReadDelimited).

    Not resumable: a timeout mid-message leaves consumed plaintext
    unrecoverable, so callers treat it as fatal for the connection."""
    prefix = b""
    while True:
        prefix += read_exact(1)
        if prefix[-1] < 0x80:
            break
        if len(prefix) > 5:
            raise ValueError("oversized length prefix")
    size, _ = decode_varint(prefix, 0)
    if size > max_size:
        raise ValueError(f"delimited message too large: {size}")
    return read_exact(size)
