"""Declarative protobuf messages with deterministic (canonical) marshaling.

Encoding rules match gogo/protobuf proto3 marshaling as used by the
reference for sign-bytes (types/canonical.go, proto/tendermint/types/canonical.proto):
  - fields emitted in ascending field-number order
  - scalar zero values omitted (including sfixed64 zeros — see the golden
    vectors in the reference's types/vote_test.go:88-92)
  - non-nullable embedded messages always emitted; nullable ones omitted
    when None
  - repeated scalar numeric fields packed; repeated messages/bytes unpacked
"""

from __future__ import annotations

from . import wire

_SCALAR_DEFAULTS = {
    "int32": 0,
    "int64": 0,
    "uint32": 0,
    "uint64": 0,
    "sint32": 0,
    "sint64": 0,
    "bool": False,
    "enum": 0,
    "sfixed64": 0,
    "fixed64": 0,
    "sfixed32": 0,
    "fixed32": 0,
    "double": 0.0,
    "bytes": b"",
    "string": "",
}

_VARINT_TYPES = {"int32", "int64", "uint32", "uint64", "bool", "enum"}
_ZIGZAG_TYPES = {"sint32", "sint64"}
_FIXED64_TYPES = {"sfixed64", "fixed64", "double"}
_FIXED32_TYPES = {"sfixed32", "fixed32"}
_PACKABLE = _VARINT_TYPES | _ZIGZAG_TYPES | _FIXED64_TYPES | _FIXED32_TYPES


class Field:
    __slots__ = ("number", "ftype", "name", "repeated", "always_emit", "msg_cls")

    def __init__(self, number, ftype, name, repeated=False, always_emit=False, msg_cls=None):
        self.number = number
        self.ftype = ftype
        self.name = name
        self.repeated = repeated
        # always_emit mirrors gogoproto (gogoproto.nullable) = false on
        # embedded messages: the field is marshaled unconditionally.
        self.always_emit = always_emit
        self.msg_cls = msg_cls  # class or callable returning class (for cycles)

    def message_class(self):
        cls = self.msg_cls
        if cls is not None and not isinstance(cls, type):
            cls = cls()  # lazy thunk for recursive schemas
        return cls

    def default(self):
        if self.repeated:
            return []
        if self.ftype == "message":
            if self.always_emit:
                return self.message_class()()
            return None
        return _SCALAR_DEFAULTS[self.ftype]


def _encode_scalar(ftype: str, value) -> bytes:
    if ftype in _VARINT_TYPES:
        return wire.encode_varint(int(value))
    if ftype in _ZIGZAG_TYPES:
        return wire.encode_zigzag(int(value))
    if ftype == "sfixed64" or ftype == "fixed64":
        return wire.encode_fixed64(int(value))
    if ftype == "sfixed32" or ftype == "fixed32":
        return wire.encode_fixed32(int(value))
    if ftype == "bytes":
        return wire.encode_bytes(bytes(value))
    if ftype == "string":
        return wire.encode_bytes(value.encode("utf-8"))
    raise TypeError(f"unknown scalar type {ftype}")


def _wire_type(ftype: str) -> int:
    if ftype in _VARINT_TYPES or ftype in _ZIGZAG_TYPES:
        return wire.WIRE_VARINT
    if ftype in _FIXED64_TYPES:
        return wire.WIRE_FIXED64
    if ftype in _FIXED32_TYPES:
        return wire.WIRE_FIXED32
    return wire.WIRE_BYTES  # bytes, string, message


class Message:
    """Base class; subclasses set `fields = [Field(...), ...]`."""

    fields: list[Field] = []

    def __init__(self, **kwargs):
        cls = type(self)
        for f in cls.fields:
            setattr(self, f.name, kwargs.pop(f.name, None))
            if getattr(self, f.name) is None and not (f.ftype == "message" and not f.repeated and not f.always_emit):
                setattr(self, f.name, f.default())
        if kwargs:
            raise TypeError(f"{cls.__name__}: unknown fields {sorted(kwargs)}")

    # -- encoding ---------------------------------------------------------

    def encode(self) -> bytes:
        out = bytearray()
        for f in sorted(type(self).fields, key=lambda f: f.number):
            value = getattr(self, f.name)
            out += self._encode_field(f, value)
        return bytes(out)

    def encode_delimited(self) -> bytes:
        return wire.marshal_delimited(self.encode())

    @staticmethod
    def _encode_field(f: Field, value) -> bytes:
        if f.repeated:
            if not value:
                return b""
            if f.ftype in _PACKABLE:
                payload = b"".join(_encode_scalar(f.ftype, v) for v in value)
                return wire.encode_tag(f.number, wire.WIRE_BYTES) + wire.encode_bytes(payload)
            out = bytearray()
            for v in value:
                if f.ftype == "message":
                    out += wire.encode_tag(f.number, wire.WIRE_BYTES)
                    out += wire.encode_bytes(v.encode())
                else:
                    out += wire.encode_tag(f.number, _wire_type(f.ftype))
                    out += _encode_scalar(f.ftype, v)
            return bytes(out)
        if f.ftype == "message":
            if value is None:
                return b""
            body = value.encode()
            if not body and not f.always_emit:
                # nullable-but-present empty message still emits (gogo writes
                # tag+len for non-nil pointers); value is None when absent.
                pass
            return wire.encode_tag(f.number, wire.WIRE_BYTES) + wire.encode_bytes(body)
        # proto3 zero-value omission
        if value == f.default():
            return b""
        return wire.encode_tag(f.number, _wire_type(f.ftype)) + _encode_scalar(f.ftype, value)

    # -- decoding ---------------------------------------------------------

    @classmethod
    def decode(cls, buf: bytes):
        msg = cls()
        by_number = {f.number: f for f in cls.fields}
        pos = 0
        n = len(buf)
        while pos < n:
            num, wt, pos = wire.decode_tag(buf, pos)
            f = by_number.get(num)
            if f is None:
                pos = _skip(buf, pos, wt)
                continue
            pos = cls._decode_field(msg, f, wt, buf, pos)
        return msg

    @staticmethod
    def _decode_field(msg, f: Field, wt: int, buf: bytes, pos: int) -> int:
        if f.ftype == "message":
            body, pos = wire.decode_bytes(buf, pos)
            sub = f.message_class().decode(body)
            if f.repeated:
                getattr(msg, f.name).append(sub)
            else:
                setattr(msg, f.name, sub)
            return pos
        if f.repeated and f.ftype in _PACKABLE and wt == wire.WIRE_BYTES:
            body, pos = wire.decode_bytes(buf, pos)
            sub = 0
            vals = getattr(msg, f.name)
            while sub < len(body):
                v, sub = _decode_scalar(f.ftype, body, sub)
                vals.append(v)
            return pos
        v, pos = _decode_scalar(f.ftype, buf, pos)
        if f.repeated:
            getattr(msg, f.name).append(v)
        else:
            setattr(msg, f.name, v)
        return pos

    # -- niceties ---------------------------------------------------------

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name) for f in type(self).fields)

    def __repr__(self):
        parts = ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in type(self).fields)
        return f"{type(self).__name__}({parts})"

    @classmethod
    def decode_delimited(cls, buf: bytes, offset: int = 0):
        """The inverse of encode_delimited: (message, offset past it)."""
        body, pos = wire.unmarshal_delimited(buf, offset)
        return cls.decode(body), pos

    def copy(self):
        return type(self).decode(self.encode())

    def which(self) -> str | None:
        """For oneof-shaped messages: the name of the (single) set
        message field, or None. Usable by any envelope whose fields are
        mutually exclusive submessages."""
        for f in type(self).fields:
            if f.ftype == "message" and getattr(self, f.name) is not None:
                return f.name
        return None


def _decode_scalar(ftype: str, buf: bytes, pos: int):
    if ftype in _VARINT_TYPES:
        raw, pos = wire.decode_varint(buf, pos)
        if ftype in ("int32", "int64"):
            raw = wire.varint_to_int64(raw)
            if ftype == "int32":
                raw = int(raw)
        elif ftype == "bool":
            raw = bool(raw)
        return raw, pos
    if ftype in _ZIGZAG_TYPES:
        return wire.decode_zigzag(buf, pos)
    if ftype in _FIXED64_TYPES:
        return wire.decode_fixed64(buf, pos)
    if ftype in _FIXED32_TYPES:
        return wire.decode_fixed32(buf, pos)
    if ftype == "bytes":
        return wire.decode_bytes(buf, pos)
    if ftype == "string":
        b, pos = wire.decode_bytes(buf, pos)
        return b.decode("utf-8"), pos
    raise TypeError(f"unknown scalar type {ftype}")


def _skip(buf: bytes, pos: int, wt: int) -> int:
    if wt == wire.WIRE_VARINT:
        _, pos = wire.decode_varint(buf, pos)
        return pos
    if wt == wire.WIRE_FIXED64:
        return pos + 8
    if wt == wire.WIRE_FIXED32:
        return pos + 4
    if wt == wire.WIRE_BYTES:
        _, pos = wire.decode_bytes(buf, pos)
        return pos
    raise ValueError(f"cannot skip wire type {wt}")
