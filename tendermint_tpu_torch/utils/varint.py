"""Canonical unsigned-varint codec (protobuf base-128 LEB128), a copy of the
JAX package's utils/varint.py.

The buffer-shaped wire formats use it: the mempool reactor's multi-tx gossip
frames (mempool/reactor.py) and the TCP transport's packet prefixes
(p2p/transport_tcp.py). Stream-shaped readers that pull one byte at a time
from a socket keep their own loop.
"""

from __future__ import annotations


def encode_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf, pos: int) -> tuple[int, int]:
    """(value, next_pos) from buf at pos; raises ValueError on a varint
    longer than 64 bits and IndexError on a truncated buffer."""
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")
