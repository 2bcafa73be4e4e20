"""Merlin transcripts over STROBE-128/keccak-f[1600] (pure Python).

The sr25519 (schnorrkel) signature scheme binds its Schnorr challenges
to a Merlin transcript; verification compatibility therefore requires a
bit-exact Merlin. This implements the three layers from their public
specs:

  keccak-f[1600]  — FIPS 202 permutation (validated against hashlib's
                    sha3 in tests/test_sr25519.py)
  STROBE-128      — the subset Merlin uses (meta-AD, AD, PRF, KEY),
                    R = 166, protocol framing per the STROBE v1.0.2 spec
  Merlin          — domain-separated transcripts (append_message /
                    challenge_bytes), validated against the published
                    merlin crate test vector

ref: the reference consumes this via curve25519-voi's sr25519
(crypto/sr25519/privkey.go:18 signingCtx), which embeds its own Merlin.

The port's own copy of tendermint_tpu/crypto/merlin.py (the port imports
nothing of the JAX package); tests/test_torch_sr25519.py holds the two
byte for byte.
"""

from __future__ import annotations

import struct

_MASK = (1 << 64) - 1

_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rho rotation offsets, flat index i = x + 5*y
_ROT = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)


def _rol(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(st: list[int]) -> list[int]:
    """One permutation over 25 little-endian 64-bit lanes."""
    for rc in _RC:
        # theta
        c = [st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        st = [st[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(st[x + 5 * y], _ROT[x + 5 * y])
        # chi
        st = [
            b[i] ^ (~b[((i % 5) + 1) % 5 + 5 * (i // 5)] & b[((i % 5) + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        st[0] ^= rc
    return st


class Strobe128:
    """The STROBE-128 subset Merlin needs. State is 200 bytes; R = 166."""

    R = 166
    _FLAG_I, _FLAG_A, _FLAG_C, _FLAG_T, _FLAG_M, _FLAG_K = 1, 2, 4, 8, 16, 32

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, self.R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = self._permute_bytes(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @staticmethod
    def _permute_bytes(st: bytearray) -> bytearray:
        lanes = list(struct.unpack("<25Q", bytes(st)))
        lanes = keccak_f1600(lanes)
        return bytearray(struct.pack("<25Q", *lanes))

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[self.R + 1] ^= 0x80
        self.state = self._permute_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == self.R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == self.R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == self.R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("strobe: op flag mismatch on continuation")
            return
        if flags & self._FLAG_T:
            raise ValueError("strobe: transport ops unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (self._FLAG_C | self._FLAG_K)) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(self._FLAG_M | self._FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(self._FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(self._FLAG_I | self._FLAG_A | self._FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(self._FLAG_A | self._FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        dup = object.__new__(Strobe128)
        dup.state = bytearray(self.state)
        dup.pos = self.pos
        dup.pos_begin = self.pos_begin
        dup.cur_flags = self.cur_flags
        return dup


class Transcript:
    """Merlin transcript (append_message / challenge_bytes)."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, struct.pack("<Q", value))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", n), True)
        return self.strobe.prf(n, False)

    def clone(self) -> "Transcript":
        dup = object.__new__(Transcript)
        dup.strobe = self.strobe.clone()
        return dup
