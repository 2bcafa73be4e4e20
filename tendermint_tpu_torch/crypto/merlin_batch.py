"""Batched Merlin transcripts (numpy-vectorized keccak/STROBE).

The sr25519 device plane needs one Merlin challenge per signature on
the host; the scalar implementation (merlin.py) costs ~1 ms each —
enough to cap the chip at ~1k sigs/s. When every lane's absorbed
lengths are equal (commit verification: canonical vote sign-bytes share
one length per chain), the STROBE op sequence is identical across
lanes, so the whole batch advances in lockstep: state is (B, 25)
uint64, pos/flags are scalars, and keccak-f[1600] runs as ~30 numpy
array ops per round for ALL lanes at once (~100x the scalar rate at
batch sizes that matter).

Bit-compatibility is pinned by tests: every lane must equal the scalar
merlin.py transcript (itself pinned by the published merlin-crate
vector). The port's own copy of tendermint_tpu/crypto/merlin_batch.py.
"""

from __future__ import annotations

import sys

import numpy as np

from .merlin import Strobe128, _RC, _ROT

if sys.byteorder != "little":  # pragma: no cover
    # the uint8<->uint64 state views assume the scalar path's explicit
    # little-endian lane layout (struct "<25Q")
    raise ImportError("merlin_batch requires a little-endian host")

_R = Strobe128.R  # 166


def _keccak_f1600_batch(lanes: np.ndarray) -> np.ndarray:
    """lanes: (B, 25) uint64 -> permuted, vectorized over B."""
    st = [lanes[:, i].copy() for i in range(25)]

    def rol(v, n):
        return (v << np.uint64(n)) | (v >> np.uint64(64 - n))

    for rc in _RC:
        c = [st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
        st = [st[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                i = x + 5 * y
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rol(st[i], _ROT[i]) if _ROT[i] else st[i]
        st = [
            b[i] ^ (~b[((i % 5) + 1) % 5 + 5 * (i // 5)] & b[((i % 5) + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        st[0] = st[0] ^ np.uint64(rc)
    return np.stack(st, axis=1)


class BatchStrobe128:
    """STROBE-128 with (B, 200) byte state; every op applies to all
    lanes with identical framing (lengths must match across lanes)."""

    _FLAG_A, _FLAG_C, _FLAG_I, _FLAG_M = 2, 4, 1, 16

    def __init__(self, template_state: bytes, batch: int):
        """template_state: a scalar Strobe128's 200-byte state (shared
        transcript prefix), broadcast to all lanes."""
        self.state = np.tile(np.frombuffer(template_state, np.uint8), (batch, 1)).copy()
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0

    def _run_f(self) -> None:
        self.state[:, self.pos] ^= self.pos_begin
        self.state[:, self.pos + 1] ^= 0x04
        self.state[:, _R + 1] ^= 0x80
        lanes = self.state.view(np.uint64).reshape(self.state.shape[0], 25)
        self.state = _keccak_f1600_batch(lanes).view(np.uint8).reshape(self.state.shape[0], 200)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: np.ndarray) -> None:
        """data: (B, n) uint8 — same n for every lane."""
        off = 0
        n = data.shape[1]
        while off < n:
            take = min(_R - self.pos, n - off)
            self.state[:, self.pos : self.pos + take] ^= data[:, off : off + take]
            self.pos += take
            off += take
            if self.pos == _R:
                self._run_f()

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("strobe: op flag mismatch on continuation")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        frame = np.tile(np.array([old_begin, flags], np.uint8), (self.state.shape[0], 1))
        self._absorb(frame)
        if (flags & self._FLAG_C) and self.pos != 0:
            self._run_f()

    def meta_ad_scalar(self, data: bytes, more: bool) -> None:
        self._begin_op(self._FLAG_M | self._FLAG_A, more)
        self._absorb(np.tile(np.frombuffer(data, np.uint8), (self.state.shape[0], 1)))

    def ad(self, data: np.ndarray, more: bool) -> None:
        self._begin_op(self._FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int) -> np.ndarray:
        self._begin_op(self._FLAG_I | self._FLAG_A | self._FLAG_C, False)
        out = np.empty((self.state.shape[0], n), np.uint8)
        off = 0
        while off < n:
            take = min(_R - self.pos, n - off)
            out[:, off : off + take] = self.state[:, self.pos : self.pos + take]
            self.state[:, self.pos : self.pos + take] = 0
            self.pos += take
            off += take
            if self.pos == _R:
                self._run_f()
        return out


class BatchTranscript:
    """Merlin append/challenge over lockstep lanes, seeded from a scalar
    Transcript (the shared prefix)."""

    def __init__(self, template, batch: int):
        """template: a merlin.Transcript whose state every lane starts
        from (clone it first if you need the original again)."""
        s = template.strobe
        self.strobe = BatchStrobe128(bytes(s.state), batch)
        self.strobe.pos = s.pos
        self.strobe.pos_begin = s.pos_begin
        self.strobe.cur_flags = s.cur_flags

    def append_message(self, label: bytes, data: np.ndarray) -> None:
        """data: (B, n) uint8 — per-lane content, one shared length."""
        import struct

        self.strobe.meta_ad_scalar(label, False)
        self.strobe.meta_ad_scalar(struct.pack("<I", data.shape[1]), True)
        self.strobe.ad(data, False)

    def append_scalar(self, label: bytes, data: bytes) -> None:
        """Same bytes into every lane."""
        self.append_message(
            label, np.tile(np.frombuffer(data, np.uint8), (self.strobe.state.shape[0], 1))
        )

    def challenge_bytes(self, label: bytes, n: int) -> np.ndarray:
        import struct

        self.strobe.meta_ad_scalar(label, False)
        self.strobe.meta_ad_scalar(struct.pack("<I", n), True)
        return self.strobe.prf(n)
