"""BitArray (ref: libs/bits/bit_array.go): a thread-safe bitmap of fixed
size, for vote tracking and part-set gossip."""

from __future__ import annotations

import random
import threading


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bits")
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)
        self._mtx = threading.Lock()

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        with self._mtx:
            return self._get(i)

    def _get(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        return bool(self._elems[i // 8] & (1 << (i % 8)))

    def set_index(self, i: int, v: bool) -> bool:
        with self._mtx:
            if i < 0 or i >= self.bits:
                return False
            if v:
                self._elems[i // 8] |= 1 << (i % 8)
            else:
                self._elems[i // 8] &= ~(1 << (i % 8))
            return True

    def copy(self) -> "BitArray":
        with self._mtx:
            c = BitArray(self.bits)
            c._elems = bytearray(self._elems)
            return c

    def or_(self, other: "BitArray") -> "BitArray":
        """Union, sized to the larger operand (ref: BitArray.Or)."""
        c = BitArray(max(self.bits, other.bits))
        for i in range(c.bits):
            if self.get_index(i) or other.get_index(i):
                c.set_index(i, True)
        return c

    def and_(self, other: "BitArray") -> "BitArray":
        c = BitArray(min(self.bits, other.bits))
        for i in range(c.bits):
            if self.get_index(i) and other.get_index(i):
                c.set_index(i, True)
        return c

    def not_(self) -> "BitArray":
        c = BitArray(self.bits)
        for i in range(self.bits):
            if not self.get_index(i):
                c.set_index(i, True)
        return c

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (ref: BitArray.Sub)."""
        c = BitArray(self.bits)
        for i in range(self.bits):
            if self.get_index(i) and not other.get_index(i):
                c.set_index(i, True)
        return c

    def is_empty(self) -> bool:
        with self._mtx:
            return not any(self._elems)

    def is_full(self) -> bool:
        with self._mtx:
            return all(self._get(i) for i in range(self.bits))

    def pick_random(self, rng: random.Random | None = None) -> tuple[int, bool]:
        """A uniformly random set bit, or (0, False) if none
        (ref: BitArray.PickRandom)."""
        with self._mtx:
            true_indices = [i for i in range(self.bits) if self._get(i)]
        if not true_indices:
            return 0, False
        r = rng or random
        return r.choice(true_indices), True

    def true_indices(self) -> list[int]:
        with self._mtx:
            return [i for i in range(self.bits) if self._get(i)]

    def update(self, other: "BitArray") -> None:
        """Overwrite with other's contents (ref: BitArray.Update)."""
        with self._mtx, other._mtx:
            self.bits = other.bits
            self._elems = bytearray(other._elems)

    def to_bytes(self) -> bytes:
        with self._mtx:
            return bytes(self._elems)

    @classmethod
    def from_bytes(cls, bits: int, data: bytes) -> "BitArray":
        ba = cls(bits)
        ba._elems[: len(data)] = data[: len(ba._elems)]
        return ba

    def __eq__(self, other):
        if not isinstance(other, BitArray):
            return NotImplemented
        return self.bits == other.bits and self.to_bytes() == other.to_bytes()

    def __str__(self):
        return "".join("x" if self.get_index(i) else "_" for i in range(self.bits))
