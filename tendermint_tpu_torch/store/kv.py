"""Key-value store (ref: the tm-db dependency, go.mod:31), the port's own
copy of the JAX package's: an ordered byte-key contract with two backends.

  - MemDB   sorted in-memory map (ref: tm-db memdb).
  - FileDB  a MemDB image over an append-only log of CRC32-framed set,
            delete and batch records; a torn tail is truncated on open,
            and compact() rewrites the log as one sorted pass.

Iteration is ordered by raw bytes, tm-db's contract, which the light
store's key layout (light/store.py) relies on. The log's bytes are the
JAX package's, record for record.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from abc import ABC, abstractmethod
from bisect import bisect_left, insort
from typing import Iterator


class KVStore(ABC):
    """Ordered byte-key/byte-value store (ref: tm-db DB interface)."""

    @abstractmethod
    def get(self, key: bytes) -> bytes | None: ...

    @abstractmethod
    def has(self, key: bytes) -> bool: ...

    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def iterator(self, start: bytes | None = None, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ascending iteration over [start, end)."""

    @abstractmethod
    def reverse_iterator(self, start: bytes | None = None, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Descending iteration over [start, end)."""

    def close(self) -> None:
        pass

    def batch(self) -> "Batch":
        return Batch(self)


class Batch:
    """Atomic write batch (ref: tm-db Batch). Writes are applied on
    `write()` under the store's lock."""

    def __init__(self, db: KVStore):
        self._db = db
        self._ops: list[tuple[bool, bytes, bytes]] = []

    def set(self, key: bytes, value: bytes) -> "Batch":
        self._ops.append((True, bytes(key), bytes(value)))
        return self

    def delete(self, key: bytes) -> "Batch":
        self._ops.append((False, bytes(key), b""))
        return self

    def write(self) -> None:
        self._db.apply_batch(self._ops)  # type: ignore[attr-defined]
        self._ops = []


class MemDB(KVStore):
    def __init__(self):
        self._lock = threading.RLock()
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []  # sorted

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(bytes(key))

    def has(self, key: bytes) -> bool:
        with self._lock:
            return bytes(key) in self._data

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        with self._lock:
            if key not in self._data:
                insort(self._keys, key)
            self._data[key] = value

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._lock:
            if key in self._data:
                del self._data[key]
                i = bisect_left(self._keys, key)
                del self._keys[i]

    def apply_batch(self, ops: list[tuple[bool, bytes, bytes]]) -> None:
        with self._lock:
            for is_set, k, v in ops:
                if is_set:
                    self.set(k, v)
                else:
                    self.delete(k)

    def _range(self, start: bytes | None, end: bytes | None) -> list[bytes]:
        lo = 0 if start is None else bisect_left(self._keys, start)
        hi = len(self._keys) if end is None else bisect_left(self._keys, end)
        return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        with self._lock:
            keys = self._range(start, end)
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        with self._lock:
            keys = self._range(start, end)
        for k in reversed(keys):
            v = self.get(k)
            if v is not None:
                yield k, v


_REC = struct.Struct("<BII")  # op, klen, vlen
_OP_SET, _OP_DEL, _OP_BATCH = 1, 2, 3


def _pack_batch(ops: list[tuple[bool, bytes, bytes]]) -> bytes:
    out = bytearray()
    for is_set, k, v in ops:
        out += _REC.pack(_OP_SET if is_set else _OP_DEL, len(k), len(v))
        out += k
        out += v
    return bytes(out)


def _unpack_batch(data: bytes):
    pos = 0
    while pos + _REC.size <= len(data):
        op, klen, vlen = _REC.unpack_from(data, pos)
        pos += _REC.size
        key = data[pos : pos + klen]
        value = data[pos + klen : pos + klen + vlen]
        pos += klen + vlen
        yield op == _OP_SET, key, value


class FileDB(MemDB):
    """MemDB image + append-only CRC-framed log on disk.

    Record layout: u32 crc32(payload) ‖ payload, where
    payload = u8 op ‖ u32 klen ‖ u32 vlen ‖ key ‖ value.
    A torn tail record (crash mid-append) is truncated on open — the
    same tolerance the reference's consensus WAL has for corrupted
    tails (internal/consensus/wal.go decoder).
    """

    def __init__(self, path: str, fsync: bool = False):
        super().__init__()
        self._path = path
        self._fsync = fsync
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        if not os.path.exists(self._path):
            return
        good = 0
        with open(self._path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 4 <= len(data):
            (crc,) = struct.unpack_from("<I", data, pos)
            if pos + 4 + _REC.size > len(data):
                break
            op, klen, vlen = _REC.unpack_from(data, pos + 4)
            end = pos + 4 + _REC.size + klen + vlen
            if end > len(data):
                break
            payload = data[pos + 4 : end]
            if zlib.crc32(payload) != crc:
                break
            key = payload[_REC.size : _REC.size + klen]
            value = payload[_REC.size + klen :]
            if op == _OP_SET:
                super().set(key, value)
            elif op == _OP_DEL:
                super().delete(key)
            elif op == _OP_BATCH:
                # value holds the packed sub-ops; applied all-or-nothing
                for is_set, k, v in _unpack_batch(value):
                    if is_set:
                        super().set(k, v)
                    else:
                        super().delete(k)
            pos = good = end
        if good < len(data):
            with open(self._path, "r+b") as f:
                f.truncate(good)

    def _append(self, op: int, key: bytes, value: bytes) -> None:
        payload = _REC.pack(op, len(key), len(value)) + key + value
        self._f.write(struct.pack("<I", zlib.crc32(payload)) + payload)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def set(self, key: bytes, value: bytes) -> None:
        key, value = bytes(key), bytes(value)
        with self._lock:
            super().set(key, value)
            self._append(_OP_SET, key, value)

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._lock:
            super().delete(key)
            self._append(_OP_DEL, key, b"")

    def apply_batch(self, ops) -> None:
        """Crash-atomic batch: all sub-ops ride in ONE CRC-framed record,
        so a torn tail drops the whole batch, never a prefix of it —
        preserving the Batch contract BlockStore.save_block relies on."""
        with self._lock:
            for is_set, k, v in ops:
                if is_set:
                    MemDB.set(self, k, v)
                else:
                    MemDB.delete(self, k)
            self._append(_OP_BATCH, b"", _pack_batch(ops))

    def compact(self) -> int:
        """Rewrite the log as one sorted pass of live records (the
        append-only log keeps every historical set/delete otherwise).
        Returns bytes reclaimed — analog of `tendermint compact`."""
        with self._lock:
            old_size = os.path.getsize(self._path) if os.path.exists(self._path) else 0
            self._f.close()
            tmp = self._path + ".compact"
            with open(tmp, "wb") as out:
                for k in self._keys:
                    v = self._data[k]
                    payload = _REC.pack(_OP_SET, len(k), len(v)) + k + v
                    out.write(struct.pack("<I", zlib.crc32(payload)) + payload)
                out.flush()
                os.fsync(out.fileno())
            os.replace(tmp, self._path)
            self._f = open(self._path, "ab")
            return max(0, old_size - os.path.getsize(self._path))

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
