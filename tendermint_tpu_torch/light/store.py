"""Trusted light-block store (ref: light/store/db/db.go)."""

from __future__ import annotations

import threading

from ..proto import messages as pb
from ..types.light_block import LightBlock

_PREFIX = b"light/lb/"


def _key(height: int) -> bytes:
    return _PREFIX + height.to_bytes(8, "big")


class LightStore:
    """Interface (ref: light/store/store.go)."""

    def save_light_block(self, lb: LightBlock) -> None:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock | None:
        raise NotImplementedError

    def latest_light_block(self) -> LightBlock | None:
        raise NotImplementedError

    def first_light_block(self) -> LightBlock | None:
        raise NotImplementedError

    def light_block_before(self, height: int) -> LightBlock | None:
        raise NotImplementedError

    def delete_light_blocks_before(self, height: int) -> int:
        raise NotImplementedError

    def prune(self, size: int) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


class MemLightStore(LightStore):
    def __init__(self):
        self._blocks: dict[int, LightBlock] = {}
        self._lock = threading.Lock()

    def save_light_block(self, lb: LightBlock) -> None:
        with self._lock:
            self._blocks[lb.height] = lb

    def light_block(self, height: int) -> LightBlock | None:
        with self._lock:
            return self._blocks.get(height)

    def latest_light_block(self) -> LightBlock | None:
        with self._lock:
            if not self._blocks:
                return None
            return self._blocks[max(self._blocks)]

    def first_light_block(self) -> LightBlock | None:
        with self._lock:
            if not self._blocks:
                return None
            return self._blocks[min(self._blocks)]

    def light_block_before(self, height: int) -> LightBlock | None:
        with self._lock:
            below = [h for h in self._blocks if h < height]
            return self._blocks[max(below)] if below else None

    def delete_light_blocks_before(self, height: int) -> int:
        with self._lock:
            doomed = [h for h in self._blocks if h < height]
            for h in doomed:
                del self._blocks[h]
            return len(doomed)

    def prune(self, size: int) -> None:
        """Keep the newest `size` blocks (ref: db.go Prune)."""
        with self._lock:
            heights = sorted(self._blocks)
            for h in heights[: max(0, len(heights) - size)]:
                del self._blocks[h]

    def size(self) -> int:
        with self._lock:
            return len(self._blocks)


class DBLightStore(LightStore):
    """KV-backed store (ref: light/store/db/db.go)."""

    def __init__(self, db):
        self.db = db
        self._lock = threading.Lock()

    def save_light_block(self, lb: LightBlock) -> None:
        with self._lock:
            self.db.set(_key(lb.height), lb.to_proto().encode())

    def light_block(self, height: int) -> LightBlock | None:
        raw = self.db.get(_key(height))
        return LightBlock.from_proto(pb.LightBlock.decode(raw)) if raw else None

    def _heights(self) -> list[int]:
        return [int.from_bytes(k[len(_PREFIX):], "big") for k, _ in self.db.iterator(_PREFIX, _PREFIX + b"\xff")]

    def latest_light_block(self) -> LightBlock | None:
        hs = self._heights()
        return self.light_block(max(hs)) if hs else None

    def first_light_block(self) -> LightBlock | None:
        hs = self._heights()
        return self.light_block(min(hs)) if hs else None

    def light_block_before(self, height: int) -> LightBlock | None:
        below = [h for h in self._heights() if h < height]
        return self.light_block(max(below)) if below else None

    def delete_light_blocks_before(self, height: int) -> int:
        with self._lock:
            doomed = [h for h in self._heights() if h < height]
            for h in doomed:
                self.db.delete(_key(h))
            return len(doomed)

    def prune(self, size: int) -> None:
        with self._lock:
            hs = sorted(self._heights())
            for h in hs[: max(0, len(hs) - size)]:
                self.db.delete(_key(h))

    def size(self) -> int:
        return len(self._heights())
