"""BlockStore: each height's block meta, parts, commit and seen commit
(ref: internal/store/store.go:34-743).

The key layout is the JAX package's (after store.go's prefixes): H:<h>
block meta, P:<h>:<i> block part, C:<h-1> the commit of block h - 1 (saved
with block h), SC:<h> seen commit, EC:<h> extended commit, BH:<hash> the
height of a block hash. Heights are fixed-width big-endian, so byte order is
numeric order.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..proto import messages as pb
from ..types.block import Block, BlockID, Commit, Header
from ..types.part_set import Part, PartSet
from .kv import KVStore


def _h(prefix: bytes, height: int) -> bytes:
    return prefix + height.to_bytes(8, "big")


KEY_META = b"H:"
KEY_PART = b"P:"
KEY_COMMIT = b"C:"
KEY_SEEN_COMMIT = b"SC:"
KEY_EXT_COMMIT = b"EC:"
KEY_BY_HASH = b"BH:"
KEY_STATE = b"blockStore"


@dataclass
class BlockMeta:
    """ref: types/block_meta.go."""

    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def to_proto(self) -> pb.BlockMeta:
        return pb.BlockMeta(
            block_id=self.block_id.to_proto(),
            block_size=self.block_size,
            header=self.header.to_proto(),
            num_txs=self.num_txs,
        )

    @classmethod
    def from_proto(cls, p: pb.BlockMeta) -> "BlockMeta":
        return cls(
            block_id=BlockID.from_proto(p.block_id),
            block_size=p.block_size or 0,
            header=Header.from_proto(p.header),
            num_txs=p.num_txs or 0,
        )


class BlockStore:
    """ref: store.BlockStore (internal/store/store.go:34). base() is the
    lowest retained height after pruning; height() the tip."""

    def __init__(self, db: KVStore):
        self._db = db
        self._mu = threading.RLock()
        self._base = 0
        self._height = 0
        raw = db.get(KEY_STATE)
        if raw:
            self._base = int.from_bytes(raw[:8], "big")
            self._height = int.from_bytes(raw[8:16], "big")

    def base(self) -> int:
        with self._mu:
            return self._base

    def height(self) -> int:
        with self._mu:
            return self._height

    def size(self) -> int:
        with self._mu:
            return self._height - self._base + 1 if self._height > 0 else 0

    def _save_state(self) -> None:
        self._db.set(KEY_STATE, self._base.to_bytes(8, "big") + self._height.to_bytes(8, "big"))

    # ------------------------------------------------------------- writes

    def save_block(self, block: Block, part_set: PartSet, seen_commit: Commit,
                   extended_commit=None) -> None:
        """ref: store.go SaveBlock / SaveBlockWithExtendedCommit. Each part
        is stored on its own, so that part gossip reads it from disk.
        extended_commit (a pb.ExtendedCommit) goes in the same batch, so a
        crash cannot separate the block from it."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        height = block.header.height
        with self._mu:
            if self._height > 0 and height != self._height + 1:
                raise ValueError(f"BlockStore can only save contiguous blocks. Wanted {self._height + 1}, got {height}")
            if not part_set.is_complete():
                raise ValueError("BlockStore can only save complete block part sets")
            block_id = BlockID(hash=block.hash(), part_set_header=part_set.header)
            meta = BlockMeta(
                block_id=block_id,
                block_size=len(block.to_proto().encode()),
                header=block.header,
                num_txs=len(block.txs),
            )
            batch = self._db.batch()
            batch.set(_h(KEY_META, height), meta.to_proto().encode())
            batch.set(KEY_BY_HASH + block.hash(), height.to_bytes(8, "big"))
            for i in range(part_set.total()):
                part = part_set.get_part(i)
                batch.set(_h(KEY_PART, height) + b":" + i.to_bytes(4, "big"), part.to_proto().encode())
            batch.set(_h(KEY_COMMIT, height - 1), block.last_commit.to_proto().encode() if block.last_commit else b"")
            batch.set(_h(KEY_SEEN_COMMIT, height), seen_commit.to_proto().encode())
            if extended_commit is not None:
                batch.set(_h(KEY_EXT_COMMIT, height), extended_commit.encode())
            batch.write()
            if self._base == 0:
                self._base = height
            self._height = height
            self._save_state()

    def load_extended_commit(self, height: int):
        """Precommit votes WITH extensions, or None
        (ref: store.go LoadBlockExtendedCommit)."""
        from ..types.vote import votes_from_extended_commit

        raw = self._db.get(_h(KEY_EXT_COMMIT, height))
        if raw is None:
            return None
        return votes_from_extended_commit(pb.ExtendedCommit.decode(raw))

    def load_extended_commit_proto(self, height: int):
        raw = self._db.get(_h(KEY_EXT_COMMIT, height))
        if raw is None:
            return None
        return pb.ExtendedCommit.decode(raw)

    def save_seen_commit(self, height: int, seen_commit: Commit) -> None:
        with self._mu:
            self._db.set(_h(KEY_SEEN_COMMIT, height), seen_commit.to_proto().encode())

    # -------------------------------------------------------------- reads

    def load_block_meta(self, height: int) -> BlockMeta | None:
        raw = self._db.get(_h(KEY_META, height))
        if not raw:
            return None
        return BlockMeta.from_proto(pb.BlockMeta.decode(raw))

    def load_block(self, height: int) -> Block | None:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        buf = b""
        for i in range(meta.block_id.part_set_header.total):
            raw = self._db.get(_h(KEY_PART, height) + b":" + i.to_bytes(4, "big"))
            if raw is None:
                return None
            buf += pb.Part.decode(raw).bytes_ or b""
        return Block.from_proto(pb.Block.decode(buf))

    def load_block_by_hash(self, block_hash: bytes) -> Block | None:
        raw = self._db.get(KEY_BY_HASH + block_hash)
        if raw is None:
            return None
        return self.load_block(int.from_bytes(raw, "big"))

    def load_block_part(self, height: int, index: int) -> Part | None:
        raw = self._db.get(_h(KEY_PART, height) + b":" + index.to_bytes(4, "big"))
        if raw is None:
            return None
        return Part.from_proto(pb.Part.decode(raw))

    def load_block_commit(self, height: int) -> Commit | None:
        """The commit certifying block `height` (stored with block h+1)."""
        raw = self._db.get(_h(KEY_COMMIT, height))
        if not raw:
            return None
        return Commit.from_proto(pb.Commit.decode(raw))

    def load_seen_commit(self, height: int) -> Commit | None:
        raw = self._db.get(_h(KEY_SEEN_COMMIT, height))
        if not raw:
            return None
        return Commit.from_proto(pb.Commit.decode(raw))

    # ------------------------------------------------------------ pruning

    def prune_blocks(self, retain_height: int) -> int:
        """Remove blocks below retain_height; returns number pruned
        (ref: store.go PruneBlocks)."""
        with self._mu:
            if retain_height <= 0:
                raise ValueError(f"height must be greater than 0; got {retain_height}")
            if retain_height > self._height:
                raise ValueError(f"cannot prune beyond the latest height {self._height}")
            if retain_height < self._base:
                return 0
            pruned = 0
            batch = self._db.batch()
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                batch.delete(_h(KEY_META, h))
                batch.delete(_h(KEY_EXT_COMMIT, h))
                batch.delete(KEY_BY_HASH + meta.block_id.hash)
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_h(KEY_PART, h) + b":" + i.to_bytes(4, "big"))
                batch.delete(_h(KEY_COMMIT, h - 1))
                batch.delete(_h(KEY_SEEN_COMMIT, h))
                pruned += 1
            self._base = retain_height
            self._save_state()
            batch.write()
            return pruned
