"""PartSet: a block split into 64 KiB parts, each with its merkle proof
(crypto/merkle.py), for gossip and the block store (ref:
types/part_set.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.merkle import Proof, proofs_from_byte_slices
from ..proto import messages as pb
from .block import BlockID, PartSetHeader


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: Proof

    def validate_basic(self, part_size: int = 65536) -> None:
        """ref: Part.ValidateBasic (types/part_set.go:48)."""
        if len(self.bytes_) > part_size:
            raise ValueError(f"part is too big (max: {part_size})")

    def to_proto(self) -> pb.Part:
        return pb.Part(
            index=self.index,
            bytes_=self.bytes_,
            proof=pb.Proof(
                total=self.proof.total,
                index=self.proof.index,
                leaf_hash=self.proof.leaf_hash,
                aunts=list(self.proof.aunts),
            ),
        )

    @classmethod
    def from_proto(cls, p: pb.Part) -> "Part":
        pr = p.proof or pb.Proof()
        return cls(
            index=p.index or 0,
            bytes_=p.bytes_ or b"",
            proof=Proof(pr.total or 0, pr.index or 0, pr.leaf_hash or b"", list(pr.aunts or [])),
        )


class PartSet:
    """Mutable accumulator of block parts; complete once every index is
    present and proven against the header hash (ref: types/part_set.go:180)."""

    def __init__(self, header: PartSetHeader):
        self.header = header
        self.parts: list[Part | None] = [None] * header.total
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int) -> "PartSet":
        """Split data into ceil(len/part_size) parts with proofs
        (ref: NewPartSetFromData, types/part_set.go:113)."""
        total = (len(data) + part_size - 1) // part_size
        if total == 0:
            total = 1
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        # one native call leaf-hashes every part and builds the proof tree:
        # the proposer's cost of splitting a large block
        root, proofs = proofs_from_byte_slices(chunks, site="part_set")
        ps = cls(PartSetHeader(total=total, hash=root))
        for i, chunk in enumerate(chunks):
            ps.parts[i] = Part(index=i, bytes_=chunk, proof=proofs[i])
        ps.count = total
        ps.byte_size = len(data)
        return ps

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header == header

    def block_id(self, block_hash: bytes) -> BlockID:
        return BlockID(hash=block_hash, part_set_header=self.header)

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def total(self) -> int:
        return self.header.total

    def has_part(self, index: int) -> bool:
        return 0 <= index < len(self.parts) and self.parts[index] is not None

    def get_part(self, index: int) -> Part | None:
        if 0 <= index < len(self.parts):
            return self.parts[index]
        return None

    def add_part(self, part: Part) -> bool:
        """Returns True if added; raises on invalid proof
        (ref: PartSet.AddPart, types/part_set.go:265)."""
        if part.index >= self.header.total:
            raise ValueError("error part set unexpected index")
        if self.parts[part.index] is not None:
            return False
        if not part.proof.verify(self.header.hash, part.bytes_):
            raise ValueError("error part set invalid proof")
        self.parts[part.index] = part
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_data(self) -> bytes:
        """Reassembled payload; only valid when complete."""
        if not self.is_complete():
            raise ValueError("part set is not complete")
        return b"".join(p.bytes_ for p in self.parts)

    def bit_array(self) -> "BitArray":
        """Which part indices are present (ref: PartSet.BitArray)."""
        from ..utils.bits import BitArray

        ba = BitArray(self.header.total)
        for i, p in enumerate(self.parts):
            if p is not None:
                ba.set_index(i, True)
        return ba
