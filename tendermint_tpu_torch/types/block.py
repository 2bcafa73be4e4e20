"""Block, Header, PartSetHeader, BlockID, CommitSig and Commit: structure
and hashing (ref: types/block.go). A block's parts are types/part_set.py.

Every hash is an RFC-6962 merkle root (crypto/merkle.py) over
deterministic proto encodings; cdc_encode wraps primitives in gogoproto
wrapper messages exactly as the reference does
(types/encoding_helper.go:11), so header and commit hashes are
byte-identical to the JAX package's. Header.hash and Commit.hash are
memoized; their hits and misses land in HashMetrics' cache events.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..crypto.merkle import hash_from_byte_slices, sha256_batch
from ..metrics import hash_metrics
from ..proto import messages as pb
from ..proto import wire
from ..utils.tmtime import Time
from .canonical import vote_sign_bytes_template

HASH_SIZE = 32
ADDRESS_SIZE = 20

# ref: types/params.go:21-24
BLOCK_PART_SIZE_BYTES = 65536
MAX_HEADER_BYTES = 626

BLOCK_ID_FLAG_ABSENT = pb.BLOCK_ID_FLAG_ABSENT
BLOCK_ID_FLAG_COMMIT = pb.BLOCK_ID_FLAG_COMMIT
BLOCK_ID_FLAG_NIL = pb.BLOCK_ID_FLAG_NIL


def cdc_encode(item) -> bytes:
    """Wrap a primitive in its gogoproto wrapper message encoding; empty
    values encode to nil (ref: types/encoding_helper.go:11)."""
    if item is None:
        return b""
    if isinstance(item, str):
        if not item:
            return b""
        data = item.encode()
        return wire.encode_tag(1, wire.WIRE_BYTES) + wire.encode_bytes(data)
    if isinstance(item, int):
        if item == 0:
            return b""
        return wire.encode_tag(1, wire.WIRE_VARINT) + wire.encode_varint(item & (2**64 - 1))
    if isinstance(item, (bytes, bytearray)):
        if not item:
            return b""
        return wire.encode_tag(1, wire.WIRE_BYTES) + wire.encode_bytes(bytes(item))
    raise TypeError(f"cdc_encode: unsupported type {type(item)}")


def tx_hash(tx: bytes) -> bytes:
    """ref: types/tx.go:26 — Tx.Hash = SHA-256."""
    return hashlib.sha256(tx).digest()


def txs_hash(txs: list[bytes]) -> bytes:
    """Merkle root of transaction hashes (ref: types/tx.go:36). Both
    stages run on the batched plane: one native call hashes every tx,
    a second merkles the digests."""
    return hash_from_byte_slices(sha256_batch(txs), site="txs")


def validate_hash(h: bytes) -> None:
    """ref: types/validation.go ValidateHash."""
    if h and len(h) != HASH_SIZE:
        raise ValueError(f"expected size to be {HASH_SIZE} bytes, got {len(h)} bytes")


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def validate_basic(self) -> None:
        validate_hash(self.hash)

    def to_proto(self) -> pb.PartSetHeader:
        return pb.PartSetHeader(total=self.total, hash=self.hash)

    @classmethod
    def from_proto(cls, p: pb.PartSetHeader | None) -> "PartSetHeader":
        if p is None:
            return cls()
        return cls(total=p.total or 0, hash=p.hash or b"")

    def __str__(self):
        return f"{self.total}:{self.hash.hex().upper()[:12]}"


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        """ref: BlockID.IsNil (types/block.go)."""
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        """ref: BlockID.IsComplete (types/block.go)."""
        return (
            len(self.hash) == HASH_SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == HASH_SIZE
        )

    def validate_basic(self) -> None:
        validate_hash(self.hash)
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key: the hash and the proto-encoded PartSetHeader, as the
        reference's, so evidence orders its votes alike (ref: BlockID.Key,
        types/block.go:1375)."""
        return self.hash + self.part_set_header.to_proto().encode()

    def to_proto(self) -> pb.BlockID:
        return pb.BlockID(hash=self.hash, part_set_header=self.part_set_header.to_proto())

    @classmethod
    def from_proto(cls, p: pb.BlockID | None) -> "BlockID":
        if p is None:
            return cls()
        return cls(hash=p.hash or b"", part_set_header=PartSetHeader.from_proto(p.part_set_header))

    def __str__(self):
        return f"{self.hash.hex().upper()[:12]}:{self.part_set_header}"


@dataclass
class Header:
    """ref: types/block.go:340 Header."""

    version_block: int = 11
    version_app: int = 0
    chain_id: str = ""
    height: int = 0
    time: Time = field(default_factory=Time)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    # Memoized root. Class attribute (NOT a dataclass field: stays out
    # of __init__/__eq__/__repr__); the instance slot is written through
    # __setattr__ below, which clears it on EVERY field write, so
    # from_proto round-trips and any later mutation invalidate without
    # auditing call sites.
    _hash_cache = None

    def __setattr__(self, name, value):
        if name != "_hash_cache":
            object.__setattr__(self, "_hash_cache", None)
        object.__setattr__(self, name, value)

    def hash(self) -> bytes | None:
        """Merkle root of the 14 encoded fields (ref: types/block.go:447).
        Returns None until the header is fully populated. Memoized (a
        light client hashes each header more than once: the commit check
        and the chain link); any field write invalidates."""
        if not self.validators_hash:
            return None
        h = self._hash_cache
        if h is not None:
            hash_metrics().cache_events.add(1, "header", "hit")
            return h
        version_bz = pb.Consensus(block=self.version_block, app=self.version_app).encode()
        time_bz = pb.Timestamp(seconds=self.time.seconds, nanos=self.time.nanos).encode()
        bid_bz = self.last_block_id.to_proto().encode()
        h = hash_from_byte_slices(
            [
                version_bz,
                cdc_encode(self.chain_id),
                cdc_encode(self.height),
                time_bz,
                bid_bz,
                cdc_encode(self.last_commit_hash),
                cdc_encode(self.data_hash),
                cdc_encode(self.validators_hash),
                cdc_encode(self.next_validators_hash),
                cdc_encode(self.consensus_hash),
                cdc_encode(self.app_hash),
                cdc_encode(self.last_results_hash),
                cdc_encode(self.evidence_hash),
                cdc_encode(self.proposer_address),
            ],
            site="header",
        )
        self._hash_cache = h
        hash_metrics().cache_events.add(1, "header", "miss")
        return h

    def validate_basic(self) -> None:
        """ref: Header.ValidateBasic (types/block.go:405)."""
        if not self.chain_id:
            raise ValueError("empty chain ID")
        if len(self.chain_id) > 50:
            raise ValueError("chain ID is too long")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.height == 0:
            raise ValueError("zero Height")
        self.last_block_id.validate_basic()
        validate_hash(self.last_commit_hash)
        validate_hash(self.data_hash)
        validate_hash(self.evidence_hash)
        if len(self.proposer_address) != ADDRESS_SIZE:
            raise ValueError(f"invalid ProposerAddress length; got: {len(self.proposer_address)}, expected: {ADDRESS_SIZE}")
        validate_hash(self.validators_hash)
        validate_hash(self.next_validators_hash)
        validate_hash(self.consensus_hash)
        validate_hash(self.last_results_hash)

    def to_proto(self) -> pb.Header:
        return pb.Header(
            version=pb.Consensus(block=self.version_block, app=self.version_app),
            chain_id=self.chain_id,
            height=self.height,
            time=pb.Timestamp(seconds=self.time.seconds, nanos=self.time.nanos),
            last_block_id=self.last_block_id.to_proto(),
            last_commit_hash=self.last_commit_hash,
            data_hash=self.data_hash,
            validators_hash=self.validators_hash,
            next_validators_hash=self.next_validators_hash,
            consensus_hash=self.consensus_hash,
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=self.evidence_hash,
            proposer_address=self.proposer_address,
        )

    @classmethod
    def from_proto(cls, p: pb.Header) -> "Header":
        t = p.time or pb.Timestamp()
        v = p.version or pb.Consensus()
        return cls(
            version_block=v.block or 0,
            version_app=v.app or 0,
            chain_id=p.chain_id or "",
            height=p.height or 0,
            time=Time(t.seconds or 0, t.nanos or 0) if (t.seconds or t.nanos) else Time(),
            last_block_id=BlockID.from_proto(p.last_block_id),
            last_commit_hash=p.last_commit_hash or b"",
            data_hash=p.data_hash or b"",
            validators_hash=p.validators_hash or b"",
            next_validators_hash=p.next_validators_hash or b"",
            consensus_hash=p.consensus_hash or b"",
            app_hash=p.app_hash or b"",
            last_results_hash=p.last_results_hash or b"",
            evidence_hash=p.evidence_hash or b"",
            proposer_address=p.proposer_address or b"",
        )


@dataclass
class CommitSig:
    """One validator's slot in a commit (ref: types/block.go:590)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Time = field(default_factory=Time)
    signature: bytes = b""

    @classmethod
    def new_absent(cls) -> "CommitSig":
        return cls()

    @classmethod
    def new_commit(cls, validator_address: bytes, timestamp: Time, signature: bytes) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_COMMIT, validator_address, timestamp, signature)

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """ref: CommitSig.BlockID (types/block.go:641)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            return BlockID()
        raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def validate_basic(self) -> None:
        """ref: CommitSig.ValidateBasic (types/block.go:657)."""
        if self.block_id_flag not in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present")
            if not self.timestamp.is_zero():
                raise ValueError("time is present")
            if self.signature:
                raise ValueError("signature is present")
        else:
            if len(self.validator_address) != ADDRESS_SIZE:
                raise ValueError(f"expected ValidatorAddress size to be {ADDRESS_SIZE} bytes")
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > 64:
                raise ValueError("signature is too big")

    def to_proto(self) -> pb.CommitSig:
        return pb.CommitSig(
            block_id_flag=self.block_id_flag,
            validator_address=self.validator_address,
            timestamp=pb.Timestamp(seconds=self.timestamp.seconds, nanos=self.timestamp.nanos),
            signature=self.signature,
        )

    @classmethod
    def from_proto(cls, p: pb.CommitSig) -> "CommitSig":
        t = p.timestamp or pb.Timestamp()
        return cls(
            block_id_flag=p.block_id_flag or 0,
            validator_address=p.validator_address or b"",
            timestamp=Time(t.seconds or 0, t.nanos or 0) if (t.seconds or t.nanos) else Time(),
            signature=p.signature or b"",
        )


@dataclass
class Commit:
    """ref: types/block.go:786 Commit."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: list[CommitSig] = field(default_factory=list)
    # Guarded memo of hash(): (signatures list identity, length, root).
    # Unlike ValidatorSet (invalidator contract) and Header (__setattr__
    # clears), Commit's fields are mutated only by external code, so the
    # memo re-checks its inputs on every read (the Validator.bytes
    # discipline): replacing or resizing `signatures` can never serve a
    # stale root. In-place mutation of one CommitSig still bypasses the
    # guard, as in the reference.
    _hash: tuple | None = field(default=None, compare=False, repr=False)
    # ((chain_id, height, round, block_id), make_commit, make_nil): the
    # sign-bytes templates; everything but the timestamp is
    # commit-invariant, and the key re-checks every baked-in input
    _sb_tmpl: tuple | None = field(default=None, compare=False, repr=False)

    def get_vote(self, val_idx: int) -> pb.Vote:
        """The proto Vote a commit sig corresponds to (ref: Commit.GetVote,
        types/block.go:836)."""
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        return pb.Vote(
            type=pb.SIGNED_MSG_TYPE_PRECOMMIT,
            height=self.height,
            round=self.round,
            block_id=bid.to_proto(),
            timestamp=pb.Timestamp(seconds=cs.timestamp.seconds, nanos=cs.timestamp.nanos),
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def size(self) -> int:
        return len(self.signatures)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """The canonical signed message of validator slot val_idx
        (ref: Commit.VoteSignBytes, types/block.go:859), from a per-commit
        template (only the timestamp varies per validator)."""
        cs = self.signatures[val_idx]
        tmpl_key = (chain_id, self.height, self.round, self.block_id)
        if self._sb_tmpl is None or self._sb_tmpl[0] != tmpl_key:
            self._sb_tmpl = (
                tmpl_key,
                vote_sign_bytes_template(
                    chain_id, pb.SIGNED_MSG_TYPE_PRECOMMIT,
                    self.height, self.round, self.block_id.to_proto(),
                ),
                vote_sign_bytes_template(
                    chain_id, pb.SIGNED_MSG_TYPE_PRECOMMIT,
                    self.height, self.round, BlockID().to_proto(),
                ),
            )
        if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            make = self._sb_tmpl[1]
        elif cs.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            make = self._sb_tmpl[2]
        else:
            # the flag byte is outside the signature: same guard as
            # CommitSig.block_id
            raise ValueError(f"unknown BlockIDFlag: {cs.block_id_flag}")
        return make(cs.timestamp.seconds, cs.timestamp.nanos)

    def hash(self) -> bytes:
        """Merkle root of CommitSig encodings (ref: types/block.go:900).
        Guarded memo: served only while `signatures` is the same list
        at the same length (see _hash above)."""
        c = self._hash
        if c is not None and c[0] is self.signatures and c[1] == len(self.signatures):
            hash_metrics().cache_events.add(1, "commit", "hit")
            return c[2]
        root = hash_from_byte_slices(
            [cs.to_proto().encode() for cs in self.signatures], site="commit"
        )
        self._hash = (self.signatures, len(self.signatures), root)
        hash_metrics().cache_events.add(1, "commit", "miss")
        return root

    def validate_basic(self) -> None:
        """ref: Commit.ValidateBasic (types/block.go:874)."""
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for i, cs in enumerate(self.signatures):
                try:
                    cs.validate_basic()
                except ValueError as e:
                    raise ValueError(f"wrong CommitSig #{i}: {e}") from e

    def to_proto(self) -> pb.Commit:
        return pb.Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id.to_proto(),
            signatures=[cs.to_proto() for cs in self.signatures],
        )

    @classmethod
    def from_proto(cls, p: pb.Commit) -> "Commit":
        return cls(
            height=p.height or 0,
            round=p.round or 0,
            block_id=BlockID.from_proto(p.block_id),
            signatures=[CommitSig.from_proto(s) for s in (p.signatures or [])],
        )


@dataclass
class Block:
    """ref: types/block.go:37 Block."""

    header: Header = field(default_factory=Header)
    txs: list[bytes] = field(default_factory=list)
    evidence: list = field(default_factory=list)  # list[Evidence] (types/evidence.py)
    last_commit: Commit | None = None

    def fill_header(self) -> None:
        """Compute the derived header hashes (ref: Block.fillHeader,
        types/block.go:99)."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = txs_hash(self.txs)
        if not self.header.evidence_hash:
            self.header.evidence_hash = evidence_list_hash(self.evidence)

    def hash(self) -> bytes | None:
        # A nil LastCommit always yields a nil hash; height-1 blocks carry
        # an empty Commit (ref: types/block.go:111-120).
        if self.last_commit is None:
            return None
        self.fill_header()
        return self.header.hash()

    def hashes_to(self, h: bytes) -> bool:
        if not h:
            return False
        return self.hash() == h

    def validate_basic(self) -> None:
        """ref: Block.ValidateBasic (types/block.go:64)."""
        self.header.validate_basic()
        if self.last_commit is None:
            raise ValueError("nil LastCommit")
        self.last_commit.validate_basic()
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong Header.LastCommitHash")
        if self.header.data_hash != txs_hash(self.txs):
            raise ValueError("wrong Header.DataHash")
        if self.header.evidence_hash != evidence_list_hash(self.evidence):
            raise ValueError("wrong Header.EvidenceHash")

    def make_part_set(self, part_size: int = BLOCK_PART_SIZE_BYTES):
        from .part_set import PartSet

        return PartSet.from_data(self.encode(), part_size)

    def encode(self) -> bytes:
        return self.to_proto().encode()

    def to_proto(self) -> pb.Block:
        from .evidence import evidence_to_proto

        self.fill_header()
        return pb.Block(
            header=self.header.to_proto(),
            data=pb.Data(txs=list(self.txs)),
            evidence=pb.EvidenceList(evidence=[evidence_to_proto(e) for e in self.evidence]),
            last_commit=self.last_commit.to_proto() if self.last_commit else None,
        )

    @classmethod
    def from_proto(cls, p: pb.Block) -> "Block":
        from .evidence import evidence_from_proto

        ev_list = p.evidence.evidence if (p.evidence and p.evidence.evidence) else []
        return cls(
            header=Header.from_proto(p.header or pb.Header()),
            txs=list(p.data.txs) if (p.data and p.data.txs) else [],
            evidence=[evidence_from_proto(e) for e in ev_list],
            last_commit=Commit.from_proto(p.last_commit) if p.last_commit else None,
        )

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        return cls.from_proto(pb.Block.decode(data))


def evidence_list_hash(evidence: list) -> bytes:
    """Merkle root of the evidence encodings (ref: types/evidence.go:667)."""
    return hash_from_byte_slices([e.bytes() for e in evidence], site="evidence")
