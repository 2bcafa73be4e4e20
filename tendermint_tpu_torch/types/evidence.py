"""Evidence of Byzantine behavior (ref: types/evidence.go): two conflicting
votes of one validator, and a conflicting light block that a light client's
witness served. The bytes and hashes are the reference's.
`evidence_to_abci` comes with the ABCI types."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..proto import messages as pb
from ..proto import wire
from ..utils.tmtime import Time
from .light_block import LightBlock, SignedHeader
from .validator_set import Validator, ValidatorSet, _sort_by_voting_power
from .vote import Vote, _time

HASH_SIZE = 32


def _timestamp(t: Time) -> pb.Timestamp:
    return pb.Timestamp(seconds=t.seconds, nanos=t.nanos)


@dataclass
class DuplicateVoteEvidence:
    """Two conflicting votes from one validator (ref: types/evidence.go:41)."""

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Time = field(default_factory=Time)

    @classmethod
    def new(cls, vote_a: Vote, vote_b: Vote, block_time: Time, val_set: ValidatorSet) -> "DuplicateVoteEvidence":
        """Orders the votes by BlockID key (ref: NewDuplicateVoteEvidence,
        types/evidence.go:60)."""
        if vote_a is None or vote_b is None or val_set is None:
            raise ValueError("missing vote or validator set")
        _, val = val_set.get_by_address(vote_a.validator_address)
        if val is None:
            raise ValueError("validator not in validator set")
        first, second = (vote_a, vote_b) if vote_a.block_id.key() < vote_b.block_id.key() else (vote_b, vote_a)
        return cls(
            vote_a=first,
            vote_b=second,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def abci_height(self) -> int:
        return self.vote_a.height

    def generate_abci(self, val: Validator, val_set: ValidatorSet, evidence_time: Time) -> None:
        """Populate the ABCI component (ref: GenerateABCI, types/evidence.go:184)."""
        self.validator_power = val.voting_power
        self.total_voting_power = val_set.total_voting_power()
        self.timestamp = evidence_time

    @property
    def height(self) -> int:
        return self.vote_a.height

    @property
    def time(self) -> Time:
        return self.timestamp

    def bytes(self) -> bytes:
        return self.to_proto().encode()

    def hash(self) -> bytes:
        return hashlib.sha256(self.bytes()).digest()

    def validate_basic(self) -> None:
        """ref: DuplicateVoteEvidence.ValidateBasic (types/evidence.go:152)."""
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("empty duplicate vote")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def to_proto(self) -> pb.DuplicateVoteEvidence:
        return pb.DuplicateVoteEvidence(
            vote_a=self.vote_a.to_proto(),
            vote_b=self.vote_b.to_proto(),
            total_voting_power=self.total_voting_power,
            validator_power=self.validator_power,
            timestamp=_timestamp(self.timestamp),
        )

    @classmethod
    def from_proto(cls, p: pb.DuplicateVoteEvidence) -> "DuplicateVoteEvidence":
        return cls(
            vote_a=Vote.from_proto(p.vote_a),
            vote_b=Vote.from_proto(p.vote_b),
            total_voting_power=p.total_voting_power or 0,
            validator_power=p.validator_power or 0,
            timestamp=_time(p.timestamp),
        )


@dataclass
class LightClientAttackEvidence:
    """A conflicting light block (ref: types/evidence.go:259)."""

    conflicting_block: LightBlock
    common_height: int = 0
    byzantine_validators: list[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Time = field(default_factory=Time)

    @property
    def height(self) -> int:
        """The common height, the infraction height for expiry
        (ref: types/evidence.go:386)."""
        return self.common_height

    @property
    def time(self) -> Time:
        return self.timestamp

    def bytes(self) -> bytes:
        return self.to_proto().encode()

    def hash(self) -> bytes:
        """ref: LightClientAttackEvidence.Hash (types/evidence.go:374). The
        reference copies only HASH_SIZE - 1 bytes of the header hash into
        its HASH_SIZE-byte buffer; the last byte stays zero here too."""
        varint = wire.encode_zigzag(self.common_height)
        bz = bytearray(HASH_SIZE + len(varint))
        conflicting_hash = (self.conflicting_block.signed_header.header.hash() or b"")[: HASH_SIZE - 1]
        bz[: len(conflicting_hash)] = conflicting_hash
        bz[HASH_SIZE:] = varint
        return hashlib.sha256(bytes(bz)).digest()

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Whether this was a lunatic attack (ref: ConflictingHeaderIsInvalid,
        types/evidence.go:310)."""
        h = self.conflicting_block.signed_header.header
        return (
            trusted_header.validators_hash != h.validators_hash
            or trusted_header.next_validators_hash != h.next_validators_hash
            or trusted_header.consensus_hash != h.consensus_hash
            or trusted_header.app_hash != h.app_hash
            or trusted_header.last_results_hash != h.last_results_hash
        )

    def get_byzantine_validators(self, common_vals: ValidatorSet, trusted: SignedHeader) -> list[Validator]:
        """The validators that attacked, by attack style (ref:
        GetByzantineValidators, types/evidence.go:305-344), ordered by
        descending voting power. `trusted` is the trusted SignedHeader (its
        commit's round tells equivocation from amnesia)."""
        byzantine: list[Validator] = []
        conflicting = self.conflicting_block.signed_header
        if self.conflicting_header_is_invalid(trusted.header):
            # lunatic: the common set's validators that signed the header
            for sig in conflicting.commit.signatures:
                if not sig.for_block():
                    continue
                _, val = common_vals.get_by_address(sig.validator_address)
                if val is not None:
                    byzantine.append(val)
        elif trusted.commit.round == conflicting.commit.round:
            # equivocation: the validators that signed both headers; the
            # sets are equal, so one index walks both commits
            sigs_b = trusted.commit.signatures
            for i, sig_a in enumerate(conflicting.commit.signatures):
                if not sig_a.for_block() or i >= len(sigs_b) or not sigs_b[i].for_block():
                    continue
                _, val = self.conflicting_block.validator_set.get_by_address(sig_a.validator_address)
                if val is not None:
                    byzantine.append(val)
        # different rounds: amnesia, which no validator can be blamed for (ref :341)
        _sort_by_voting_power(byzantine)
        return byzantine

    def generate_abci(self, common_vals: ValidatorSet, trusted: SignedHeader, evidence_time: Time) -> None:
        """Populate the ABCI component (ref: GenerateABCI, types/evidence.go:497)."""
        self.byzantine_validators = self.get_byzantine_validators(common_vals, trusted)
        self.total_voting_power = common_vals.total_voting_power()
        self.timestamp = evidence_time

    def validate_basic(self) -> None:
        if self.conflicting_block is None or self.conflicting_block.signed_header is None:
            raise ValueError("conflicting block missing header")
        try:
            self.conflicting_block.validate_basic(self.conflicting_block.signed_header.header.chain_id)
        except ValueError as e:
            raise ValueError(f"invalid conflicting light block: {e}") from e
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")
        if self.common_height > self.conflicting_block.signed_header.header.height:
            raise ValueError("common height has to be less than equal to the conflicting block height")
        if self.total_voting_power <= 0:
            raise ValueError("negative or zero total voting power")

    def to_proto(self) -> pb.LightClientAttackEvidence:
        return pb.LightClientAttackEvidence(
            conflicting_block=self.conflicting_block.to_proto(),
            common_height=self.common_height,
            byzantine_validators=[v.to_proto() for v in self.byzantine_validators],
            total_voting_power=self.total_voting_power,
            timestamp=_timestamp(self.timestamp),
        )

    @classmethod
    def from_proto(cls, p: pb.LightClientAttackEvidence) -> "LightClientAttackEvidence":
        return cls(
            conflicting_block=LightBlock.from_proto(p.conflicting_block),
            common_height=p.common_height or 0,
            byzantine_validators=[Validator.from_proto(v) for v in (p.byzantine_validators or [])],
            total_voting_power=p.total_voting_power or 0,
            timestamp=_time(p.timestamp),
        )


Evidence = DuplicateVoteEvidence | LightClientAttackEvidence


def evidence_to_proto(ev: Evidence) -> pb.Evidence:
    """ref: types/evidence.go EvidenceToProto."""
    if isinstance(ev, DuplicateVoteEvidence):
        return pb.Evidence(duplicate_vote_evidence=ev.to_proto())
    if isinstance(ev, LightClientAttackEvidence):
        return pb.Evidence(light_client_attack_evidence=ev.to_proto())
    raise TypeError(f"evidence is not recognized: {type(ev)}")


def evidence_from_proto(p: pb.Evidence) -> Evidence:
    if p.duplicate_vote_evidence is not None:
        return DuplicateVoteEvidence.from_proto(p.duplicate_vote_evidence)
    if p.light_client_attack_evidence is not None:
        return LightClientAttackEvidence.from_proto(p.light_client_attack_evidence)
    raise ValueError("evidence is not recognized")
