"""ConsensusParams: the on-chain consensus parameters (ref: types/params.go).

The consensus-critical parameters (block limits, evidence windows, PBTS
synchrony bounds, step timeouts) live in the state, which the app may
update at each block, not in a node's local config, so that a misconfigured
node cannot fork the chain (types/params.go:39-103).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace

from ..proto import messages as pb
from ..proto.messages import HashedParams

SECOND = 1_000_000_000  # durations are nanoseconds, as in Go
MILLISECOND = 1_000_000

ABCI_PUBKEY_TYPE_ED25519 = "ed25519"
ABCI_PUBKEY_TYPE_SECP256K1 = "secp256k1"
ABCI_PUBKEY_TYPE_SR25519 = "sr25519"

# ref: types/params.go:21-30
MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MiB
BLOCK_PART_SIZE_BYTES = 65536
MAX_BLOCK_PARTS_COUNT = MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES + 1


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 22020096  # 21 MB (ref: DefaultBlockParams, params.go:130)
    max_gas: int = -1


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration: int = 48 * 3600 * SECOND  # ns
    max_bytes: int = 1048576


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple[str, ...] = (ABCI_PUBKEY_TYPE_ED25519,)


@dataclass(frozen=True)
class VersionParams:
    app_version: int = 0


@dataclass(frozen=True)
class SynchronyParams:
    """PBTS bounds (ref: types/params.go:85, DefaultSynchronyParams)."""

    precision: int = 505 * MILLISECOND  # ns
    message_delay: int = 12 * SECOND  # ns


@dataclass(frozen=True)
class TimeoutParams:
    """Consensus step timeouts, on-chain (ref: types/params.go:91)."""

    propose: int = 3000 * MILLISECOND
    propose_delta: int = 500 * MILLISECOND
    vote: int = 1000 * MILLISECOND
    vote_delta: int = 500 * MILLISECOND
    commit: int = 1000 * MILLISECOND
    bypass_commit_timeout: bool = False

    def propose_timeout(self, round_: int) -> float:
        """Seconds for enterPropose at round (ref: proposeTimeout,
        internal/consensus/state.go:2769)."""
        return (self.propose + self.propose_delta * round_) / SECOND

    def vote_timeout(self, round_: int) -> float:
        return (self.vote + self.vote_delta * round_) / SECOND


@dataclass(frozen=True)
class ABCIParams:
    vote_extensions_enable_height: int = 0
    recheck_tx: bool = True

    def vote_extensions_enabled(self, height: int) -> bool:
        """ref: ABCIParams.VoteExtensionsEnabled (types/params.go)."""
        if self.vote_extensions_enable_height == 0:
            return False
        if height < 1:
            raise ValueError(f"cannot check vote extensions for height {height}")
        return height >= self.vote_extensions_enable_height


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)
    timeout: TimeoutParams = field(default_factory=TimeoutParams)
    abci: ABCIParams = field(default_factory=ABCIParams)

    def hash_consensus_params(self) -> bytes:
        """SHA-256 of the HashedParams proto (ref: types/params.go:385)."""
        hp = HashedParams(block_max_bytes=self.block.max_bytes, block_max_gas=self.block.max_gas)
        return hashlib.sha256(hp.encode()).digest()

    def validate_consensus_params(self) -> None:
        """ref: ConsensusParams.ValidateConsensusParams (types/params.go:282)."""
        if self.block.max_bytes <= 0:
            raise ValueError(f"block.MaxBytes must be greater than 0. Got {self.block.max_bytes}")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(f"block.MaxBytes is too big. {self.block.max_bytes} > {MAX_BLOCK_SIZE_BYTES}")
        if self.block.max_gas < -1:
            raise ValueError(f"block.MaxGas must be greater or equal to -1. Got {self.block.max_gas}")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be greater than 0")
        if self.evidence.max_age_duration <= 0:
            raise ValueError("evidence.MaxAgeDuration must be greater than 0")
        if self.evidence.max_bytes > self.block.max_bytes:
            raise ValueError("evidence.MaxBytesEvidence is greater than upper bound")
        if self.evidence.max_bytes < 0:
            raise ValueError("evidence.MaxBytes must be non negative")
        if self.synchrony.message_delay <= 0:
            raise ValueError("synchrony.MessageDelay must be greater than 0")
        if self.synchrony.precision <= 0:
            raise ValueError("synchrony.Precision must be greater than 0")
        if not self.validator.pub_key_types:
            raise ValueError("len(Validator.PubKeyTypes) must be greater than 0")
        for kt in self.validator.pub_key_types:
            if kt not in (ABCI_PUBKEY_TYPE_ED25519, ABCI_PUBKEY_TYPE_SECP256K1, ABCI_PUBKEY_TYPE_SR25519):
                raise ValueError(f"unknown pubkey type {kt}")

    def update_consensus_params(self, p2: "pb.ConsensusParamsUpdate | None") -> "ConsensusParams":
        """Apply non-nil sections of an ABCI params update
        (ref: UpdateConsensusParams, types/params.go:413)."""
        if p2 is None:
            return self
        res = self
        if p2.block is not None:
            res = replace(res, block=BlockParams(max_bytes=p2.block.max_bytes or 0, max_gas=p2.block.max_gas or 0))
        if p2.evidence is not None:
            dur = p2.evidence.max_age_duration
            res = replace(
                res,
                evidence=EvidenceParams(
                    max_age_num_blocks=p2.evidence.max_age_num_blocks or 0,
                    max_age_duration=dur.to_ns() if dur is not None else 0,
                    max_bytes=p2.evidence.max_bytes or 0,
                ),
            )
        if p2.validator is not None:
            res = replace(res, validator=ValidatorParams(pub_key_types=tuple(p2.validator.pub_key_types or ())))
        if p2.version is not None:
            res = replace(res, version=VersionParams(app_version=p2.version.app_version or 0))
        if p2.synchrony is not None:
            s = res.synchrony
            res = replace(
                res,
                synchrony=SynchronyParams(
                    precision=p2.synchrony.precision.to_ns() if p2.synchrony.precision is not None else s.precision,
                    message_delay=p2.synchrony.message_delay.to_ns()
                    if p2.synchrony.message_delay is not None
                    else s.message_delay,
                ),
            )
        if p2.timeout is not None:
            t = res.timeout
            res = replace(
                res,
                timeout=TimeoutParams(
                    propose=p2.timeout.propose.to_ns() if p2.timeout.propose is not None else t.propose,
                    propose_delta=p2.timeout.propose_delta.to_ns()
                    if p2.timeout.propose_delta is not None
                    else t.propose_delta,
                    vote=p2.timeout.vote.to_ns() if p2.timeout.vote is not None else t.vote,
                    vote_delta=p2.timeout.vote_delta.to_ns() if p2.timeout.vote_delta is not None else t.vote_delta,
                    commit=p2.timeout.commit.to_ns() if p2.timeout.commit is not None else t.commit,
                    bypass_commit_timeout=bool(p2.timeout.bypass_commit_timeout),
                ),
            )
        if p2.abci is not None:
            res = replace(
                res,
                abci=ABCIParams(
                    vote_extensions_enable_height=p2.abci.vote_extensions_enable_height or 0,
                    recheck_tx=bool(p2.abci.recheck_tx),
                ),
            )
        return res

    def to_proto_update(self) -> "pb.ConsensusParamsUpdate":
        """Full proto image of these params, for ABCI InitChain and wire
        transports (ref: ConsensusParams.ToProto, types/params.go:452)."""
        return pb.ConsensusParamsUpdate(
            block=pb.BlockParamsProto(max_bytes=self.block.max_bytes, max_gas=self.block.max_gas),
            evidence=pb.EvidenceParamsProto(
                max_age_num_blocks=self.evidence.max_age_num_blocks,
                max_age_duration=pb.Duration.from_ns(self.evidence.max_age_duration),
                max_bytes=self.evidence.max_bytes,
            ),
            validator=pb.ValidatorParamsProto(pub_key_types=list(self.validator.pub_key_types)),
            version=pb.VersionParamsProto(app_version=self.version.app_version),
            synchrony=pb.SynchronyParamsProto(
                message_delay=pb.Duration.from_ns(self.synchrony.message_delay),
                precision=pb.Duration.from_ns(self.synchrony.precision),
            ),
            timeout=pb.TimeoutParamsProto(
                propose=pb.Duration.from_ns(self.timeout.propose),
                propose_delta=pb.Duration.from_ns(self.timeout.propose_delta),
                vote=pb.Duration.from_ns(self.timeout.vote),
                vote_delta=pb.Duration.from_ns(self.timeout.vote_delta),
                commit=pb.Duration.from_ns(self.timeout.commit),
                bypass_commit_timeout=self.timeout.bypass_commit_timeout,
            ),
            abci=pb.ABCIParamsProto(
                vote_extensions_enable_height=self.abci.vote_extensions_enable_height,
                recheck_tx=self.abci.recheck_tx,
            ),
        )


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
