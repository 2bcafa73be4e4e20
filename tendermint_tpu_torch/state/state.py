"""State: the chain tip that every block folds into (ref:
internal/state/state.go:68-103).

It holds three validator sets (last, current, next): block H's LastCommit
was signed at H - 1 by the set of H - 1, and proposals at H + 1 come from
NextValidators, the one-height lag that makes the app's validator updates
at H take effect at H + 2 (state.go Update, execution.go:527).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..types.block import Block, BlockID, Commit, Header
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams, default_consensus_params
from ..types.validator_set import Validator, ValidatorSet
from ..utils.tmtime import Time

# ref: version/version.go:22-27
BLOCK_PROTOCOL = 11
INIT_STATE_VERSION_APP = 0


@dataclass
class State:
    """ref: sm.State (internal/state/state.go:68)."""

    chain_id: str = ""
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time: Time = field(default_factory=Time)
    validators: ValidatorSet = field(default_factory=lambda: ValidatorSet([]))
    next_validators: ValidatorSet = field(default_factory=lambda: ValidatorSet([]))
    last_validators: ValidatorSet = field(default_factory=lambda: ValidatorSet([]))
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(default_factory=default_consensus_params)
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""
    version_block: int = BLOCK_PROTOCOL
    version_app: int = INIT_STATE_VERSION_APP

    def copy(self) -> "State":
        return replace(
            self,
            last_block_id=self.last_block_id,
            validators=self.validators.copy(),
            next_validators=self.next_validators.copy(),
            last_validators=self.last_validators.copy(),
        )

    @property
    def is_empty(self) -> bool:
        return self.validators.size() == 0

    def update(
        self,
        block_id: BlockID,
        header: Header,
        results_hash: bytes,
        consensus_param_updates,
        validator_updates: list[Validator],
    ) -> "State":
        """Fold one decided block into the state (ref: State.Update,
        internal/state/execution.go:527). AppHash is filled by the caller
        after ABCI Commit."""
        n_val_set = self.next_validators.copy()
        last_height_vals_changed = self.last_height_validators_changed
        if validator_updates:
            n_val_set.update_with_change_set(validator_updates)
            # Changes at H apply starting H+2 (execution.go:545).
            last_height_vals_changed = header.height + 1 + 1
        n_val_set.increment_proposer_priority(1)

        next_params = self.consensus_params
        last_height_params_changed = self.last_height_consensus_params_changed
        version_app = self.version_app
        if consensus_param_updates is not None:
            # consensus_param_updates is a pb.ConsensusParamsUpdate with only
            # the changed sections set (ref: UpdateConsensusParams,
            # types/params.go:413).
            next_params = self.consensus_params.update_consensus_params(consensus_param_updates)
            next_params.validate_consensus_params()
            version_app = next_params.version.app_version
            last_height_params_changed = header.height + 1

        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=header.height,
            last_block_id=block_id,
            last_block_time=header.time,
            next_validators=n_val_set,
            validators=self.next_validators.copy(),
            last_validators=self.validators.copy(),
            last_height_validators_changed=last_height_vals_changed,
            consensus_params=next_params,
            last_height_consensus_params_changed=last_height_params_changed,
            last_results_hash=results_hash,
            app_hash=b"",
            version_block=self.version_block,
            version_app=version_app,
        )

    def make_block(
        self,
        height: int,
        txs: list[bytes],
        commit: Commit | None,
        evidence: list,
        proposer_address: bytes,
        block_time: Time | None = None,
    ) -> Block:
        """ref: State.MakeBlock (internal/state/state.go:264)."""
        block = Block(
            header=Header(
                version_block=self.version_block,
                version_app=self.version_app,
                chain_id=self.chain_id,
                height=height,
                time=block_time if block_time is not None else Time.now(),
                last_block_id=self.last_block_id,
                validators_hash=self.validators.hash(),
                next_validators_hash=self.next_validators.hash(),
                consensus_hash=self.consensus_params.hash_consensus_params(),
                app_hash=self.app_hash,
                last_results_hash=self.last_results_hash,
                proposer_address=proposer_address,
            ),
            txs=list(txs),
            evidence=list(evidence),
            last_commit=commit,
        )
        block.fill_header()
        return block


def make_genesis_state(gen_doc: GenesisDoc) -> State:
    """ref: MakeGenesisState (internal/state/state.go:318)."""
    gen_doc.validate_and_complete()
    if gen_doc.validators:
        validators = [
            Validator(address=gv.pub_key.address(), pub_key=gv.pub_key, voting_power=gv.power)
            for gv in gen_doc.validators
        ]
        val_set = ValidatorSet.new(validators)
        next_val_set = val_set.copy_increment_proposer_priority(1)
    else:
        # validators come from ABCI InitChain
        val_set = ValidatorSet([])
        next_val_set = ValidatorSet([])
    params = gen_doc.consensus_params or default_consensus_params()
    return State(
        chain_id=gen_doc.chain_id,
        initial_height=gen_doc.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=gen_doc.genesis_time,
        validators=val_set,
        next_validators=next_val_set,
        last_validators=ValidatorSet([]),
        last_height_validators_changed=gen_doc.initial_height,
        consensus_params=params,
        last_height_consensus_params_changed=gen_doc.initial_height,
        app_hash=gen_doc.app_hash,
        version_app=params.version.app_version,
    )
