"""State provider — builds a trusted sm.State for a snapshot height via
the light client (ref: internal/statesync/stateprovider.go:33-361)."""

from __future__ import annotations

from ..light.client import LightClient
from ..state.state import State
from ..types.params import ConsensusParams


class LightClientStateProvider:
    """ref: stateprovider.go lightClientStateProvider."""

    def __init__(self, light_client: LightClient, gen_doc, params_fetcher=None):
        """params_fetcher(height) -> ConsensusParams | None (the reference
        fetches via RPC /consensus_params or the p2p params channel);
        falls back to genesis params."""
        self.lc = light_client
        self.gen_doc = gen_doc
        self.params_fetcher = params_fetcher

    def app_hash(self, height: int) -> bytes:
        """AppHash AFTER block `height` = header (height+1).AppHash
        (ref: stateprovider.go:120 AppHash)."""
        lb = self.lc.verify_light_block_at_height(height + 1)
        return lb.signed_header.header.app_hash

    def commit(self, height: int):
        """Seen commit for the restored height (ref: :141 Commit)."""
        lb = self.lc.verify_light_block_at_height(height)
        return lb.signed_header.commit

    def state(self, height: int) -> State:
        """ref: stateprovider.go:156 State — requires headers at
        height, height+1, height+2."""
        last = self.lc.verify_light_block_at_height(height)
        current = self.lc.verify_light_block_at_height(height + 1)
        nxt = self.lc.verify_light_block_at_height(height + 2)

        params = None
        if self.params_fetcher is not None:
            params = self.params_fetcher(height + 1)
        if params is None:
            params = self.gen_doc.consensus_params or ConsensusParams()

        return State(
            chain_id=self.gen_doc.chain_id,
            initial_height=self.gen_doc.initial_height,
            last_block_height=last.height,
            last_block_id=current.signed_header.header.last_block_id,
            last_block_time=last.signed_header.header.time,
            validators=current.validator_set.copy(),
            next_validators=nxt.validator_set.copy(),
            last_validators=last.validator_set.copy(),
            last_height_validators_changed=last.height,
            consensus_params=params,
            last_height_consensus_params_changed=self.gen_doc.initial_height,
            last_results_hash=current.signed_header.header.last_results_hash,
            app_hash=current.signed_header.header.app_hash,
        )
