"""Light-block providers (ref: light/provider/provider.go).

A Provider serves LightBlocks for a chain and accepts evidence reports.
`LocalProvider` serves from a node's block store and state store (any
objects with the methods it calls); tests serve from memory, as the
reference's light/provider/mocks do. The HTTP provider comes with the RPC
client."""

from __future__ import annotations

from ..types.light_block import LightBlock, SignedHeader


class ProviderError(Exception):
    pass


class ErrLightBlockNotFound(ProviderError):
    """ref: provider.go ErrLightBlockNotFound."""


class ErrNoResponse(ProviderError):
    """ref: provider.go ErrNoResponse."""


class Provider:
    """ref: provider.go Provider interface."""

    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """Block at height, or the latest if height == 0. Raises
        ErrLightBlockNotFound / ErrNoResponse."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:
        raise NotImplementedError

    def id(self) -> str:
        return repr(self)


class LocalProvider(Provider):
    """Serves from a node's block store and state store: block_store.height(),
    load_block_meta(h).header, load_block_commit(h), load_seen_commit(h)
    and state_store.load_validators(h)."""

    def __init__(self, chain_id: str, block_store, state_store, name: str = "local"):
        self._chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.name = name
        self.evidence: list = []

    def chain_id(self) -> str:
        return self._chain_id

    def id(self) -> str:
        return self.name

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height()
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            # chain tip: the canonical commit lives in the next block,
            # which doesn't exist yet — serve the seen commit (the RPC
            # /commit endpoint does the same for the latest height)
            commit = self.block_store.load_seen_commit(height)
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(f"no light block at height {height}")
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    def report_evidence(self, ev) -> None:
        self.evidence.append(ev)
