"""Home-directory initialization (ref: cmd/tendermint/commands/init.go)."""

from __future__ import annotations

import os

from ..config import Config, default_config
from ..privval import FilePV
from ..types.genesis import GenesisDoc, GenesisValidator
from ..utils.tmtime import Time
from .node import NodeKey


def init_files_home(
    home: str,
    chain_id: str = "",
    mode: str = "validator",
    gen_doc: GenesisDoc | None = None,
    key_type: str = "ed25519",
) -> Config:
    """Create config.toml, genesis.json, privval + node keys
    (ref: init.go initFilesWithConfig; --key flag at init.go:37)."""
    cfg = default_config(home)
    cfg.base.mode = mode
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)

    pv = None
    if mode == "validator":
        pv = FilePV.load_or_generate(cfg.priv_validator_key_file, cfg.priv_validator_state_file,
                                     key_type=key_type)

    NodeKey.load_or_gen(cfg.node_key_file)

    if not os.path.exists(cfg.genesis_file):
        if gen_doc is None:
            import secrets

            from ..types.params import ConsensusParams, ValidatorParams

            gen_doc = GenesisDoc(
                chain_id=chain_id or f"test-chain-{secrets.token_hex(3)}",
                genesis_time=Time.now(),
                consensus_params=ConsensusParams(
                    validator=ValidatorParams(pub_key_types=(key_type,)),
                ),
                validators=(
                    [
                        GenesisValidator(
                            address=pv.get_pub_key().address(),
                            pub_key=pv.get_pub_key(),
                            power=10,
                            name="",
                        )
                    ]
                    if pv is not None
                    else []
                ),
            )
        gen_doc.save_as(cfg.genesis_file)

    cfg.save()
    return cfg
