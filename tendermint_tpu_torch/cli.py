"""Command-line interface (ref: cmd/tendermint/main.go:28-48 +
cmd/tendermint/commands/).

A copy of the JAX package's cli.py with the commands that make and start a
node: version, init, start (validator, full and seed modes), testnet,
show-node-id, show-validator, gen-validator and gen-node-key. The parser
keeps every command of the reference, so `--help` reads the same; a
command the port has not reached yet exits non-zero with an error that
names the ROADMAP item that brings it. Run as
`python -m tendermint_tpu_torch <command>`; a started node runs its
verifying layers on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

VERSION = "0.35.0-tpu"

# the commands outside this slice, by the ROADMAP item that brings them
LATER = {
    **dict.fromkeys(("reset", "unsafe-reset-all", "inspect", "light", "debug", "replay", "reindex-event", "compact",
                     "wal2json", "json2wal", "config-migrate", "completion", "remote-signer"), "A14b"),
    **dict.fromkeys(("rollback", "key-migrate"), "A15"),
    **dict.fromkeys(("e2e", "e2e-generate", "replay-console"), "tooling, not queued"),
}


def _default_home() -> str:
    return os.environ.get("TMHOME", os.path.expanduser("~/.tendermint-tpu"))


# ---------------------------------------------------------------- commands


def cmd_version(args) -> int:
    print(VERSION)
    return 0


def cmd_later(args) -> int:
    """A command outside this slice of the port."""
    print(f"error: `{args.command}` comes with ROADMAP {LATER[args.command]} of the PyTorch/CUDA port",
          file=sys.stderr)
    return 2


def cmd_init(args) -> int:
    """ref: commands/init.go — init validator|full|seed."""
    from .node import init_files_home

    cfg = init_files_home(args.home, chain_id=args.chain_id or "", mode=args.mode,
                          key_type=args.key)
    print(f"initialized {args.mode} node in {args.home}")
    print(f"  config:  {os.path.join(args.home, 'config', 'config.toml')}")
    print(f"  genesis: {cfg.genesis_file}")
    return 0


def cmd_start(args) -> int:
    """ref: commands/run_node.go:97 NewRunNodeCmd (seed mode dispatches
    to the pex-only seed node, node/seed.go). The reference's e2e knobs
    (TM_TPU_LOCKCHECK, TM_TPU_RACECHECK, TM_TPU_BYZ, TM_TPU_PROF) arm
    tooling the port has not queued: set, they raise."""
    from .node.node import check_tooling_env

    check_tooling_env(("TM_TPU_LOCKCHECK", "TM_TPU_RACECHECK", "TM_TPU_BYZ", "TM_TPU_PROF"))

    # TM_TPU_DEVOBS=1: the device-plane observatory (tendermint_device_*
    # metrics, build and transfer events), installed before the node
    # runtime so the first kernel build is attributed. Unset: installs
    # nothing.
    from . import devobs

    if devobs.maybe_install() is not None:
        print("devobs device observatory on -> tendermint_device_* metrics")

    from .config import load_config
    from .node import Node

    # Install fault-injection handlers BEFORE construction: a
    # `disconnect` SIGUSR1 may arrive while the node is still replaying
    # its WAL, and the default disposition would kill it.
    _router_cell = []
    signal.signal(signal.SIGUSR1,
                  lambda *a: _router_cell and _router_cell[0].set_network_enabled(False))
    signal.signal(signal.SIGUSR2,
                  lambda *a: _router_cell and _router_cell[0].set_network_enabled(True))

    cfg = load_config(args.home)
    if args.proxy_app:
        cfg.base.proxy_app = args.proxy_app
    if cfg.base.mode == "seed":
        from .node.seed import SeedNode

        node = SeedNode(cfg)
        node.start()
        print(f"seed node {node.node_id} started\n  p2p: {node.endpoint()}")
    else:
        node = Node(cfg)
        node.start()
        rpc = node.rpc_address
        print(f"node {node.node_id} started")
        print(f"  p2p: {node.p2p_endpoint}")
        if rpc:
            print(f"  rpc: http://{rpc[0]}:{rpc[1]}")
        if node.prometheus_server is not None:
            print(f"  prometheus: http://{node.prometheus_server.host}:{node.prometheus_server.port}/metrics")
    sys.stdout.flush()

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    # Arm the partition switch: SIGUSR1 severs all p2p connections and
    # refuses new ones, SIGUSR2 reconnects.
    router = getattr(node, "router", None)
    if router is not None:
        _router_cell.append(router)
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        node.stop()
    return 0


def cmd_testnet(args) -> int:
    """Generate a multi-node testnet layout
    (ref: commands/testnet.go)."""
    from .config import default_config
    from .node import NodeKey, init_files_home
    from .privval import FilePV
    from .types.genesis import GenesisDoc, GenesisValidator
    from .utils.tmtime import Time

    n = args.validators
    base = args.output
    pvs = []
    for i in range(n):
        home = os.path.join(base, f"node{i}")
        cfg = default_config(home)
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pv = FilePV.load_or_generate(cfg.priv_validator_key_file, cfg.priv_validator_state_file,
                                     key_type=args.key)
        NodeKey.load_or_gen(cfg.node_key_file)
        pvs.append(pv)

    from .types.params import ConsensusParams, ValidatorParams

    gen_doc = GenesisDoc(
        chain_id=args.chain_id or f"testnet-{os.urandom(3).hex()}",
        genesis_time=Time.now(),
        consensus_params=ConsensusParams(
            validator=ValidatorParams(pub_key_types=(args.key,))
        ),
        validators=[
            GenesisValidator(address=pv.get_pub_key().address(), pub_key=pv.get_pub_key(), power=10, name=f"node{i}")
            for i, pv in enumerate(pvs)
        ],
    )

    node_ids = []
    for i in range(n):
        home = os.path.join(base, f"node{i}")
        cfg = default_config(home)
        nk = NodeKey.load_or_gen(cfg.node_key_file)
        node_ids.append(nk.node_id)

    for i in range(n):
        home = os.path.join(base, f"node{i}")
        cfg = default_config(home)
        gen_doc.save_as(cfg.genesis_file)
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{args.starting_port + 2 * i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{args.starting_port + 2 * i + 1}"
        peers = [
            f"{node_ids[j]}@127.0.0.1:{args.starting_port + 2 * j}" for j in range(n) if j != i
        ]
        cfg.p2p.persistent_peers = ",".join(peers)
        cfg.save()
    print(f"generated {n}-validator testnet in {base} (chain id {gen_doc.chain_id})")
    return 0


def cmd_show_node_id(args) -> int:
    from .config import load_config
    from .node import NodeKey

    cfg = load_config(args.home)
    print(NodeKey.load_or_gen(cfg.node_key_file).node_id)
    return 0


def cmd_show_validator(args) -> int:
    from .config import load_config
    from .privval import FilePV

    cfg = load_config(args.home)
    pv = FilePV.load(cfg.priv_validator_key_file, cfg.priv_validator_state_file)
    pub = pv.get_pub_key()
    print(json.dumps({"type": pub.type_name, "value": pub.bytes().hex()}))
    return 0


def cmd_gen_validator(args) -> int:
    """ref: commands/gen_validator.go (--key flag)."""
    from .privval import FilePV

    kt = args.key
    key = FilePV.generate(key_type=kt).priv_key  # one dispatch table (file_pv.py)
    print(
        json.dumps(
            {
                "address": key.pub_key().address().hex().upper(),
                "pub_key": {"type": kt, "value": key.pub_key().bytes().hex()},
                "priv_key": {"type": kt, "value": key.bytes().hex()},
            },
            indent=2,
        )
    )
    return 0


def cmd_gen_node_key(args) -> int:
    from .crypto.ed25519 import Ed25519PrivKey
    from .p2p import node_id_from_pubkey

    key = Ed25519PrivKey.generate()
    print(json.dumps({"id": node_id_from_pubkey(key.pub_key()), "priv_key": key.bytes().hex()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tendermint-tpu", description="TPU-native BFT consensus engine")
    p.add_argument("--home", default=_default_home(), help="node home directory")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="show version").set_defaults(fn=cmd_version)

    sp = sub.add_parser("completion", help="emit a shell completion script (ref: commands/completion.go)")
    sp.add_argument("shell", nargs="?", default="bash", choices=["bash", "zsh"])
    sp.add_argument("--prog", default="tendermint-tpu",
                    help="command name to complete (your alias/wrapper for the CLI)")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("init", help="initialize a node home directory")
    sp.add_argument("mode", nargs="?", default="validator", choices=["validator", "full", "seed"])
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--key", default="ed25519", choices=["ed25519", "sr25519", "secp256k1"],
                    help="validator key type (ref: init.go:37)")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node")
    sp.add_argument("--proxy-app", default="")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("testnet", help="generate a localnet layout")
    sp.add_argument("--validators", type=int, default=4)
    sp.add_argument("--output", default="./testnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", type=int, default=26656)
    sp.add_argument("--key", default="ed25519", choices=["ed25519", "sr25519", "secp256k1"],
                    help="validator key type")
    sp.set_defaults(fn=cmd_testnet)

    sub.add_parser("show-node-id", help="print the p2p node id").set_defaults(fn=cmd_show_node_id)
    sub.add_parser("show-validator", help="print the validator pubkey").set_defaults(fn=cmd_show_validator)
    sp = sub.add_parser("gen-validator", help="generate a validator keypair")
    sp.add_argument("--key", default="ed25519", choices=["ed25519", "sr25519", "secp256k1"],
                    help="key type (ref: gen_validator.go)")
    sp.set_defaults(fn=cmd_gen_validator)
    sub.add_parser("gen-node-key", help="generate a node key").set_defaults(fn=cmd_gen_node_key)
    sub.add_parser("unsafe-reset-all", help="wipe the data directory").set_defaults(fn=cmd_later)

    sp = sub.add_parser("reset", help="reset subsets of node data (ref: commands/reset.go)")
    sp.add_argument("what", nargs="?", default="unsafe-all",
                    choices=["blockchain", "peers", "unsafe-signer", "unsafe-all"])
    sp.set_defaults(fn=cmd_later)
    sub.add_parser("rollback", help="rewind state one height").set_defaults(fn=cmd_later)
    sub.add_parser("inspect", help="read-only RPC over node data").set_defaults(fn=cmd_later)

    sp = sub.add_parser("e2e", help="run a manifest-driven multi-process e2e testnet")
    sp.add_argument("manifest", help="path to a TOML manifest (see e2e/manifest.py)")
    sp.add_argument("--output", default="", help="testnet working directory")
    sp.add_argument("--duration", type=float, default=15.0, help="load duration seconds")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("e2e-generate", help="generate randomized e2e manifests for CI")
    sp.add_argument("--seed", type=int, default=0, help="first RNG seed")
    sp.add_argument("--seeds", type=int, default=1, help="number of seeds to sweep")
    sp.add_argument("--output", required=True, help="directory for generated manifests")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("debug", help="capture a running node's state (kill|dump)")
    sp.add_argument("debug_command", choices=["kill", "dump"])
    sp.add_argument("--rpc-laddr", default="http://127.0.0.1:26657")
    sp.add_argument("--output", default="", help="output zip path")
    sp.add_argument("--pid", type=int, default=0, help="(kill) process to SIGABRT after capture")
    sp.add_argument("--interval", type=float, default=2.0, help="(dump) seconds between dumps")
    sp.add_argument("--count", type=int, default=1, help="(dump) number of dumps")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("replay", help="re-sync the app by replaying stored blocks over ABCI")
    sp.add_argument("--app", default="", help="override proxy_app (e.g. builtin:kvstore)")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("replay-console",
                        help="interactive WAL playback (next/back/rs/locate)")
    sp.add_argument("--app", default="", help="override proxy_app (e.g. builtin:kvstore)")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("reindex-event", help="rebuild the tx/block event index from stored blocks")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_later)

    sub.add_parser("compact", help="compact the node's append-only databases").set_defaults(fn=cmd_later)

    sub.add_parser(
        "key-migrate",
        help="upgrade legacy DB key layouts to the current format",
    ).set_defaults(fn=cmd_later)

    sub.add_parser(
        "config-migrate",
        help="normalize config.toml to the current schema (drops stale keys)",
    ).set_defaults(fn=cmd_later)

    sp = sub.add_parser("wal2json", help="decode a consensus WAL file to JSON lines")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("json2wal", help="re-frame JSON lines into a consensus WAL file")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser(
        "remote-signer",
        help="run an external signer (dials tcp://|unix:// validators; "
             "hosts the service itself for grpc://)",
    )
    sp.add_argument(
        "--addr", required=True,
        help="validator privval listen address (tcp:// or unix://), or a "
             "grpc:// address for this signer to listen on (the validator "
             "dials it; set priv_validator_laddr to the printed address)",
    )
    sp.add_argument("--chain-id", required=True)
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("light", help="run a verifying light client against a primary")
    sp.add_argument("chain_id")
    sp.add_argument("primary", help="primary RPC address (http://host:port)")
    sp.add_argument("--witnesses", default="", help="comma-separated witness RPC addresses")
    sp.add_argument("--trusted-height", type=int, default=0)
    sp.add_argument("--trusted-hash", default="")
    sp.add_argument("--trusting-period", type=float, default=168 * 3600)
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888",
                    help="serve a verifying RPC proxy here (ref: light/proxy)")
    sp.add_argument("--report", default="",
                    help="write a JSON divergence report here every update "
                         "cycle (refused primary responses; docs/byzantine.md)")
    sp.set_defaults(fn=cmd_later)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
