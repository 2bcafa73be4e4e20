"""Command-line interface (ref: cmd/tendermint/main.go:28-48 +
cmd/tendermint/commands/).

A copy of the JAX package's cli.py: the commands that make and start a
node (version, init, start in validator, full and seed modes, testnet,
show-node-id, show-validator, gen-validator, gen-node-key) and the
operator's tools (reset and unsafe-reset-all, rollback, inspect, the light
daemon with its verifying proxy, debug, replay, reindex-event, compact,
key-migrate, wal2json, json2wal, config-migrate, completion and
remote-signer). The parser keeps
every command of the reference, so `--help` reads the same; a command the
port has not reached yet (LATER) exits non-zero with an error that names
the ROADMAP item that brings it. Run as
`python -m tendermint_tpu_torch <command>`; `start`, `light` and `replay`
run their verifying layers on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import time

VERSION = "0.35.0-tpu"

# the commands the port has not reached, by the ROADMAP item that would bring them
LATER = dict.fromkeys(("e2e", "e2e-generate", "replay-console"), "tooling, not queued")


def _default_home() -> str:
    return os.environ.get("TMHOME", os.path.expanduser("~/.tendermint-tpu"))


# ---------------------------------------------------------------- commands


def cmd_version(args) -> int:
    print(VERSION)
    return 0


def cmd_completion(args) -> int:
    """ref: commands/completion.go — emit a shell completion script.

    Bash/zsh word completion over the full subcommand table (argparse
    holds it at runtime, so the script never goes stale). There is no
    installed console script, so --prog names the alias/wrapper the
    user invokes (e.g. `alias tt='python -m tendermint_tpu.cli'` then
    `completion --prog tt`); bash applies function completion to
    aliases by name."""
    prog = args.prog
    parser = build_parser()
    subs = sorted(
        c for a in parser._actions if isinstance(a, argparse._SubParsersAction)
        for c in a.choices
    )
    words = " ".join(subs)
    if args.shell == "zsh":
        print(f"#compdef {prog}\n"
              f'_arguments "1: :({words})" "*: :_files"')
    else:
        fn = "_" + prog.replace("-", "_") + "_complete"
        print(fn + "() {\n"
              "  local cur=${COMP_WORDS[COMP_CWORD]}\n"
              "  local i=1 w\n"
              "  # skip global flags (--home VALUE, --flag=value) before the subcommand\n"
              "  while [ $i -lt $COMP_CWORD ]; do\n"
              "    w=${COMP_WORDS[$i]}\n"
              "    case \"$w\" in\n"
              "      --home) i=$((i+2));;\n"
              "      -*) i=$((i+1));;\n"
              "      *) break;;\n"
              "    esac\n"
              "  done\n"
              "  if [ $i -eq $COMP_CWORD ]; then\n"
              f'    COMPREPLY=( $(compgen -W "{words}" -- "$cur") )\n'
              "  else\n"
              "    COMPREPLY=( $(compgen -f -- \"$cur\") )\n"
              "  fi\n"
              "}\n"
              f"complete -F {fn} {prog}")
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


def cmd_reset(args) -> int:
    """ref: commands/reset.go — the reset family:
      blockchain     wipe blocks/state/evidence/indexes/WAL, KEEP the
                     signer state (safe on a live chain)
      peers          drop the peer address store only
      unsafe-signer  zero the privval sign state (double-sign hazard)
      unsafe-all     everything above including signer state
    Bare `unsafe-reset-all` remains an alias of `reset unsafe-all`."""
    from .config import load_config

    # Resolve every path from the loaded config — db-dir, the WAL and
    # the privval state file are all configurable, and a partial reset
    # against hardcoded defaults would split state (reference reset.go
    # likewise resolves from config).
    cfg = load_config(args.home)
    what = getattr(args, "what", "unsafe-all")
    db_dir = cfg.db_dir
    pv_state = cfg.priv_validator_state_file
    wal_dir = os.path.dirname(cfg.wal_file)

    def _rm(path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def _zero_pv():
        os.makedirs(os.path.dirname(pv_state), exist_ok=True)
        with open(pv_state, "w") as f:
            json.dump({"height": 0, "round": 0, "step": 0}, f)

    if what == "peers":
        _rm(os.path.join(db_dir, "peerstore.db"))
        print(f"reset peer store in {db_dir}")
        return 0
    if what == "unsafe-signer":
        _zero_pv()
        print(f"zeroed privval sign state at {pv_state} (DANGEROUS on a live chain)")
        return 0
    if what == "blockchain":
        if os.path.isdir(db_dir):
            for entry in os.listdir(db_dir):
                path = os.path.join(db_dir, entry)
                if path in (pv_state, os.path.join(db_dir, "peerstore.db")) or path == wal_dir:
                    continue
                _rm(path)
        _rm(wal_dir)
        print(f"reset chain data in {db_dir} (signer state and peers kept)")
        return 0
    # unsafe-all
    if os.path.isdir(db_dir):
        shutil.rmtree(db_dir)
    os.makedirs(db_dir, exist_ok=True)
    _rm(wal_dir)
    _zero_pv()
    print(f"reset {db_dir} (privval sign-state zeroed — DANGEROUS on a live chain)")
    return 0


def cmd_rollback(args) -> int:
    """ref: commands/rollback.go."""
    from .config import load_config
    from .node.node import _make_db
    from .state import StateStore
    from .state.rollback import rollback_state
    from .store.blockstore import BlockStore

    cfg = load_config(args.home)
    state_store = StateStore(_make_db(cfg, "state"))
    block_store = BlockStore(_make_db(cfg, "blockstore"))
    height, app_hash = rollback_state(state_store, block_store)
    print(f"rolled back state to height {height} and hash {app_hash.hex().upper()}")
    return 0


def cmd_inspect(args) -> int:
    """Read-only RPC over a crashed node's data
    (ref: internal/inspect/inspect.go:45)."""
    from .config import load_config
    from .indexer import KVIndexer
    from .node.node import _make_db
    from .rpc import JSONRPCServer, RPCEnvironment, build_routes
    from .state import StateStore
    from .store.blockstore import BlockStore
    from .types.genesis import GenesisDoc

    cfg = load_config(args.home)
    state_store = StateStore(_make_db(cfg, "state"))
    block_store = BlockStore(_make_db(cfg, "blockstore"))
    gen_doc = GenesisDoc.from_file(cfg.genesis_file)
    env = RPCEnvironment(
        chain_id=gen_doc.chain_id,
        state_store=state_store,
        block_store=block_store,
        tx_indexer=KVIndexer(_make_db(cfg, "tx_index")),
        gen_doc=gen_doc,
    )
    from urllib.parse import urlparse

    addr = urlparse(cfg.rpc.laddr if "//" in cfg.rpc.laddr else "tcp://" + cfg.rpc.laddr)
    server = JSONRPCServer(build_routes(env), host=addr.hostname or "127.0.0.1", port=addr.port or 0)
    server.start()
    host, port = server.address
    print(f"inspect server on http://{host}:{port} (read-only; ctrl-c to exit)")
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        server.stop()
    return 0


def cmd_light(args) -> int:
    """Light client proxy daemon (ref: commands/light.go +
    light/proxy/proxy.go)."""
    from .light import LightClient, TrustOptions
    from .light.http_provider import HTTPProvider

    primary = HTTPProvider(args.chain_id, args.primary)
    witnesses = [HTTPProvider(args.chain_id, w) for w in (args.witnesses or "").split(",") if w]
    if args.trusted_height and args.trusted_hash:
        opts = TrustOptions(
            period_ns=int(args.trusting_period * 1e9),
            height=args.trusted_height,
            hash=bytes.fromhex(args.trusted_hash),
        )
    else:
        lb = primary.light_block(0)
        opts = TrustOptions(
            period_ns=int(args.trusting_period * 1e9),
            height=lb.height,
            hash=lb.signed_header.hash(),
        )
        print(f"trusting current head: height {lb.height} hash {opts.hash.hex().upper()}")
    client = LightClient(args.chain_id, opts, primary, witnesses=witnesses)
    print(f"light client tracking {args.primary} (chain {args.chain_id})")
    proxy = None
    if getattr(args, "laddr", None):
        from .light.proxy import LightProxy
        from urllib.parse import urlparse as _up

        u = _up(args.laddr if "//" in args.laddr else "tcp://" + args.laddr)
        proxy = LightProxy(client, args.primary, host=u.hostname or "127.0.0.1", port=u.port or 8888)
        proxy.start()
        host, port = proxy.address
        print(f"verifying RPC proxy listening on http://{host}:{port}")
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    # tmbyz divergence report (--report): every primary response the
    # light plane REFUSED — bisection/update errors here, proxy relay
    # refusals from LightProxy.divergence_report() — lands in one JSON
    # artifact the e2e sweep and tmlens can read (docs/byzantine.md).
    from .light.client import LightClientError

    report_path = getattr(args, "report", None)
    verified_heads, update_errors, update_divergences, recent_errors = 0, 0, 0, []

    def _write_report():
        if not report_path:
            return
        proxy_rep = proxy.divergence_report() if proxy is not None else {}
        doc = {
            "verified_heads": verified_heads,
            "update_errors": update_errors,
            "update_divergences": update_divergences,
            "recent_errors": recent_errors[-32:],
            "proxy": proxy_rep,
            # the headline number: refused primary responses across BOTH
            # surfaces (update-loop bisection + proxy relays)
            "divergences": update_divergences + int(proxy_rep.get("divergences", 0)),
        }
        try:
            with open(report_path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError:
            pass

    while not stop:
        try:
            head = client.update()
            verified_heads += 1
            print(f"verified head {head.height} {head.signed_header.hash().hex().upper()[:16]}")
        except Exception as e:
            update_errors += 1
            recent_errors.append(str(e))
            # a verification-shaped refusal means the primary LIED (a
            # forged header failing validate_basic / commit checks); an
            # IO error just means it is dead or restarting — only the
            # former is a divergence
            if isinstance(e, (ValueError, OverflowError, LightClientError)):
                if proxy is not None:  # one ring for both surfaces
                    proxy.record_divergence(f"update: {e}")
                else:
                    update_divergences += 1
            print(f"update error: {e}")
        _write_report()
        time.sleep(args.interval)
    if proxy is not None:
        proxy.stop()
    return 0


def cmd_debug(args) -> int:
    """`debug kill|dump` — capture a node's observable state into a zip
    (ref: cmd/tendermint/commands/debug/{kill,dump}.go)."""
    import io
    import json as _json
    import zipfile

    from .config import load_config
    from .rpc.client import HTTPClient

    cfg = load_config(args.home)

    def capture(zf: zipfile.ZipFile, tag: str) -> None:
        client = HTTPClient(args.rpc_laddr, timeout=5.0)
        for route in ("status", "consensus_state", "dump_consensus_state", "net_info",
                      "num_unconfirmed_txs", "debug_threads"):
            try:
                res = client.call(route)
            except Exception as e:
                res = {"error": str(e)}
            zf.writestr(f"{tag}/{route}.json", _json.dumps(res, indent=2, default=str))
        # WAL + config copies (ref: debug/util.go copyWAL/copyConfig)
        wal_path = cfg.wal_file
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                zf.writestr(f"{tag}/cs.wal", f.read())
        conf_path = os.path.join(args.home, "config", "config.toml")
        if os.path.exists(conf_path):
            zf.writestr(f"{tag}/config.toml", open(conf_path).read())

    out = args.output or f"tendermint-debug-{int(time.time())}.zip"
    if args.debug_command == "dump":
        count = max(1, args.count)
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
            for i in range(count):
                capture(zf, f"dump-{i:03d}")
                if i + 1 < count:
                    time.sleep(args.interval)
        print(f"wrote {count} dump(s) to {out}")
        return 0
    # kill: capture once, then SIGABRT the process
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
        capture(zf, "kill")
    print(f"wrote state capture to {out}")
    if args.pid:
        os.kill(args.pid, signal.SIGABRT)
        print(f"sent SIGABRT to pid {args.pid}")
    return 0


def cmd_replay(args) -> int:
    """Re-sync the app from the block store by replaying every block
    through ABCI (ref: `tendermint replay`, internal/consensus/replay_file.go
    — ours replays committed blocks rather than the WAL tail)."""
    from .config import load_config
    from .consensus import Handshaker
    from .node.node import _make_app, _make_db
    from .state import StateStore, make_genesis_state
    from .store.blockstore import BlockStore
    from .types.genesis import GenesisDoc

    cfg = load_config(args.home)
    gen_doc = GenesisDoc.from_file(cfg.genesis_file)
    state_store = StateStore(_make_db(cfg, "state"))
    block_store = BlockStore(_make_db(cfg, "blockstore"))
    state = state_store.load() or make_genesis_state(gen_doc)
    app = _make_app(args.app or cfg.base.proxy_app)
    hs = Handshaker(state_store, state, block_store, gen_doc)
    final = hs.handshake(app)
    print(
        f"replayed to height {final.last_block_height} "
        f"(app hash {final.app_hash.hex().upper()[:16]}) over {block_store.height()} stored blocks"
    )
    return 0


def cmd_reindex_event(args) -> int:
    """Rebuild the tx/block event index from stored FinalizeBlock
    responses (ref: commands/reindex_event.go)."""
    from .config import load_config
    from .indexer import KVIndexer
    from .node.node import _make_db
    from .state import StateStore
    from .store.blockstore import BlockStore

    cfg = load_config(args.home)
    state_store = StateStore(_make_db(cfg, "state"))
    block_store = BlockStore(_make_db(cfg, "blockstore"))
    # rebuild EVERY configured sink (ref: reindex_event.go loads the
    # eventSinks from config and refuses when indexing is disabled)
    names = [s.strip() for s in cfg.tx_index.indexer.split(",") if s.strip()]
    if names and set(names) == {"null"}:
        print('reindex-event: indexing is disabled (indexer = "null")')
        return 1
    sinks = []
    chain_id = None
    if not names or "kv" in names:
        sinks.append(KVIndexer(_make_db(cfg, "tx_index")))
    if "sqlite" in names:
        from .indexer.sink_sql import SQLSink
        from .types.genesis import GenesisDoc

        chain_id = GenesisDoc.from_file(cfg.genesis_file).chain_id
        os.makedirs(cfg.db_dir, exist_ok=True)
        sinks.append(SQLSink(os.path.join(cfg.db_dir, "events.sqlite"), chain_id))
    if "psql" in names:
        from .indexer.sink_psql import PsqlSink
        from .types.genesis import GenesisDoc

        if chain_id is None:
            chain_id = GenesisDoc.from_file(cfg.genesis_file).chain_id
        sinks.append(PsqlSink(cfg.tx_index.psql_conn, chain_id=chain_id))
    start = args.start_height or block_store.base() or 1
    end = args.end_height or block_store.height()
    n = 0
    for h in range(start, end + 1):
        blk = block_store.load_block(h)
        f_res = state_store.load_finalize_block_responses(h)
        if blk is None or f_res is None:
            continue
        for sink in sinks:
            sink.index_block_events(h, f_res)
            sink.index_tx_events(h, list(blk.txs), list(f_res.tx_results or []))
        n += 1
    print(f"reindexed events for {n} blocks in [{start}, {end}]")
    return 0


def cmd_compact(args) -> int:
    """Compact the append-only FileDB logs (ref: commands/compact.go —
    goleveldb compaction there, log rewrite here)."""
    from .config import load_config
    from .store.kv import FileDB

    cfg = load_config(args.home)
    total = 0
    if not os.path.isdir(cfg.db_dir):
        print(f"no data dir at {cfg.db_dir}")
        return 1
    for name in sorted(os.listdir(cfg.db_dir)):
        if not name.endswith(".db"):
            continue
        path = os.path.join(cfg.db_dir, name)
        db = FileDB(path)
        freed = db.compact()
        db.close()
        total += freed
        print(f"compacted {name}: reclaimed {freed} bytes")
    print(f"total reclaimed: {total} bytes")
    return 0


def cmd_wal2json(args) -> int:
    """`wal2json <file>` — decode a consensus WAL file's CRC-framed
    records to JSON lines on stdout (ref: scripts/wal2json/main.go).
    Stops at the first corrupt record, reporting the clean byte offset
    so an operator can truncate there."""
    import sys

    from .consensus.wal import iter_wal_records

    with open(args.file, "rb") as f:
        data = f.read()
    consumed = 0
    for pos, payload in iter_wal_records(data):
        sys.stdout.write(payload.decode() + "\n")
        consumed = pos + 8 + len(payload)
    if consumed < len(data):
        print(f"# corrupt or torn record at byte {consumed} "
              f"({len(data) - consumed} trailing bytes not decoded)", file=sys.stderr)
        return 1
    return 0


def cmd_json2wal(args) -> int:
    """`json2wal <in.json> <out.wal>` — re-frame JSON lines (as produced
    by wal2json, possibly hand-edited) into a CRC-framed WAL file
    (ref: scripts/json2wal/main.go). Each line is validated against the
    WAL message schema and size limit before framing so a bad edit
    fails loudly here — with its line number — not at node replay."""
    import json as _json
    import sys

    from .consensus.wal import _decode_msg, frame_record

    written = 0
    with open(args.input) as inp, open(args.output, "wb") as out:
        for ln, line in enumerate(inp, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                doc = _json.loads(line)
                _decode_msg(doc)  # schema check
                rec = frame_record(_json.dumps(doc, separators=(",", ":")).encode())
            except Exception as e:
                print(f"{args.input}:{ln}: invalid WAL record: {e}", file=sys.stderr)
                return 1
            out.write(rec)
            written += len(rec)
    print(f"wrote {written} bytes to {args.output}")
    return 0


def cmd_config_migrate(args) -> int:
    """`config-migrate` — normalize a node's config.toml to the current
    schema (ref: scripts/confix): unknown/stale keys are dropped (and
    reported), recognized values preserved, defaults filled in. The old
    file is kept as config.toml.bak."""
    from .config import Config
    from .config.config import DEFAULT_CONFIG_DIR, DEFAULT_CONFIG_FILE

    path = os.path.join(args.home, DEFAULT_CONFIG_DIR, DEFAULT_CONFIG_FILE)
    if not os.path.exists(path):
        print(f"no config at {path}")
        return 1
    with open(path) as f:
        raw = f.read()
    cfg = Config.from_toml(raw, home=args.home)
    if cfg.unknown_keys:
        print("dropping unrecognized keys:")
        for k in cfg.unknown_keys:
            print(f"  - {k}")
    else:
        print("no unrecognized keys; normalizing formatting/defaults only")
    shutil.copyfile(path, path + ".bak")
    cfg.save(path)
    print(f"rewrote {path} (backup at {path}.bak)")
    return 0


def cmd_key_migrate(args) -> int:
    """`key-migrate` — upgrade legacy ASCII-decimal store keys to the
    current fixed-width binary layout (ref: cmd/tendermint/main.go:28-48
    key-migrate, scripts/keymigrate/migrate.go). Idempotent."""
    from .config import load_config
    from .store.kv import FileDB
    from .store.migrate import migrate_db

    cfg = load_config(args.home)
    if not os.path.isdir(cfg.db_dir):
        print(f"no data dir at {cfg.db_dir}")
        return 1
    total = 0
    for name in sorted(os.listdir(cfg.db_dir)):
        if not name.endswith(".db"):
            continue
        path = os.path.join(cfg.db_dir, name)
        db = FileDB(path)
        moved = migrate_db(db)
        db.close()
        total += moved
        print(f"migrated {name}: {moved} keys")
    print(f"total migrated: {total} keys")
    return 0


def cmd_remote_signer(args) -> int:
    """Run a standalone remote signer that dials a validator's privval
    listen address (ref: the reference ships this as the external
    tmkms-style process; endpoints at privval/signer_server.go)."""
    from .config import load_config
    from .privval import FilePV
    from .privval.remote import SignerServer

    cfg = load_config(args.home)
    pv = FilePV.load_or_generate(cfg.priv_validator_key_file, cfg.priv_validator_state_file)
    if args.addr.startswith("grpc://"):
        # gRPC role inversion: the signer hosts the service and the
        # validator dials it (ref: privval/grpc/server.go)
        from .privval.grpc import GRPCSignerServer

        server = GRPCSignerServer(pv, args.chain_id, args.addr)
        server.start()
        print(f"remote signer for {pv.get_pub_key().address().hex().upper()} "
              f"listening on {server.listen_addr}")
    else:
        server = SignerServer(args.addr, pv, args.chain_id)
        server.start()
        print(f"remote signer for {pv.get_pub_key().address().hex().upper()} dialing {args.addr}")
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    while not stop:
        time.sleep(0.2)
    server.stop()
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
    sp.set_defaults(fn=cmd_completion)

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
    sub.add_parser("unsafe-reset-all", help="wipe the data directory").set_defaults(fn=cmd_reset)

    sp = sub.add_parser("reset", help="reset subsets of node data (ref: commands/reset.go)")
    sp.add_argument("what", nargs="?", default="unsafe-all",
                    choices=["blockchain", "peers", "unsafe-signer", "unsafe-all"])
    sp.set_defaults(fn=cmd_reset)
    sub.add_parser("rollback", help="rewind state one height").set_defaults(fn=cmd_rollback)
    sub.add_parser("inspect", help="read-only RPC over node data").set_defaults(fn=cmd_inspect)

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
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser("replay", help="re-sync the app by replaying stored blocks over ABCI")
    sp.add_argument("--app", default="", help="override proxy_app (e.g. builtin:kvstore)")
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("replay-console",
                        help="interactive WAL playback (next/back/rs/locate)")
    sp.add_argument("--app", default="", help="override proxy_app (e.g. builtin:kvstore)")
    sp.set_defaults(fn=cmd_later)

    sp = sub.add_parser("reindex-event", help="rebuild the tx/block event index from stored blocks")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)

    sub.add_parser("compact", help="compact the node's append-only databases").set_defaults(fn=cmd_compact)

    sub.add_parser(
        "key-migrate",
        help="upgrade legacy DB key layouts to the current format",
    ).set_defaults(fn=cmd_key_migrate)

    sub.add_parser(
        "config-migrate",
        help="normalize config.toml to the current schema (drops stale keys)",
    ).set_defaults(fn=cmd_config_migrate)

    sp = sub.add_parser("wal2json", help="decode a consensus WAL file to JSON lines")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_wal2json)

    sp = sub.add_parser("json2wal", help="re-frame JSON lines into a consensus WAL file")
    sp.add_argument("input")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_json2wal)

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
    sp.set_defaults(fn=cmd_remote_signer)

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
    sp.set_defaults(fn=cmd_light)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
