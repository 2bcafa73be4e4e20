"""The port stands alone and runs on the card unless told otherwise:
importing every module of tendermint_tpu_torch (the sr25519 plane's, the
engine's, the telemetry's, the secp256k1 key type's, the merkle plane's, the
light client's with its stores and providers, evidence's, the state
layer's with its stores, evidence pool and ABCI app, blocksync's with
the p2p layer beneath it, consensus's with its vote sets, file signer,
mempool, WAL, ticker and handshake, and the TCP transport, secret
connection, PEX and the consensus, mempool and evidence reactors, and the
node with its config, pubsub, event bus, indexer, RPC and CLI included,
and the operator's tools: the HTTP provider, the light proxy, the remote
and gRPC signers, the SQL sinks and the flight recorder)
loads no JAX
and nothing of tendermint_tpu, the native host prep and merkle plane load
the port's own library (never the reference's prep.so), a default-device
verifier, a default-device BlockSyncReactor's light check and a
default-device EngineTxPreVerifier raise without CUDA instead of running
on the host (a gossiped admission's raise reaching the mempool reactor's
on_fatal), the node, the CLI and the signers import with grpcio hidden (a
grpc:// signer address then raises by name), and
TM_TPU_ENGINE selects the engine or direct dispatch as the reference's
does."""

import os
import subprocess
import sys

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as B
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as sr
from tendermint_tpu_torch.metrics import engine_metrics
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import engine as E
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import tendermint_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in ("crypto.merlin", "crypto.merlin_batch", "crypto.sr25519", "native", "ops.engine",
             "ops.ristretto", "ops.verify_sr", "parallel.sharded_verify", "parallel.multihost",
             "trace", "metrics", "devobs", "crypto.secp256k1", "crypto.encoding", "crypto.softcrypto",
             "crypto.merkle", "types.light_block", "light", "light.verifier", "types.vote",
             "types.evidence", "evidence", "evidence.verify", "store", "store.kv", "light.client",
             "light.store", "light.provider", "abci", "abci.types", "abci.client", "abci.kvstore", "state",
             "state.state", "state.store", "state.validation", "state.execution", "store.blockstore",
             "types.params", "types.genesis", "types.part_set", "utils.bits", "evidence.pool", "p2p",
             "p2p.types", "p2p.channel", "p2p.transport", "p2p.transport_memory", "p2p.conn_tracker",
             "p2p.peermanager", "p2p.router", "blocksync", "blocksync.pool", "blocksync.reactor",
             "utils.log", "types.proposal", "types.vote_set", "privval", "privval.file_pv", "mempool",
             "mempool.mempool", "mempool.preverify", "consensus", "consensus.messages", "consensus.round_state",
             "consensus.wal", "consensus.ticker", "consensus.state", "consensus.handshake", "utils.varint",
             "p2p.secret_connection", "p2p.transport_tcp", "p2p.pex", "consensus.peer_state",
             "consensus.reactor", "mempool.reactor", "evidence.reactor", "pubsub", "pubsub.query",
             "pubsub.pubsub", "eventbus", "eventbus.event_bus", "eventbus.eventlog", "indexer", "indexer.kv",
             "indexer.service", "config", "config.config", "rpc", "rpc.server", "rpc.core", "rpc.client",
             "node", "node.node", "node.setup", "node.seed", "cli", "__main__", "light.http_provider",
             "light.proxy", "privval.remote", "privval.grpc", "privval.proto", "utils.grpcutil",
             "indexer.sink_sql", "indexer.sink_psql", "metrics.flight", "abci.proto", "abci.socket",
             "abci.grpc", "statesync", "statesync.dispatcher", "statesync.stateprovider", "statesync.syncer",
             "statesync.reactor", "state.rollback", "store.migrate"):
    assert pkg.__name__ + "." + name in names, name
for name in names:
    if name != pkg.__name__ + ".__main__":  # runs the CLI: the second probe's
        importlib.import_module(name)
from tendermint_tpu_torch import abci, blocksync, devobs, evidence, light, metrics, native, p2p, state, store, trace
from tendermint_tpu_torch import consensus, mempool, privval
from tendermint_tpu_torch.mempool import preverify
from tendermint_tpu_torch.consensus import reactor as cs_reactor
from tendermint_tpu_torch.mempool import reactor as mp_reactor
from tendermint_tpu_torch.p2p import secret_connection
from tendermint_tpu_torch.crypto import softcrypto
from tendermint_tpu_torch.utils import varint
from tendermint_tpu_torch.crypto import encoding, merkle, secp256k1
from tendermint_tpu_torch.ops import engine, msm, verify, verify_sr
from tendermint_tpu_torch import cli, config, eventbus, indexer, node, pubsub, rpc
from tendermint_tpu_torch.node import seed
from tendermint_tpu_torch.rpc import client as rpc_client
from tendermint_tpu_torch.light import proxy as light_proxy
from tendermint_tpu_torch.privval import grpc as pv_grpc, remote as pv_remote
from tendermint_tpu_torch.indexer import sink_psql, sink_sql
from tendermint_tpu_torch.metrics import flight
from tendermint_tpu_torch import statesync
from tendermint_tpu_torch.abci import grpc as abci_grpc, proto as abci_proto, socket as abci_socket
from tendermint_tpu_torch.statesync import dispatcher as ss_dispatcher, stateprovider as ss_stateprovider
from tendermint_tpu_torch.state import rollback as state_rollback
from tendermint_tpu_torch.store import migrate as store_migrate
for mod, fns in ((verify, ("build_pk_tables", "verify_kernel_cached")),
                 (verify_sr, ("build_sr_tables", "verify_sr_kernel_cached")),
                 (msm, ("msm_verify_kernel_cached", "verify_batch_rlc_cached_async")),
                 (engine, ("get_engine", "verify_async_via_engine", "engine_enabled")),
                 (trace, ("span", "export", "journey_key")),
                 (metrics, ("engine_metrics", "device_metrics", "global_registry")),
                 (devobs, ("install", "transfer_span", "sample_residency", "record_build")),
                 (metrics, ("hash_metrics", "proof_metrics")),
                 (native, ("sha256_batch", "merkle_root", "merkle_proofs", "merkle_multiproof")),
                 (merkle, ("hash_from_byte_slices", "proofs_from_byte_slices",
                           "multiproof_from_byte_slices", "sha256_batch")),
                 (secp256k1, ("route",)), (encoding, ("pubkey_to_proto", "pubkey_from_proto")),
                 (light, ("verify", "verify_adjacent", "verify_non_adjacent", "header_expired",
                          "LightClient", "TrustOptions", "MemLightStore", "DBLightStore", "LocalProvider")),
                 (evidence, ("verify_evidence", "verify_duplicate_vote", "verify_light_client_attack")),
                 (store, ("MemDB", "FileDB")), (metrics, ("evidence_metrics", "StateMetrics")),
                 (state, ("BlockExecutor", "StateStore", "make_genesis_state", "validate_block")),
                 (abci, ("LocalClient", "BaseApplication")), (evidence, ("EvidencePool",)),
                 (p2p, ("Router", "RouterOptions", "PeerManager", "MemoryNetwork", "Endpoint", "NodeInfo",
                        "ConnTracker", "Channel")),
                 (blocksync, ("BlockSyncReactor", "BlockPool", "blocksync_channel_descriptor")),
                 (metrics, ("P2PMetrics", "BlockSyncMetrics")),
                 (consensus, ("ConsensusState", "Handshaker", "WAL", "TimeoutTicker", "HeightVoteSet")),
                 (mempool, ("TxMempool", "LRUTxCache")), (preverify, ("EngineTxPreVerifier", "make_sig_tx")),
                 (privval, ("FilePV",)), (metrics, ("ConsensusMetrics", "MempoolMetrics")),
                 (state.BlockExecutor, ("extend_vote", "verify_vote_extension")),
                 (p2p, ("TcpTransport", "TcpConnection", "SecretConnection", "PexReactor",
                        "pex_channel_descriptor")),
                 (secret_connection, ("route", "derive_secrets", "hkdf_sha256")),
                 (softcrypto, ("ChaCha20Poly1305", "X25519PrivateKey", "X25519PublicKey", "hkdf_sha256", "x25519")),
                 (native, ("aead_chacha20poly1305",)), (varint, ("encode_uvarint", "read_uvarint")),
                 (cs_reactor, ("ConsensusReactor", "consensus_channel_descriptors", "encode_consensus_msg",
                               "decode_consensus_msg")),
                 (mp_reactor, ("MempoolReactor", "mempool_channel_descriptor", "encode_txs_frame",
                               "decode_txs_frame")),
                 (evidence, ("EvidenceReactor", "evidence_channel_descriptor")),
                 (pubsub, ("Server", "parse_query")), (eventbus, ("EventBus",)),
                 (indexer, ("KVIndexer", "IndexerService")), (config, ("load_config", "default_config")),
                 (rpc, ("JSONRPCServer", "RPCEnvironment", "build_routes")),
                 (rpc_client, ("HTTPClient", "WSClient", "EventStream", "LocalClient")),
                 (node, ("Node", "NodeKey", "init_files_home")), (seed, ("SeedNode",)),
                 (metrics, ("PrometheusServer",)), (cli, ("main", "build_parser")),
                 (light, ("HTTPProvider",)), (light_proxy, ("LightProxy",)),
                 (pv_remote, ("SignerClient", "SignerServer", "SignerListenerEndpoint")),
                 (pv_grpc, ("GRPCSignerClient", "GRPCSignerServer")), (sink_sql, ("SQLSink",)),
                 (sink_psql, ("PsqlSink",)), (flight, ("FlightRecorder",)), (metrics, ("FlightMetrics",)),
                 (cli, ("cmd_light", "cmd_replay", "cmd_inspect", "cmd_remote_signer", "cmd_reset")),
                 (statesync, ("StateSyncReactor", "Syncer", "statesync_channel_descriptors")),
                 (ss_dispatcher, ("Dispatcher", "P2PLightProvider")),
                 (ss_stateprovider, ("LightClientStateProvider",)), (metrics, ("StateSyncMetrics",)),
                 (abci_socket, ("SocketClient", "SocketServer", "serve_app")),
                 (abci_grpc, ("GRPCClient", "GRPCServer", "serve_app")),
                 (abci_proto, ("request_to_pb", "request_from_pb", "response_to_pb", "response_from_pb")),
                 (state_rollback, ("rollback_state",)), (store_migrate, ("migrate_db",)),
                 (cli, ("cmd_rollback", "cmd_key_migrate"))):
    for fn in fns:
        assert callable(getattr(mod, fn)), fn
native.load_prep()
key = bytes(range(32))
assert native.aead_chacha20poly1305(True, key, bytes(12), b"", b"frame")[:5] != b"frame"
assert native.aead_chacha20poly1305(False, key, bytes(12), b"",
                                    native.aead_chacha20poly1305(True, key, bytes(12), b"", b"frame")) == b"frame"
assert merkle.hash_from_byte_slices([b"x"] * 16) == native.merkle_root([b"x"] * 16)
with open("/proc/self/maps") as f:
    maps = f.read()
assert str(native.target()) in maps and "tendermint_tpu/native/" not in maps, "prep library"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tendermint_tpu" or m.startswith("tendermint_tpu."))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_import_loads_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


_HELP_PROBE = r"""
import runpy, sys
sys.argv = ["tendermint_tpu_torch", "--help"]
try:
    runpy.run_module("tendermint_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tendermint_tpu" or m.startswith("tendermint_tpu."))
print("leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_cli_help_loads_no_jax_and_no_reference():
    """`python -m tendermint_tpu_torch --help` prints the reference's command
    table and loads neither JAX nor the JAX package."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _HELP_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout
    assert "{version,completion,init,start,testnet," in proc.stdout


_NO_GRPC_PROBE = r"""
import sys
sys.modules["grpc"] = None  # as on a machine without grpcio
import tendermint_tpu_torch.node, tendermint_tpu_torch.cli, tendermint_tpu_torch.privval
from tendermint_tpu_torch.privval import grpc as pv_grpc, remote as pv_remote
from tendermint_tpu_torch.abci import grpc as abci_grpc, socket as abci_socket
from tendermint_tpu_torch.utils import grpcutil
assert grpcutil.grpc is None and pv_grpc.grpc is None and abci_grpc.grpc is None
for make in (lambda: pv_grpc.GRPCSignerClient("grpc://127.0.0.1:1", "c"),
             lambda: grpcutil.GenericGrpcServer(None, "grpc://127.0.0.1:0"),
             lambda: abci_grpc.GRPCClient("grpc://127.0.0.1:1")):
    try:
        make()
        raise SystemExit("a grpc:// signer was made without grpcio")
    except RuntimeError as e:
        assert "grpcio is not available" in str(e), e
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tendermint_tpu" or m.startswith("tendermint_tpu."))
print("leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_node_cli_and_signers_import_without_grpc():
    """On a machine without grpcio the node, the CLI, privval/ and the ABCI
    transports import without it, and a grpc:// signer or app client
    raises, naming grpcio, with no substitute."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _NO_GRPC_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def _jobs(n):
    bv = ed.Ed25519BatchVerifier()
    for i in range(n):
        priv = ref.gen_privkey(bytes([i + 1]) * 32)
        bv.add(ed.Ed25519PubKey(priv[32:]), b"m", ref.sign(priv, b"m"))
    return bv


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _jobs(3).verify()
    # routing by size is not a fallback: below the cutover the host verifies
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 64)
    assert _jobs(3).verify() == (True, [True, True, True])
    # an explicit request for the host path stays one
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    monkeypatch.setenv("TM_TPU_CRYPTO", "off")
    assert _jobs(3).verify() == (True, [True, True, True])


def test_default_device_blocksync_light_check_raises(monkeypatch):
    """A BlockSyncReactor built without `device` runs its light check on the
    card: without CUDA the check raises from _try_sync_one (no peer is
    reported, nothing is verified on the host); with device="cpu" the same
    blocks sync."""
    import chip_smoke as cs
    from test_torch_blocksync import PEER_A, PORT
    from test_torch_state import mem_dbs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 4)
    chain = cs.state_chain(PORT, *_state_members(), _sign, "iso-chain", mem_dbs(PORT), heights=3, device="cpu")
    for kw in ({}, {"device": "cpu"}):
        node, reactor, ch = cs.sync_node(PORT, chain.gen, mem_dbs(PORT), **kw)
        cs.serve(reactor, chain.node.blocks.load_block, PEER_A, 1, 3)
        if not kw:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                reactor._try_sync_one()
            assert ch.errors == [] and reactor.state.last_block_height == 0
        else:
            assert reactor._try_sync_one() and reactor.state.last_block_height == 1


@pytest.mark.parametrize("engine", ["auto", "off"])
def test_default_device_preverifier_raises(monkeypatch, engine):
    """An EngineTxPreVerifier built without `device` sends a batch at or
    above the cutover to the card, through the engine or, with the engine
    off, the direct dispatch: without CUDA it raises from the mempool's
    admission, which admits nothing; with device="cpu" the same batch is
    verified by the plain versions."""
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.mempool import TxMempool
    from tendermint_tpu_torch.mempool.preverify import EngineTxPreVerifier, make_sig_tx

    class App:
        def check_tx(self, req):
            return abci.ResponseCheckTx(code=0, gas_wanted=1)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setenv("TM_TPU_ENGINE", engine)
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    txs = [make_sig_tx(bytes([i + 1]) * 32, b"k%d=v" % i) for i in range(3)]
    pool = TxMempool(App(), pre_verify=EngineTxPreVerifier())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pool.check_tx_batch(txs)
    assert pool.size() == 0
    pool = TxMempool(App(), pre_verify=EngineTxPreVerifier(device="cpu"))
    assert [o.code for o in pool.check_tx_batch(txs)] == [0, 0, 0] and pool.size() == 3


def _state_members():
    """Five ed25519 members and a joiner for a small state chain."""
    out = []
    for i in range(6):
        seed = bytes([i + 40]) * 32
        out.append(("ed25519", ref.gen_privkey(seed)[32:], ("ed25519", seed)))
    return out[:-1], out[-1]


def _sign(secrets, msgs):
    return [ref.sign(ref.gen_privkey(seed), m) for (_, seed), m in zip(secrets, msgs)]


def test_uncovered_settings_raise(monkeypatch):
    """TM_TPU_MSM_CACHE=on verifies (here through the plain versions): the
    RLC reads the pubkey cache, and with TM_TPU_PK_CACHE=off it takes the
    uncached RLC, as the reference's routing does."""
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    monkeypatch.setattr(ed, "MSM_BATCH_CUTOVER", 2)
    monkeypatch.setenv("TM_TPU_MSM_CACHE", "on")
    monkeypatch.setattr(V, "_PK_CACHES", {})
    calls = []
    for name in ("verify_batch_rlc_cached_async", "verify_batch_rlc_async"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name)
                            or _fn(*a, **k))
    for pk_cache, want in (("on", "verify_batch_rlc_cached_async"), ("off", "verify_batch_rlc_async")):
        monkeypatch.setenv("TM_TPU_PK_CACHE", pk_cache)
        calls.clear()
        bv = _jobs(2)
        bv.device = "cpu"
        assert bv.verify() == (True, [True, True])
        assert calls == [want]
        assert len(V.pubkey_cache("cpu")._lru) == 2  # filled by the cached RLC, kept

    sr_key = sr.Sr25519PubKey(b"\x01" * 32)
    assert B.supports_batch_verifier(sr_key)
    bv = B.create_batch_verifier(sr_key, device="cpu")
    assert isinstance(bv, sr.Sr25519BatchVerifier) and bv.device == "cpu"
    with pytest.raises(ValueError, match="pubkey is not ed25519"):
        B.create_batch_verifier(ed.Ed25519PubKey(b"\x01" * 32)).add(sr_key, b"", b"\x00" * 64)


def _counted(series, *labels):
    """A metric child's value in the port's global registry (0 if unset)."""
    return {tuple(s[1].values()): s[2] for s in series.samples()}.get(labels, 0)


@pytest.mark.parametrize("setting", ["on", "auto", "off", None])
def test_engine_setting(monkeypatch, setting):
    """TM_TPU_ENGINE, as the reference reads it: on, auto or unset submits
    each batch of both verifiers to the coalescing engine (get_engine()
    counts the job), off runs direct dispatch (counted as direct_host);
    the verdicts are the same."""
    if setting is None:
        monkeypatch.delenv("TM_TPU_ENGINE", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_ENGINE", setting)
    monkeypatch.setenv("TM_TPU_CRYPTO", "off")
    msg = b"engine"
    priv = sr.Sr25519PrivKey(b"\x02" * 32)
    sr_bv = sr.Sr25519BatchVerifier(device="cpu")
    sr_bv.add(priv.pub_key(), msg, priv.sign(msg))
    m = engine_metrics()
    for plane, bv in (("ed25519", _jobs(2)), ("sr25519", sr_bv)):
        before = (_counted(m.submitted_jobs, plane), _counted(m.launches, plane, "direct_host"))
        assert bv.verify() == (True, [True] * len(bv))
        after = (_counted(m.submitted_jobs, plane), _counted(m.launches, plane, "direct_host"))
        if setting == "off":
            assert after == (before[0], before[1] + 1)
        else:
            assert after == (before[0] + 1, before[1])
    assert E.engine_enabled() == (setting != "off")


def test_kernel_build_needs_nvcc(monkeypatch):
    """No quiet fallback when the toolkit is missing: the build raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert set(_build.KERNELS) == {"verify", "pk_tables", "verify_cached", "msm", "verify_sr",
                                   "sr_tables", "verify_sr_cached", "msm_sr", "pk_tables_single",
                                   "verify_cached_single", "msm_cached", "sr_tables_single",
                                   "verify_sr_cached_single", "fail_count"}
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_default_device_gossiped_admission_reaches_on_fatal(monkeypatch):
    """A MempoolReactor over a TxMempool whose EngineTxPreVerifier was built
    without `device`: without CUDA, a gossiped frame's admission raises a
    marked fault, which the reactor hands to on_fatal (no peer reported,
    nothing admitted), instead of verifying on the host."""
    import time

    import chip_smoke as cs
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.crypto.batch import is_fault
    from tendermint_tpu_torch.mempool import TxMempool
    from tendermint_tpu_torch.mempool.preverify import EngineTxPreVerifier, make_sig_tx
    from tendermint_tpu_torch.mempool.reactor import MempoolReactor
    from tendermint_tpu_torch.p2p.types import Envelope

    class App:
        def check_tx(self, req):
            return abci.ResponseCheckTx(code=0, gas_wanted=1)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    txs = [make_sig_tx(bytes([i + 1]) * 32, b"k%d=v" % i) for i in range(3)]
    pool, fatal = TxMempool(App(), pre_verify=EngineTxPreVerifier()), []
    ch = cs.StubChannel([Envelope(message=txs, from_="ab" * 20)])
    reactor = MempoolReactor(pool, ch, cs.StubPeers(), on_fatal=fatal.append)
    reactor.start()
    deadline = time.monotonic() + 20
    while not fatal and time.monotonic() < deadline:
        time.sleep(0.01)
    reactor.stop()
    assert len(fatal) == 1 and isinstance(fatal[0], RuntimeError) and "no CUDA device" in str(fatal[0])
    assert is_fault(fatal[0]) and ch.errors == [] and pool.size() == 0
