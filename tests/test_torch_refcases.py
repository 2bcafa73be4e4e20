"""The reference's own test cases run on the port: tests/<name>.py loaded
again with every import of the JAX package pointed at the port's module of
the same name (tests/helpers.py, tests/test_consensus.py and
tests/test_p2p.py, which other test files import, likewise), so each
assertion the reference makes of its mempool, private validator, consensus
state machine, WAL, ticker, handshake, TCP transport, secret connection,
PEX, reactors, pubsub, event bus, event log, indexer, metrics, RPC, node,
CLI and operator commands, light proxy, remote and gRPC signers and SQL
sinks is made of the port's. test_torch_mempool.py,
test_torch_privval.py, test_torch_consensus.py, test_torch_p2p_tcp.py and
test_torch_reactors.py collect the cases through `reference_cases` and run
them through `run_reference_case`, and this file the node's
(test_node_cases) and the operator's tools' (test_operator_cases,
test_remote_signer_cases); the reference's files themselves are not
changed. The port's entry points take their default device: the cases
verify below the device cutover, on the host."""

from __future__ import annotations

import inspect
import os
import re
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
# the test modules other reference test files import by name
SHARED = ("helpers", "test_consensus", "test_p2p")
# the JAX package's modules a reference test file imports for cases the port
# cannot run yet: their import lines are left out of the port copy, and
# those cases are skipped by name where they are collected
LATER: dict[str, tuple[str, ...]] = {}
_COPIES: dict[str, types.ModuleType] = {}


def port_source(name: str) -> str:
    """tests/<name>.py with `tendermint_tpu` read as `tendermint_tpu_torch`
    and the SHARED modules' imports pointed at their port copies."""
    with open(os.path.join(HERE, name + ".py")) as f:
        src = f.read()
    for mod in LATER.get(name, ()):
        src = re.sub(rf"^from tendermint_tpu\.{re.escape(mod)} import [^\n(]*\n", "", src, flags=re.M)
    src = re.sub(r"\btendermint_tpu\b", "tendermint_tpu_torch", src)
    shared = "|".join(SHARED)
    src = re.sub(rf"^([ \t]*)import ({shared}) as ", r"\1import \2__port as ", src, flags=re.M)
    return re.sub(rf"^([ \t]*)from ({shared}) import", r"\1from \2__port import", src, flags=re.M)


def port_copy(name: str) -> types.ModuleType:
    """The port copy of tests/<name>.py, loaded once a process."""
    if name not in _COPIES:
        src = port_source(name)
        for dep in SHARED:
            if re.search(rf"^[ \t]*(from {dep}__port import|import {dep}__port as )", src, flags=re.M):
                port_copy(dep)
        mod = types.ModuleType(name + "__port")
        mod.__file__ = os.path.join(HERE, name + ".py")
        sys.modules[mod.__name__] = mod
        _COPIES[name] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return _COPIES[name]


def reference_cases(name: str, skip=(), only=None):
    """pytest params (module, test, kwargs) for every test function of
    tests/<name>.py outside `skip` (and, where `only` is given, in it), each
    case of a parametrized one apart, each carrying the reference's skipif
    marks (tests/test_sink_psql.py's live-Postgres cases); none is marked
    slow in the reference (a slow one would be left out)."""
    out = []
    for test, fn in vars(port_copy(name)).items():
        if not test.startswith("test_") or not inspect.isfunction(fn) or test in skip:
            continue
        if only is not None and test not in only:
            continue
        marks = getattr(fn, "pytestmark", [])
        if any(mk.name == "slow" for mk in marks):
            continue
        grid = [mk for mk in marks if mk.name == "parametrize"]
        skips = [mk for mk in marks if mk.name == "skipif"]
        if not grid:
            out.append(pytest.param(name, test, {}, id=test, marks=skips))
            continue
        (mark,) = grid
        argnames = [a.strip() for a in mark.args[0].split(",")] if isinstance(mark.args[0], str) else mark.args[0]
        for i, values in enumerate(mark.args[1]):
            values = values.values if hasattr(values, "values") else values
            kw = dict(zip(argnames, values if len(argnames) > 1 else (values,)))
            out.append(pytest.param(name, test, kw, id=f"{test}[{i}]", marks=skips))
    return out


def run_reference_case(name: str, test: str, kw: dict, request) -> None:
    """Run one reference case on the port, its other arguments (tmp_path,
    monkeypatch) from pytest's fixtures."""
    fn = getattr(port_copy(name), test)
    args = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters if p not in kw}
    fn(**kw, **args)


@pytest.mark.parametrize("name", ["helpers", "test_consensus", "test_consensus_locking", "test_handshake",
                                  "test_mempool", "test_privval", "test_p2p", "test_mconn", "test_pex",
                                  "test_consensus_reactor", "test_mempool_reactor", "test_rpc", "test_node",
                                  "test_events", "test_eventlog", "test_metrics", "test_light_proxy",
                                  "test_cli_ops", "test_privval_remote", "test_privval_grpc", "test_sink_psql",
                                  "test_statesync", "test_abci_socket", "test_abci_grpc"])
def test_port_copies_reach_only_the_port(name):
    """A port copy names no module of the JAX package, and every package
    module in its namespace is the port's."""
    assert not re.search(r"\btendermint_tpu\b(?!_torch)", port_source(name))
    mod = port_copy(name)
    for value in vars(mod).values():
        owner = getattr(value, "__module__", None) if not isinstance(value, types.ModuleType) else value.__name__
        if isinstance(owner, str) and owner.startswith("tendermint_tpu"):
            assert owner.startswith("tendermint_tpu_torch"), (name, owner)


# the reference cases of the node slice (ROADMAP A14a) that wait for a later
# item, by the module they need; none is left
NODE_LATER: dict[str, str] = {}
# the cases that waited for a later item and run in test_node_cases since it landed
NODE_LANDED = {
    "test_metrics.py::test_subsystem_metrics_surface": "StateSyncMetrics with statesync/ (A15a)",
}
NODE_FILES = ("test_rpc", "test_node", "test_events", "test_eventlog", "test_metrics")

# the reference's module-scoped fixtures, on the port: pytest finds them by name here
live_node = port_copy("test_rpc").live_node
testnet = port_copy("test_node").testnet


@pytest.mark.parametrize("name,test,kw", [
    case for name in NODE_FILES
    for case in reference_cases(name, skip=tuple(t.split("::")[1] for t in NODE_LATER if t.startswith(name + ".")))])
def test_node_cases(name, test, kw, request):
    """The reference's cases of the pubsub, event bus, event log, indexer,
    metrics, RPC, node and CLI on the port."""
    run_reference_case(name, test, kw, request)


@pytest.mark.parametrize("case", sorted({**NODE_LATER, **NODE_LANDED}))
def test_node_cases_waiting_for_a_later_item_are_named(case):
    """Each reference case left out of test_node_cases exists and names the
    module and ROADMAP item it waits for; one whose item has landed is
    collected by test_node_cases."""
    name, test = case.split("::")
    assert test in vars(port_copy(name[:-3])), case
    if case in NODE_LANDED:
        assert case not in NODE_LATER and "(A1" in NODE_LANDED[case]
        assert test in [c.values[1] for c in reference_cases(name[:-3])]
        return
    assert "(A1" in NODE_LATER[case]


# the reference cases of the operator's tools (ROADMAP A14b) that wait for a
# later item: the tooling's WAL console
OPERATOR_LATER = {
    "test_cli_ops.py::test_replay_console_steps_and_rewinds": "consensus/replay_console.py (tooling, not queued)",
}
# the cases that waited for a later item and run in test_operator_cases since it landed
OPERATOR_LANDED = {
    "test_cli_ops.py::test_key_migrate_legacy_layout": "store/migrate.py with key-migrate (A15b)",
}
OPERATOR_FILES = ("test_light_proxy", "test_cli_ops", "test_privval_grpc", "test_sink_psql")

# tests/test_light_proxy.py's module-scoped node and proxy, and the signers'
# fixtures, on the port: pytest finds them by name here
node = port_copy("test_light_proxy").node
proxy = port_copy("test_light_proxy").proxy
grpc_signer = port_copy("test_privval_grpc").grpc_signer
live_sink = port_copy("test_sink_psql").live_sink
signer_pair = port_copy("test_privval_remote").signer_pair


@pytest.mark.parametrize("name,test,kw", [
    case for name in OPERATOR_FILES
    for case in reference_cases(name, skip=tuple(t.split("::")[1] for t in OPERATOR_LATER
                                                 if t.startswith(name + ".")))])
def test_operator_cases(name, test, kw, request):
    """The reference's cases of the light proxy over HTTP, the operator
    commands (reset, debug, replay, reindex-event, compact, wal2json,
    json2wal, config-migrate, completion), the gRPC signer and the SQL
    sinks on the port."""
    run_reference_case(name, test, kw, request)


def _uses_signer_pair(test):
    return "signer_pair" in inspect.signature(getattr(port_copy("test_privval_remote"), test)).parameters


@pytest.mark.parametrize("name,test,kw", [case for case in reference_cases("test_privval_remote")
                                          if _uses_signer_pair(case.values[1])])
def test_remote_signer_cases(name, test, kw, signer_pair, request):
    """The reference's remote-signer cases over its (endpoint, client,
    server, signer) pair, on tcp (the secret connection) and on unix."""
    run_reference_case(name, test, kw, request)


@pytest.mark.parametrize("name,test,kw", [case for case in reference_cases("test_privval_remote")
                                          if not _uses_signer_pair(case.values[1])])
def test_remote_signer_node_cases(name, test, kw, request):
    """The reference's remote-signer cases that build their own pair: a
    redial after a failed request, the double-sign guard across a signer
    restart, and a node signing through a remote signer."""
    run_reference_case(name, test, kw, request)


@pytest.mark.parametrize("case", sorted({**OPERATOR_LATER, **OPERATOR_LANDED}))
def test_operator_cases_waiting_for_a_later_item_are_named(case):
    """Each reference case left out of test_operator_cases exists and names
    the module and item it waits for; one whose item has landed is
    collected by test_operator_cases."""
    name, test = case.split("::")
    assert test in vars(port_copy(name[:-3])), case
    if case in OPERATOR_LANDED:
        assert case not in OPERATOR_LATER and "(A1" in OPERATOR_LANDED[case]
        assert test in [c.values[1] for c in reference_cases(name[:-3])]
        return
    assert "(A1" in OPERATOR_LATER[case] or "(tooling" in OPERATOR_LATER[case]


# the reference's cases of state sync (ROADMAP A15a) and the remote app
# clients (A15b): the kvstore's snapshots, a sync over the p2p channels and
# by a node over HTTP and over p2p, the wire codec, the syncer's retries,
# the socket and gRPC transports and nodes on external app processes
STATESYNC_FILES = ("test_statesync", "test_abci_socket", "test_abci_grpc")

# the remote app clients' function-scoped pairs, on the port
socket_pair = port_copy("test_abci_socket").socket_pair
grpc_pair = port_copy("test_abci_grpc").grpc_pair


@pytest.mark.parametrize("name,test,kw", [case for name in STATESYNC_FILES for case in reference_cases(name)])
def test_statesync_and_remote_app_cases(name, test, kw, request):
    """The reference's cases of state sync and the socket and gRPC ABCI
    transports on the port."""
    run_reference_case(name, test, kw, request)
