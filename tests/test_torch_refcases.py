"""The reference's own test cases run on the port: tests/<name>.py loaded
again with every import of the JAX package pointed at the port's module of
the same name (tests/helpers.py, tests/test_consensus.py and
tests/test_p2p.py, which other test files import, likewise), so each
assertion the reference makes of its mempool, private validator, consensus
state machine, WAL, ticker, handshake, TCP transport, secret connection,
PEX, reactors, pubsub, event bus, event log, indexer, metrics, RPC, node
and CLI is made of the port's. test_torch_mempool.py,
test_torch_privval.py, test_torch_consensus.py, test_torch_p2p_tcp.py and
test_torch_reactors.py collect the cases through `reference_cases` and run
them through `run_reference_case`, and this file the node's
(test_node_cases); the reference's files themselves are not changed. The
port's entry points take their default device: the cases verify below the
device cutover, on the host."""

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
    return re.sub(rf"^from ({shared}) import", r"from \1__port import", src, flags=re.M)


def port_copy(name: str) -> types.ModuleType:
    """The port copy of tests/<name>.py, loaded once a process."""
    if name not in _COPIES:
        src = port_source(name)
        for dep in SHARED:
            if re.search(rf"^from {dep}__port import", src, flags=re.M):
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
    case of a parametrized one apart; none is marked slow in the reference
    (a slow one would be left out)."""
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
        if not grid:
            out.append(pytest.param(name, test, {}, id=test))
            continue
        (mark,) = grid
        argnames = [a.strip() for a in mark.args[0].split(",")] if isinstance(mark.args[0], str) else mark.args[0]
        for i, values in enumerate(mark.args[1]):
            values = values.values if hasattr(values, "values") else values
            kw = dict(zip(argnames, values if len(argnames) > 1 else (values,)))
            out.append(pytest.param(name, test, kw, id=f"{test}[{i}]"))
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
                                  "test_events", "test_eventlog", "test_metrics"])
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
# item, by the module they need
NODE_LATER = {
    "test_rpc.py::test_light_client_over_http_provider": "light/http_provider.py (A14b)",
    "test_events.py::test_sql_sink_indexes_blocks_and_txs": "indexer/sink_sql.py (A14b)",
    "test_events.py::test_node_with_sqlite_sink": "indexer/sink_sql.py (A14b)",
    "test_metrics.py::test_subsystem_metrics_surface": "StateSyncMetrics with statesync/ (A15)",
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


@pytest.mark.parametrize("case", sorted(NODE_LATER))
def test_node_cases_waiting_for_a_later_item_are_named(case):
    """Each reference case left out of test_node_cases exists and names the
    module and ROADMAP item it waits for."""
    name, test = case.split("::")
    assert test in vars(port_copy(name[:-3])), case
    assert "(A1" in NODE_LATER[case]
