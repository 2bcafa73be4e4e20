"""The port's mempool (mempool/mempool.py, mempool/preverify.py): the
reference's tests/test_mempool.py cases run on the port (test_torch_refcases),
then the port's EngineTxPreVerifier and TxMempool against the JAX
package's on one batch of signed-tx envelopes (valid, tampered, unsigned,
duplicated), the port with both cutovers at 1 on device="cpu", the engine
on and off, so that its device batch runs the plain versions of the RLC,
the cache fill and the cache hit (the reference on its host route, below its cutover):
the same verdicts and check_tx_batch outcomes. A pre-verifier fault (a
kernel wrapper's ValueError, raised by the device entry points) propagates
from check_tx_batch, from its deferred pass and from the async admitter
(its next submit), where the reference records it as a tx's outcome or
drops it; an app's error stays an outcome."""

import time

import pytest
import torch

import chip_smoke as cs
from test_torch_refcases import reference_cases, run_reference_case
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.mempool import mempool as jmempool
from tendermint_tpu.mempool import preverify as jpreverify
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.mempool import mempool as tmempool
from tendermint_tpu_torch.mempool import preverify as tpreverify
from tendermint_tpu_torch.ops import msm as tmsm
from tendermint_tpu_torch.ops import verify as tverify

torch.set_num_threads(1)

FAULT = "no kernel for device cpu"
DEADLINE_S = 20


@pytest.mark.parametrize("name,test,kw", reference_cases("test_mempool"))
def test_reference_case_on_port(name, test, kw, request):
    run_reference_case(name, test, kw, request)


class App:
    """CheckTx admitting every tx but those starting with "bad" (code 1) and
    raising on those starting with "boom", for both packages' types."""

    def __init__(self, abci):
        self.abci, self.calls = abci, []

    def check_tx(self, req):
        self.calls.append(req.tx)
        if req.tx.startswith(b"boom"):
            raise RuntimeError("the app failed")
        if req.tx.startswith(b"bad"):
            return self.abci.ResponseCheckTx(code=1, log="rejected")
        return self.abci.ResponseCheckTx(code=0, gas_wanted=1)


def envelopes():
    """Eight envelopes from eight keys, the fourth tampered; two unsigned
    txs; the second envelope again."""
    txs = [tpreverify.make_sig_tx(bytes([i + 1]) * 32, b"acct-%d=1" % i) for i in range(8)]
    txs[3] = cs.tampered_envelope(txs[3])
    return txs + [b"plain=1", b"bad-plain=1", txs[1]]


@pytest.fixture(params=["auto", "off"])
def device_route(monkeypatch, request):
    """Both cutovers at 1, the engine on (auto) or off (direct dispatch):
    every envelope batch of the port's pre-verifier is a device batch on
    the verifier's device; counts the plain versions run."""
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 1)
    monkeypatch.setattr(ted, "MSM_BATCH_CUTOVER", 1)
    monkeypatch.setenv("TM_TPU_ENGINE", request.param)
    monkeypatch.setattr(tverify, "_PK_CACHES", {})  # every case starts with a cold pubkey cache
    ran = []
    for mod, name in ((tmsm, "msm_verify_kernel_plain"), (tverify, "build_pk_tables_split_plain"),
                      (tverify, "verify_kernel_cached_split_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: ran.append(_name) or _real(*a, **k))
    return ran


def outcome(o):
    return (type(o).__name__, str(o)) if isinstance(o, Exception) else (o.code, o.log, o.codespace)


def test_verdicts_and_admission_match_reference(device_route):
    txs = envelopes()
    port = tpreverify.EngineTxPreVerifier(device="cpu")(txs)
    jax = jpreverify.EngineTxPreVerifier()(txs)
    assert port == jax == [True] * 3 + [False] + [True] * 4 + [None, None, True]
    assert device_route == ["msm_verify_kernel_plain", "build_pk_tables_split_plain",
                            "verify_kernel_cached_split_plain"]
    out = {}
    for name, abci, mp, pv in (("port", tabci, tmempool, tpreverify.EngineTxPreVerifier(device="cpu")),
                               ("jax", jabci, jmempool, jpreverify.EngineTxPreVerifier())):
        app = App(abci)
        pool = mp.TxMempool(app, pre_verify=pv)
        out[name] = ([outcome(o) for o in pool.check_tx_batch(txs)], pool.size(), app.calls,
                     pool.reap_max_txs(-1))
    assert out["port"] == out["jax"]
    assert out["port"][0][3] == (1, "tx signature pre-verification failed", "mempool")
    assert txs[3] not in out["port"][2]  # rejected before the app


def test_small_batch_stays_on_host(device_route, monkeypatch):
    """Below the device cutover the engine verifies on the host: no plain
    kernel runs."""
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 64)
    assert tpreverify.EngineTxPreVerifier(device="cpu")(envelopes()[:4]) == [True, True, True, False]
    assert device_route == []


@pytest.fixture
def failing(device_route):
    """The device entry points raising a kernel wrapper's ValueError."""
    with cs.failing_entries(FAULT):
        yield


def test_pre_verifier_fault_propagates_from_check_tx_batch(failing):
    app = App(tabci)
    pool = tmempool.TxMempool(app, pre_verify=tpreverify.EngineTxPreVerifier(device="cpu"))
    with pytest.raises(ValueError, match=FAULT):
        pool.check_tx_batch(envelopes())
    for _ in range(2):  # a fault leaves no cache entry: the resubmission faults again
        with pytest.raises(ValueError, match=FAULT):
            pool.check_tx(envelopes()[0])
    assert app.calls == [] and pool.size() == 0


def test_tx_is_admitted_after_a_pre_verifier_fault():
    """check_tx drops the key it cached when the pre-verifier faults, so
    the same tx is admitted once the verifier works again."""
    app = App(tabci)
    pre = FaultAfter(1)
    pool = tmempool.TxMempool(app, pre_verify=pre)
    with pytest.raises(ValueError, match=FAULT):
        pool.check_tx(b"tx-1")
    pre.n = 99
    assert pool.check_tx(b"tx-1").code == 0 and pool.size() == 1 and app.calls == [b"tx-1"]


class FaultAfter:
    """A pre-verifier whose verdicts pass through until its n-th call, which
    raises a kernel wrapper's ValueError."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def __call__(self, txs):
        self.calls += 1
        if self.calls >= self.n:
            raise ValueError(FAULT)
        return [None] * len(txs)


class SecondCallApp(App):
    """Rejects a tx the first time it sees it, raises the second time."""

    def check_tx(self, req):
        self.calls.append(req.tx)
        if self.calls.count(req.tx) > 1:
            raise RuntimeError("the app failed")
        return self.abci.ResponseCheckTx(code=1, log="rejected")


def test_pre_verifier_fault_in_the_deferred_pass_propagates():
    """A duplicate whose first occurrence the app rejects settles through the
    deferred pass (a standalone check_tx): a fault of its pre-verification
    propagates, where the app's own error there stays an outcome."""
    app = SecondCallApp(tabci)
    pool = tmempool.TxMempool(app, pre_verify=FaultAfter(2))
    with pytest.raises(ValueError, match=FAULT):
        pool.check_tx_batch([b"tx-1", b"tx-1"])
    assert app.calls == [b"tx-1"]
    app = SecondCallApp(tabci)
    pool = tmempool.TxMempool(app, pre_verify=FaultAfter(99))
    out = pool.check_tx_batch([b"tx-1", b"tx-1"])
    assert [outcome(o) for o in out] == [(1, "rejected", ""), ("RuntimeError", "the app failed")]


def test_async_admitter_stops_on_a_pre_verifier_fault():
    """The admitter's worker stops on a pre-verifier fault and the next
    submit raises it; before it, an app's error was swallowed as in the
    reference (fire-and-forget)."""
    app = App(tabci)
    pre = FaultAfter(3)
    pool = tmempool.TxMempool(app, pre_verify=pre)
    admitter = tmempool.AsyncBatchAdmitter(pool, max_batch=1)
    assert admitter.submit(b"boom-1") and admitter.submit(b"ok-1")
    deadline = time.monotonic() + DEADLINE_S
    while pool.size() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.size() == 1 and admitter.fault is None
    assert admitter.submit(b"ok-2")
    while admitter.fault is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(ValueError, match=FAULT):
        admitter.submit(b"ok-3")
    assert pool.size() == 1 and admitter.pending() == 0
