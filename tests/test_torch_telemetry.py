"""The port's telemetry (tendermint_tpu_torch/trace, metrics, devobs) held
to the reference's on the CPU.

The EngineMetrics and DeviceMetrics groups render the reference's series
(names, labels, help, buckets); the same verify_commit calls, through the
engine and through direct dispatch, on the host plane and the device
plane, write the reference's spans with the reference's args, the flow of
each job linking its submit, dispatch and collect spans; direct dispatch is
counted under direct_* labels as in the reference. The device observatory
is a no-op while disabled, install() never raises, and the bytes the port
copies are counted (the plain versions' copies too: the CPU path copies
the same rows). Every test starts from a fresh global registry, devobs
state and trace ring (`fresh`), so no test depends on another's order.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import tendermint_tpu.crypto.ed25519 as jed  # noqa: E402
import tendermint_tpu.metrics as JM  # noqa: E402
from tendermint_tpu import trace as JT  # noqa: E402
from tendermint_tpu.types import validation as jval  # noqa: E402
from tendermint_tpu_torch import devobs  # noqa: E402
from tendermint_tpu_torch import metrics as M  # noqa: E402
from tendermint_tpu_torch import trace as T  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519 as ted  # noqa: E402
from tendermint_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from tendermint_tpu_torch.crypto import sr25519 as sr  # noqa: E402
from tendermint_tpu_torch.ops import _build  # noqa: E402
from tendermint_tpu_torch.ops import msm as Msm  # noqa: E402
from tendermint_tpu_torch.ops import verify as V  # noqa: E402
from tendermint_tpu_torch.types import validation as tval  # noqa: E402
from test_torch_validation import CHAIN_ID, HEIGHT, JAX_PKG, PORT_PKG, build  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def fresh(monkeypatch):
    """A fresh global registry and metric groups in both packages, devobs
    off with zeroed counters, and empty trace rings, tracing off after."""
    for mod in (M, JM):
        monkeypatch.setattr(mod, "_GLOBAL_REGISTRY", mod.Registry())
        monkeypatch.setattr(mod, "_ENGINE_METRICS", None)
        monkeypatch.setattr(mod, "_DEVICE_METRICS", None)
    state = dict(devobs._STATE, transfers={"h2d": 0, "d2h": 0},
                 transfer_bytes={"h2d": 0, "d2h": 0}, installed=False, compiles=0,
                 compile_seconds=0.0, residency_samples=0, live_buffer_bytes=0,
                 high_water_bytes=0, warned=False)
    monkeypatch.setattr(devobs, "_STATE", state)
    monkeypatch.setattr(devobs, "_COMPILE_TAIL", type(devobs._COMPILE_TAIL)(maxlen=256))
    for tr in (T, JT):
        tr.clear()
    yield
    for tr in (T, JT):
        tr.set_enabled(False)
        tr.clear()


# -- metrics ----------------------------------------------------------------------


@pytest.mark.parametrize("group", ["EngineMetrics", "DeviceMetrics"])
def test_gather_equals_reference(group):
    """An empty registry with the group renders the reference's exposition:
    the same series, types, help and (once observed) buckets and labels."""
    port_reg, ref_reg = M.Registry(), JM.Registry()
    port, want = getattr(M, group)(port_reg), getattr(JM, group)(ref_reg)
    assert port_reg.gather() == ref_reg.gather()
    for p_metric, r_metric in ((getattr(port, a), getattr(want, a)) for a in vars(want)
                               if hasattr(getattr(want, a), "label_names")):
        labels = tuple(f"l{i}" for i in range(len(r_metric.label_names)))
        for metric in (p_metric, r_metric):
            if metric.kind == "histogram":
                metric.observe(0.75, *labels)
            elif metric.kind == "gauge":
                metric.set(3.5, *labels)
            else:
                metric.add(2, *labels)
    assert port_reg.gather() == ref_reg.gather()


def test_observe_direct_labels(fresh, monkeypatch):
    """Direct dispatch (TM_TPU_ENGINE=off) is counted under direct_* labels,
    as the reference counts it, on the host path of both planes and the
    bitmap and two-phase paths of the device."""
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    rng = np.random.default_rng(5)
    ed_privs = [ref.gen_privkey(rng.bytes(32)) for _ in range(6)]
    sr_privs = [sr.Sr25519PrivKey(rng.bytes(32)) for _ in range(3)]

    def run(verifier, pub_of, privs, sign, bad, **kw):
        bv = verifier(**kw)
        for i, priv in enumerate(privs):
            msg = b"direct %d" % i
            bv.add(pub_of(priv), msg + (b"!" if i == bad else b""), sign(priv, msg))
        return bv.verify()

    from tendermint_tpu.crypto import sr25519 as jsr

    # the host path valid and with a bad row, the device's bitmap with a bad
    # row and its two-phase path valid (the RLC alone)
    for cutover, msm, bads in ((64, 1 << 30, (None, 1)), (4, 1 << 30, (1,)), (4, 4, (None,))):
        for mod in (jed, ted):
            monkeypatch.setattr(mod, "DEVICE_BATCH_CUTOVER", cutover)
            monkeypatch.setattr(mod, "MSM_BATCH_CUTOVER", msm)
        for bad in bads:
            got = run(ted.Ed25519BatchVerifier, lambda p: ted.Ed25519PubKey(p[32:]),
                      ed_privs, ref.sign, bad, device="cpu")
            want = run(jed.Ed25519BatchVerifier, lambda p: jed.Ed25519PubKey(p[32:]),
                       ed_privs, ref.sign, bad)
            assert got == want
    for bad in (None, 2):
        got = run(sr.Sr25519BatchVerifier, lambda p: p.pub_key(), sr_privs,
                  lambda p, m: p.sign(m), bad, device="cpu")
        want = run(jsr.Sr25519BatchVerifier,
                   lambda p: jsr.Sr25519PubKey(p.pub_key().bytes()), sr_privs,
                   lambda p, m: p.sign(m), bad)
        assert got == want
    port = M.engine_metrics()
    ref_m = JM.engine_metrics()
    for series in ("launches", "path_rows"):
        assert getattr(port, series).samples() == getattr(ref_m, series).samples()
    paths = {s[1]["path"] for s in port.launches.samples()}
    assert paths == {"direct_host", "direct_bitmap", "direct_two_phase_msm"}


# -- spans ----------------------------------------------------------------------------


def _spans(tr):
    """The ring's complete events as sorted (name, cat, args) with every
    nonzero flow id replaced by "flow"; and the flow ids of the engine's
    spans, by name."""
    out, flows = [], {}
    for ev in tr.export()["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        if args.get("flow"):
            flows.setdefault(ev["name"], []).append(args["flow"])
            args["flow"] = "flow"
        out.append((ev["name"], ev["cat"], sorted(args.items())))
    return sorted(out, key=repr), flows


@pytest.mark.parametrize("engine", ["auto", "off"])
@pytest.mark.parametrize("where", ["host", "device"])
def test_spans_equal_reference(fresh, monkeypatch, engine, where):
    """The same verify_commit (8 validators, one commit) with tracing on in
    both packages writes the same spans with the same args: verify.commit_*
    and, through the engine, engine.submit / coalesce / dispatch / collect
    and engine.host_verify on the host plane, verify.direct_host on direct
    dispatch, ops.* on the device; each job's submit, dispatch and collect
    share one flow id."""
    monkeypatch.setenv("TM_TPU_ENGINE", engine)
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    for mod in (jed, ted):
        monkeypatch.setattr(mod, "DEVICE_BATCH_CUTOVER", 4 if where == "device" else 64)
        monkeypatch.setattr(mod, "MSM_BATCH_CUTOVER", 1 << 30)
    rng = np.random.default_rng({"auto": 60, "off": 61}[engine] + 10 * (where == "device"))
    privs = [ref.gen_privkey(rng.bytes(32)) for _ in range(8)]
    spans = {}
    for tr, pkg, val, kw in ((JT, JAX_PKG, jval, {}), (T, PORT_PKG, tval, {"device": "cpu"})):
        vals, bid, commit = build(pkg, privs)
        tr.clear()
        tr.set_enabled(True)
        val.verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit, **kw)
        tr.set_enabled(False)
        spans[tr] = _spans(tr)
    (got, port_flows), (want, ref_flows) = spans[T], spans[JT]
    assert got == want
    names = {s[0] for s in got}
    assert {"verify.commit_dispatch", "verify.commit_collect"} <= names
    if engine == "auto":
        assert {"engine.submit", "engine.coalesce", "engine.dispatch", "engine.collect"} <= names
        for flows in (port_flows, ref_flows):
            ids = {name: flows[name] for name in ("engine.submit", "engine.dispatch", "engine.collect")}
            assert all(len(v) == 1 for v in ids.values()) and len({v[0] for v in ids.values()}) == 1
    if where == "host":
        assert ("engine.host_verify" if engine == "auto" else "verify.direct_host") in names
    else:
        assert {"ops.verify_dispatch", "ops.pk_cache_fill"} <= names


# -- devobs -------------------------------------------------------------------------


def test_devobs_disabled_is_a_noop(fresh):
    assert not devobs.enabled()
    with devobs.attribution(fn="x", rows=8):
        assert devobs.current_attribution() == {}
    with devobs.transfer_span("h2d", 1024):
        pass
    devobs.record_build("verify", 1.0, "nvcc")
    assert devobs.sample_residency() is None
    assert devobs.status() == {"enabled": False, "compiles": 0, "tail": []}
    V.verify_batch(*_rows(3), device="cpu")
    assert "tendermint_device" not in M.global_registry().gather()


def test_devobs_install_never_raises(fresh, monkeypatch):
    """install() is idempotent, and a fault while starting it degrades to a
    warn-once no-op; maybe_install reads TM_TPU_DEVOBS."""

    def broken():
        raise RuntimeError("metrics broke")

    with monkeypatch.context() as m:
        m.setattr(devobs, "_metrics", broken)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert devobs.install() is None
            assert devobs.install() is None
        assert len(caught) == 1 and "device observatory disabled" in str(caught[0].message)
        assert not devobs.enabled()
    monkeypatch.delenv("TM_TPU_DEVOBS", raising=False)
    assert devobs.maybe_install() is None and not devobs.enabled()
    monkeypatch.setenv("TM_TPU_DEVOBS", "1")
    assert devobs.maybe_install() is True and devobs.install() is True and devobs.enabled()
    assert 'tendermint_device_transfer_bytes_total{dir="h2d"} 0' in M.global_registry().gather()
    devobs.uninstall()
    assert not devobs.enabled()


def _rows(n, seed=7):
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for _ in range(n):
        priv = ref.gen_privkey(rng.bytes(32))
        msg = rng.bytes(16)
        pks.append(priv[32:])
        msgs.append(msg)
        sigs.append(ref.sign(priv, msg))
    return pks, msgs, sigs


def test_devobs_counts_the_copies(fresh, monkeypatch):
    """Each launch's h2d copies and each collect's d2h read are counted in
    bytes (padded rows, as copied) with device.h2d / device.d2h spans on the
    launch's flow: the uncached bitmap (4 x 8 x 32 in, 8 out), the RLC (8 x
    (32 + 32 + 32 + 16) + 32 in, 1 out) and a cache fill (8 x 32 in)."""
    assert devobs.install() is True
    T.set_enabled(True)
    rows = _rows(5)
    assert V.verify_batch(*rows, device="cpu").all()
    assert Msm.collect_rlc(Msm.verify_batch_rlc_async(*rows, device="cpu"))
    V.PubkeyCache(capacity=8, device="cpu").ensure(rows[0])
    st = devobs.status()
    assert st["transfers"] == {"h2d": 3, "d2h": 2}
    assert st["transfer_bytes"] == {"h2d": 4 * 8 * 32 + 8 * 112 + 32 + 8 * 32, "d2h": 8 + 1}
    gathered = M.global_registry().gather()
    assert f'tendermint_device_transfer_bytes_total{{dir="h2d"}} {1024 + 928 + 256}' in gathered
    events = [e for e in T.export()["traceEvents"] if e.get("ph") == "X"]
    dispatch = next(e for e in events if e["name"] == "ops.verify_dispatch")
    h2d = [e for e in events if e["name"] == "device.h2d"]
    assert [e["args"]["bytes"] for e in h2d] == [1024, 928, 256]
    assert h2d[0]["args"]["flow"] == dispatch["args"]["flow"] != 0


def test_devobs_build_events_and_residency(fresh, monkeypatch, tmp_path):
    """A kernel library's nvcc run and its load are build events
    (compiles_total{fn}, compile_seconds, device.compile spans, the status
    tail), bucket_compiles_total stays 0; residency reads the pubkey
    caches' bytes and entries from ops/verify.py without building one."""

    class Proc:
        returncode = 0

        def __init__(self, cmd, **_):
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "wb").close()
            return "ptxas info: fake", None

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build, "_LIBS", {})
    assert devobs.install() is True
    T.set_enabled(True)
    _build.load("fail_count")
    _build.load("fail_count")  # loaded once a process
    st = devobs.status()
    assert st["compiles"] == 2
    assert [(e["fn"], e["kind"]) for e in st["tail"]] == [("fail_count", "nvcc"), ("fail_count", "load")]
    gathered = M.global_registry().gather()
    assert 'tendermint_device_compiles_total{fn="fail_count"} 2' in gathered
    assert "tendermint_device_compile_seconds_count 2" in gathered
    assert "tendermint_device_bucket_compiles_total{" not in gathered
    assert [e["args"]["kind"] for e in T.export()["traceEvents"]
            if e.get("name") == "device.compile"] == ["nvcc", "load"]

    monkeypatch.setattr(V, "_PK_CACHES", {})
    monkeypatch.setattr(V, "_DEVICE_TABLES", {})
    assert devobs.sample_residency()["planes"] == {}
    cache = V.plane_cache("ed25519", "cpu")
    cache.ensure(_rows(3)[0])
    sample = devobs.sample_residency()
    nbytes = cache.tables.numel() * 2 + cache.oks.numel()
    assert sample["planes"]["ed25519_pk"] == {"bytes": nbytes, "entries": 3}
    assert sample["live_buffer_bytes"] == 0  # no card: nothing lives on a device
    assert (f'tendermint_device_cache_resident_bytes{{plane="ed25519_pk"}} {nbytes}'
            in M.global_registry().gather())
