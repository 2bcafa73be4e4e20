"""The port's coalescing verify engine (tendermint_tpu_torch/ops/engine.py)
held to the reference's (tendermint_tpu/ops/engine.py) on the CPU.

The same seeded jobs go through both engines, through the port's direct
dispatch (TM_TPU_ENGINE=off) and the oracles; per-caller bools and all_ok
must be equal, exactly. Jobs are queued on a fresh engine before its
workers start (`coalesced`), so both engines see one queue and form the
same group; a group's EngineMetrics deltas (paths, kernel launches) must be
equal too. The port runs its plain versions (device="cpu"); the reference
runs its JAX programs on the CPU. Device groups stay at 8 rows or fewer,
one padded shape, so the reference compiles each program once. The
cutovers are lowered by monkeypatch on both packages. Every result() and
join() waits at most 60 s.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import tendermint_tpu.crypto.ed25519 as jed
from tendermint_tpu.metrics import engine_metrics as jengine_metrics
from tendermint_tpu.ops import engine as JE
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as sr
from tendermint_tpu_torch.metrics import engine_metrics
from tendermint_tpu_torch.ops import engine as E

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
NO_MSM = 1 << 30  # an MSM cutover no batch reaches


# -- jobs -----------------------------------------------------------------------


def ed_jobs(rng, n, bad=()):
    """n ed25519 rows: fresh keys, random messages; rows in `bad` verify
    another message than the one signed."""
    pks, msgs, sigs = [], [], []
    for i in range(n):
        priv = ref.gen_privkey(rng.bytes(32))
        msg = rng.bytes(20)
        pks.append(priv[32:])
        sigs.append(ref.sign(priv, msg))
        msgs.append(msg + b"!" if i in bad else msg)
    return pks, msgs, sigs


def sr_jobs(rng, n, bad=()):
    pks, msgs, sigs = [], [], []
    for i in range(n):
        priv = sr.Sr25519PrivKey(rng.bytes(32))
        msg = rng.bytes(20)
        pks.append(priv.pub_key().bytes())
        sigs.append(priv.sign(msg))
        msgs.append(msg + b"!" if i in bad else msg)
    return pks, msgs, sigs


JOBS = {"ed25519": ed_jobs, "sr25519": sr_jobs}


def oracle(plane, pks, msgs, sigs):
    if plane == "ed25519":
        return [ref.verify(p, m, s, zip215=True) for p, m, s in zip(pks, msgs, sigs)]
    return [sr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def refused(plane, job, i):
    """Row i made to fail the host precheck: s + L for ed25519, the marker
    bit cleared for sr25519."""
    pks, msgs, sigs = (list(x) for x in job)
    sig = sigs[i]
    if plane == "ed25519":
        s = int.from_bytes(sig[32:], "little") + ref.L
        sigs[i] = sig[:32] + s.to_bytes(32, "little")
    else:
        sigs[i] = sig[:63] + bytes([sig[63] & 0x7F])
    return pks, msgs, sigs


# -- running ---------------------------------------------------------------------


def start(mod, plane, jobs, **submit_kw):
    """A fresh engine of module `mod` with the jobs queued before its
    workers start, so its first group is every queued job the cap allows;
    the workers then run. Returns (engine, handles)."""
    eng = mod.VerifyEngine()
    eng._started = True  # hold the workers back until every job is queued
    handles = [eng.submit(plane, *job, **submit_kw) for job in jobs]
    eng._started = False
    eng._ensure_started()
    return eng, handles


def finish(eng, handles):
    """Each job's bools (or the exception it raised), and the batches the
    engine dispatched."""
    out = []
    for h in handles:
        try:
            out.append(h.result(timeout=TIMEOUT))
        except Exception as e:  # noqa: BLE001 - compared by the caller
            out.append(e)
    return out, eng._seq


def coalesced(mod, plane, jobs, **submit_kw):
    return finish(*start(mod, plane, jobs, **submit_kw))


def direct(monkeypatch, plane, job):
    """The port's direct dispatch of one job (TM_TPU_ENGINE=off)."""
    with monkeypatch.context() as m:
        m.setenv("TM_TPU_ENGINE", "off")
        return ted.dispatch_batch(plane, *job, device="cpu")()


def counts(metrics):
    """{(series, labels): value} of the path and kernel-launch counters."""
    out = {}
    for series in (metrics.launches, metrics.kernel_launches, metrics.path_rows):
        for name, labels, value in series.samples():
            out[name, tuple(labels.values())] = value
    return out


def delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def held_to_reference(monkeypatch, plane, jobs):
    """Run jobs through both engines as one group and the port's direct
    dispatch; every caller's bools must equal the oracle's, and all_ok its
    all(). Returns the two engines' metric deltas."""
    want = [oracle(plane, *job) for job in jobs]
    j0, t0 = counts(jengine_metrics()), counts(engine_metrics())
    # both engines at once (separate registries): JAX runs with the
    # interpreter lock released while the port's plain versions hold it
    ref_run = start(JE, plane, jobs)
    got_port, port_batches = coalesced(E, plane, jobs, device="cpu")
    got_ref, ref_batches = finish(*ref_run)
    j1, t1 = counts(jengine_metrics()), counts(engine_metrics())
    assert got_ref == want and got_port == want
    assert ref_batches == port_batches == 1
    for job, bools in zip(jobs, want):
        assert direct(monkeypatch, plane, job) == (all(bools), bools)
    return delta(j1, j0), delta(t1, t0)


@pytest.fixture
def route(monkeypatch):
    """set(device_cutover, msm_cutover) on both packages, TM_TPU_CRYPTO=on."""
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    monkeypatch.delenv("TM_TPU_ENGINE", raising=False)

    def set_route(device_cutover, msm_cutover=NO_MSM):
        for mod in (jed, ted):
            monkeypatch.setattr(mod, "DEVICE_BATCH_CUTOVER", device_cutover)
            monkeypatch.setattr(mod, "MSM_BATCH_CUTOVER", msm_cutover)

    return set_route


# -- group forming ---------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 4, 7])
def test_take_group_matches_reference(monkeypatch, cap):
    """From the same queue both engines form the same groups, in order,
    under the same row cap (the default 8192, and 4 and 7)."""
    if cap is not None:
        for mod in (E, JE):
            monkeypatch.setattr(mod, "MAX_COALESCE_ROWS", cap)
    rng = np.random.default_rng(3 + (cap or 0))
    shape = [(str(rng.choice(["ed25519", "sr25519"])), int(rng.integers(1, 5))) for _ in range(24)]
    groups = {}
    for mod in (E, JE):
        eng = mod.VerifyEngine()
        jobs = [mod._Job(plane, [b"k"] * n, [b"m"] * n, [b"s"] * n) for plane, n in shape]
        eng._pending = list(jobs)
        formed = []
        while eng._pending:
            formed.append([jobs.index(j) for j in eng._take_group()])
        groups[mod] = formed
    assert groups[E] == groups[JE]
    limit = cap or 8192
    assert all(sum(shape[i][1] for i in g) <= limit or len(g) == 1 for g in groups[E])


def test_take_group_never_mixes_devices():
    """Jobs that name different devices never share a group (no card needed:
    only the devices' names)."""
    eng = E.VerifyEngine()
    devs = [torch.device("cuda", 0), torch.device("cpu"), torch.device("cuda", 1), None]
    jobs = []
    for i in range(12):
        job = E._Job("ed25519", [b"k"], [b"m"], [b"s"])
        job.device = devs[i % len(devs)]
        jobs.append(job)
    eng._pending = list(jobs)
    formed = []
    while eng._pending:
        formed.append(eng._take_group())
    assert len(formed) == len(devs)
    for group in formed:
        assert len({j.device for j in group}) == 1 and len(group) == 3


def test_max_rows_is_read_from_the_environment():
    """TM_TPU_ENGINE_MAX_ROWS sets the cap at import, as in the reference."""
    env = {**os.environ, "PYTHONPATH": ROOT, "TM_TPU_ENGINE_MAX_ROWS": "300"}
    probe = "from tendermint_tpu_torch.ops import engine as E; print(E.MAX_COALESCE_ROWS)"
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=ROOT)
    assert out.stdout.split() == ["300"], out.stderr
    assert E.MAX_COALESCE_ROWS == JE.MAX_COALESCE_ROWS == 8192


# -- verdicts ----------------------------------------------------------------------


@pytest.mark.parametrize("plane", ["ed25519", "sr25519"])
@pytest.mark.parametrize("where", ["host", "device"])
def test_demux_mixed_validity(route, monkeypatch, plane, where):
    """Three callers with bad rows in two of them, one group: each gets its
    own slice, equal in both engines, the direct dispatch and the oracle;
    on the device the group takes the cached bitmap (fill, then hit), on
    the host the threaded host plane."""
    route(4 if where == "device" else 64)
    rng = np.random.default_rng(11 if plane == "ed25519" else 12)
    make = JOBS[plane]
    jobs = [make(rng, 3, bad={1}), make(rng, 2), make(rng, 3, bad={0, 2})]
    d_ref, d_port = held_to_reference(monkeypatch, plane, jobs)
    assert d_ref == d_port
    if where == "host":  # the verifiers' seam, through the process-wide engine
        for job in jobs:
            bools = oracle(plane, *job)
            assert E.verify_async_via_engine(plane, *job, device="cpu")() == (all(bools), bools)
    path = "bitmap" if where == "device" else "host"
    assert d_port["tendermint_engine_launches_total", (plane, path)] == 1
    if where == "device":
        assert d_port["tendermint_engine_kernel_launches_total", ("bitmap_cached",)] == 1


@pytest.mark.parametrize("plane", ["ed25519", "sr25519"])
def test_two_phase_and_precheck_refusal(route, monkeypatch, plane):
    """At the MSM cutover the group runs the RLC first: all valid, the RLC
    alone; a bad row, the RLC, then the bitmap; a row that fails the host
    precheck, the RLC refused and the bitmap dispatched at once. Launch
    labels and verdicts equal the reference's."""
    route(4, 4)
    rng = np.random.default_rng(21 if plane == "ed25519" else 22)
    make = JOBS[plane]
    cases = {
        "valid": ([make(rng, 2), make(rng, 3)], {"rlc": 1}),
        "bad row": ([make(rng, 2), make(rng, 3, bad={2})], {"rlc": 1, "bitmap_cached": 1}),
        "refused": ([make(rng, 2), refused(plane, make(rng, 3), 1)], {"bitmap_cached": 1}),
    }
    for name, (jobs, kernels) in cases.items():
        d_ref, d_port = held_to_reference(monkeypatch, plane, jobs)
        assert d_ref == d_port, name
        got = {k[1][0]: v for k, v in d_port.items()
               if k[0] == "tendermint_engine_kernel_launches_total" and k[1][0] != "pk_table_build"}
        assert got == kernels, name
        assert d_port["tendermint_engine_launches_total", (plane, "two_phase_msm")] == 1


@pytest.mark.parametrize("where", ["host", "device"])
def test_zip215_edge_rows(route, monkeypatch, where):
    """ZIP-215's edge rows keep their verdicts through both engines: a
    small-order key with the identity R and s = 0 is accepted (OpenSSL
    rejects it: the oracle decides), s >= L and a non-canonical R
    (y = p + 1) with another row's s is not."""
    route(4 if where == "device" else 64)
    rng = np.random.default_rng(31)
    pks, msgs, sigs = ed_jobs(rng, 2)
    identity = ref.compress(ref.IDENTITY)
    small = ref.small_order_points()
    for pk in (small[1], small[2]):
        pks.append(pk)
        msgs.append(b"edge")
        sigs.append(identity + bytes(32))
    s = int.from_bytes(sigs[0][32:], "little")
    pks.append(pks[0])
    msgs.append(msgs[0])
    sigs.append(sigs[0][:32] + (s + ref.L).to_bytes(32, "little"))
    p_plus_1 = (2**255 - 19 + 1).to_bytes(32, "little")
    pks.append(pks[1])
    msgs.append(msgs[1])
    sigs.append(p_plus_1 + sigs[1][32:])
    jobs = [(pks[:4], msgs[:4], sigs[:4]), (pks[4:], msgs[4:], sigs[4:])]
    want = oracle("ed25519", pks, msgs, sigs)
    assert want[:4] == [True, True, True, True] and want[4] is False
    d_ref, d_port = held_to_reference(monkeypatch, "ed25519", jobs)
    assert d_ref == d_port


@pytest.mark.parametrize("where", ["host", "device"])
def test_concurrent_callers_get_their_own_slices(route, where):
    """Eight callers from eight threads, bad rows in some: however the
    engine groups them, each caller gets exactly its own rows, equal to the
    oracle's; on the host plane the reference engine, driven the same way,
    gives the same."""
    route(4 if where == "device" else 64)
    rng = np.random.default_rng(41)
    jobs = [ed_jobs(rng, 1 + c % 3, bad={0} if c in (2, 5) else ()) for c in range(8)]
    want = [oracle("ed25519", *job) for job in jobs]
    engines = [(E, {"device": "cpu"})] + ([(JE, {})] if where == "host" else [])
    for mod, kw in engines:
        eng = mod.VerifyEngine()
        results = {}
        barrier = threading.Barrier(len(jobs))

        def caller(c, eng=eng, kw=kw, results=results, barrier=barrier):
            barrier.wait(timeout=TIMEOUT)
            results[c] = eng.submit("ed25519", *jobs[c], **kw).result(timeout=TIMEOUT)

        threads = [threading.Thread(target=caller, args=(c,)) for c in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert [results[c] for c in range(len(jobs))] == want, mod.__name__


def test_empty_unknown_and_ragged_jobs():
    """As the reference: an empty job completes at once with no bools, an
    unknown plane and a ragged job raise at submit."""
    for mod, kw in ((E, {"device": "cpu"}), (JE, {})):
        eng = mod.VerifyEngine()
        assert eng.submit("ed25519", [], [], [], **kw).result(timeout=5) == []
        with pytest.raises(ValueError, match="unknown verification plane"):
            eng.submit("secp256k1", [b"x"], [b"m"], [b"s"], **kw)
        pks, msgs, sigs = ed_jobs(np.random.default_rng(51), 3)
        for bad in ((pks[:2], msgs, sigs), (pks, msgs[:2], sigs)):
            with pytest.raises(ValueError, match="ragged batch"):
                eng.submit("ed25519", *bad, **kw)
        assert not eng._started
    assert ted.dispatch_batch("ed25519", [], [], [], device="cpu")() == (False, [])


# -- failures ----------------------------------------------------------------------


def _each_raises(results, exc_type, match):
    """Every caller got its own copy of the group's exception."""
    assert all(isinstance(r, exc_type) and match in str(r) for r in results)
    assert len({id(r) for r in results}) == len(results)


def test_worker_exception_reaches_every_caller(route, monkeypatch):
    """A fault in the dispatch worker (routing raises) reaches every caller
    of the group, and the engine serves the next group."""
    route(64)
    rng = np.random.default_rng(61)
    jobs = [ed_jobs(rng, 2), ed_jobs(rng, 1)]

    def explode():
        raise RuntimeError("dispatch exploded")

    eng = E.VerifyEngine()
    with monkeypatch.context() as m:
        m.setattr(ted, "_use_device", explode)
        eng._started = True
        handles = [eng.submit("ed25519", *job, device="cpu") for job in jobs]
        eng._started = False
        eng._ensure_started()
        results = []
        for h in handles:
            with pytest.raises(RuntimeError) as info:
                h.result(timeout=TIMEOUT)
            results.append(info.value)
    _each_raises(results, RuntimeError, "dispatch exploded")
    assert eng.submit("ed25519", *jobs[0], device="cpu").result(timeout=TIMEOUT) == [True, True]


@pytest.mark.parametrize("fault", ["raises", "short"])
def test_collect_fault_fails_the_group(route, monkeypatch, fault):
    """A host verify that raises, or returns fewer bools than rows, fails
    every caller of its group (a short result never reports unverified rows
    as accepted); the engine serves the next group."""
    route(64)
    rng = np.random.default_rng(71)
    jobs = [ed_jobs(rng, 2), ed_jobs(rng, 2)]

    def bad_host(pks, msgs, sigs):
        if fault == "raises":
            raise ValueError("host plane exploded")
        return [True] * (len(sigs) - 1)

    with monkeypatch.context() as m:
        m.setitem(E._HOST_VERIFY, "ed25519", bad_host)
        results, _ = coalesced(E, "ed25519", jobs, device="cpu")
    if fault == "raises":
        _each_raises(results, ValueError, "host plane exploded")
    else:
        _each_raises(results, RuntimeError, "returned 3 results for 4 rows")
    assert coalesced(E, "ed25519", jobs, device="cpu")[0] == [[True, True], [True, True]]


def test_auto_without_card_raises_to_every_caller(route, monkeypatch):
    """TM_TPU_CRYPTO=auto with no card: a group at or above the cutover
    raises resolve_device's error to each caller, and nothing runs on the
    host; a group below the cutover still runs on the host plane."""
    route(4)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host_calls = []
    for plane, fn in list(E._HOST_VERIFY.items()):
        monkeypatch.setitem(E._HOST_VERIFY, plane,
                            lambda *a, _fn=fn: host_calls.append(len(a[0])) or _fn(*a))
    rng = np.random.default_rng(81)
    jobs = [ed_jobs(rng, 3), ed_jobs(rng, 2)]
    results, _ = coalesced(E, "ed25519", jobs)
    _each_raises(results, RuntimeError, "no CUDA device")
    assert host_calls == []
    assert coalesced(E, "ed25519", [jobs[1]])[0] == [[True, True]]
    assert host_calls == [2]
