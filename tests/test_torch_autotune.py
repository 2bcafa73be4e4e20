"""The port's cutover autotune (tendermint_tpu_torch/ops/engine.py) held to
the reference's (tendermint_tpu/ops/engine.py maybe_autotune and
_autotune_probe). Both probes get the same two timings, injected through a
fake clock that the stubbed host verify and bitmap launch advance, and
must set the same cutovers over a grid of timings; a pinned cutover is
left alone; TM_TPU_AUTOTUNE=off, and no CUDA device, start no probe; a
probe that raises keeps the defaults and, in the port, records the
exception; the direct dispatch reaches the autotune."""

import time

import pytest
import torch

from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.ops import engine as JE
from tendermint_tpu.ops import verify as JV
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import engine as E
from tendermint_tpu_torch.ops import verify as V

torch.set_num_threads(1)

# powers of two among them land exactly on the formula's boundaries
# (8 x 2^-13 = 2^-10, 512 x 2^-13 = 2^-4)
T_HOST = (1e-5, 2**-13, 1.25e-4, 1e-3, 6e-3)
T_LAUNCH = (1e-4, 2**-10, 1e-3, 4.4e-3, 2**-4, 1.0, 30.0)


@pytest.fixture
def probes(monkeypatch):
    """Both packages' probes on a fake clock: each host verify advances it
    by t_host and each 8-signature launch by t_launch, with the cutovers
    and the autotune state restored after the test. Returns set_timings
    and run_reference, the reference's probe, after which the clock starts
    again from 0 for the port's: both probes read the same clock values."""
    clock = [0.0]
    timings = {"host": 0.0, "launch": 0.0}

    def host(*_):
        clock[0] += timings["host"]
        return True

    def launch(*_, **__):
        clock[0] += timings["launch"]

    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    for ed, verify in ((jed, JV), (ted, V)):
        monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 64)
        monkeypatch.setattr(ed, "MSM_BATCH_CUTOVER", 256)
        monkeypatch.setattr(ed, "_single_verify", host)
        monkeypatch.setattr(verify, "verify_batch", launch)
    monkeypatch.setattr(jed, "_accelerator_present", lambda *a, **k: True)
    monkeypatch.setattr(JE, "_AUTOTUNE", {"done": False})
    monkeypatch.setattr(E, "_AUTOTUNE", {"done": False})
    for var in ("TM_TPU_AUTOTUNE", "TM_TPU_BATCH_CUTOVER", "TM_TPU_MSM_CUTOVER"):
        monkeypatch.delenv(var, raising=False)

    def set_timings(t_host, t_launch):
        clock[0] = 0.0
        timings.update(host=t_host, launch=t_launch)
        for ed in (jed, ted):
            ed.DEVICE_BATCH_CUTOVER, ed.MSM_BATCH_CUTOVER = 64, 256
        E._AUTOTUNE.clear()
        E._AUTOTUNE["done"] = False

    def run_reference(dev_pinned, msm_pinned):
        JE._autotune_probe(dev_pinned, msm_pinned)
        clock[0] = 0.0

    return set_timings, run_reference


def _port_autotune():
    """The port's maybe_autotune on a card (patched present), its probe
    thread joined; returns the port's cutovers."""
    E.maybe_autotune()
    E._AUTOTUNE["thread"].join(timeout=60)
    return ted.DEVICE_BATCH_CUTOVER, ted.MSM_BATCH_CUTOVER


@pytest.mark.parametrize("t_launch", T_LAUNCH)
def test_probe_cutovers_match_reference(probes, monkeypatch, t_launch):
    monkeypatch.setattr(E, "_accelerator_present", lambda: True)
    set_timings, run_reference = probes
    for t_host in T_HOST:
        set_timings(t_host, t_launch)
        run_reference(False, False)
        want = jed.DEVICE_BATCH_CUTOVER, jed.MSM_BATCH_CUTOVER
        assert _port_autotune() == want == E.cutovers(t_host, t_launch)
        assert "error" not in E._AUTOTUNE
        assert (E._AUTOTUNE["t_host"], E._AUTOTUNE["t_launch"]) == pytest.approx((t_host, t_launch))
        assert (E._AUTOTUNE["device_batch_cutover"], E._AUTOTUNE["msm_batch_cutover"]) == want


def test_pinned_cutover_left_alone(probes, monkeypatch):
    monkeypatch.setattr(E, "_accelerator_present", lambda: True)
    set_timings, run_reference = probes
    set_timings(1e-4, 4e-3)  # the formula gives 64 and 256: pin other values
    monkeypatch.setenv("TM_TPU_BATCH_CUTOVER", "100")
    for ed in (jed, ted):
        ed.DEVICE_BATCH_CUTOVER = 100
    run_reference(True, False)
    assert _port_autotune() == (jed.DEVICE_BATCH_CUTOVER, jed.MSM_BATCH_CUTOVER) == (100, 256)

    set_timings(1e-5, 1.0)  # both pinned: no probe starts
    monkeypatch.setenv("TM_TPU_MSM_CUTOVER", "300")
    ted.DEVICE_BATCH_CUTOVER, ted.MSM_BATCH_CUTOVER = 100, 300
    E.maybe_autotune()
    assert E._AUTOTUNE == {"done": True}
    assert (ted.DEVICE_BATCH_CUTOVER, ted.MSM_BATCH_CUTOVER) == (100, 300)


@pytest.mark.parametrize("setting", ["off", "0", "false", "no"])
def test_autotune_off_keeps_defaults(probes, monkeypatch, setting):
    monkeypatch.setattr(E, "_accelerator_present", lambda: True)
    probes[0](1e-5, 1.0)
    monkeypatch.setenv("TM_TPU_AUTOTUNE", setting)
    E.maybe_autotune()
    assert E._AUTOTUNE == {"done": True}
    assert (ted.DEVICE_BATCH_CUTOVER, ted.MSM_BATCH_CUTOVER) == (64, 256)


def test_no_card_keeps_defaults(probes):
    assert not torch.cuda.is_available()
    probes[0](1e-5, 1.0)
    E.maybe_autotune()
    E.maybe_autotune()
    assert E._AUTOTUNE == {"done": True}
    assert (ted.DEVICE_BATCH_CUTOVER, ted.MSM_BATCH_CUTOVER) == (64, 256)


def test_raising_probe_keeps_defaults_and_records(probes, monkeypatch):
    monkeypatch.setattr(E, "_accelerator_present", lambda: True)
    set_timings, run_reference = probes
    set_timings(1e-5, 1.0)
    boom = RuntimeError("launch refused")

    def refuse(*_, **__):
        raise boom

    for verify in (JV, V):
        monkeypatch.setattr(verify, "verify_batch", refuse)
    run_reference(False, False)
    assert _port_autotune() == (jed.DEVICE_BATCH_CUTOVER, jed.MSM_BATCH_CUTOVER) == (64, 256)
    assert E._AUTOTUNE["error"] is boom
    assert "device_batch_cutover" not in E._AUTOTUNE


def test_direct_dispatch_runs_the_autotune(monkeypatch):
    """A batch verify reaches maybe_autotune once, before routing by size
    (here below the cutover: the host path, no card needed); with
    TM_TPU_ENGINE unset it does so in the engine's submit, as the
    reference's does."""
    monkeypatch.setattr(E, "_AUTOTUNE", {"done": False})
    monkeypatch.delenv("TM_TPU_ENGINE", raising=False)
    submitted = []
    submit = E.VerifyEngine.submit
    monkeypatch.setattr(E.VerifyEngine, "submit",
                        lambda self, *a, **k: submitted.append(a[0]) or submit(self, *a, **k))
    bv = ted.Ed25519BatchVerifier()
    priv = ref.gen_privkey(bytes(range(32)))
    bv.add(ted.Ed25519PubKey(priv[32:]), b"m", ref.sign(priv, b"m"))
    assert bv.verify() == (True, [True])
    assert E._AUTOTUNE == {"done": True}
    assert submitted == ["ed25519"]
