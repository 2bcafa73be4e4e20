"""The verification engine's process-wide settings: for now the one-shot
cutover autotune of the reference's engine (tendermint_tpu/ops/engine.py:
66-145, maybe_autotune and _autotune_probe).

DEVICE_BATCH_CUTOVER and MSM_BATCH_CUTOVER (crypto/ed25519.py) are
defaults of 64 and 256 signatures. When a CUDA device is present and the
environment pins neither TM_TPU_BATCH_CUTOVER nor TM_TPU_MSM_CUTOVER, the
first direct dispatch starts a daemon thread that times 16 host verifies
and a warm 8-signature bitmap launch on the card (kernel 1) and sets the
cutovers to the batch size where the launch pays for itself, by the
reference's formula (`cutovers`). The defaults stay in effect until the
probe lands. TM_TPU_AUTOTUNE=off, or no CUDA device, leaves them as they
are, so the CPU tests stay deterministic.

A probe that raises keeps the defaults, as the reference's does; the port
also records the exception. `_AUTOTUNE` holds what the probe did: the
thread (`join` it to wait for the probe), the two timings in seconds, the
cutovers it set and the exception, if any.

The coalescing engine of the reference's module comes with a later slice
of the port.
"""

from __future__ import annotations

import os
import threading
import time

_AUTOTUNE: dict = {"done": False}
_AUTOTUNE_LOCK = threading.Lock()


def _autotune_enabled() -> bool:
    return os.environ.get("TM_TPU_AUTOTUNE", "auto").strip().lower() not in (
        "off", "0", "false", "no",
    )


def _accelerator_present() -> bool:
    """The port's accelerator is a CUDA device."""
    import torch

    return torch.cuda.is_available()


def cutovers(t_host: float, t_launch: float) -> tuple[int, int]:
    """(device cutover, MSM cutover) from the seconds of one host verify and
    of one warm 8-signature launch: the smallest 8 * 2^k signatures, at
    most 4096, whose host time covers the launch; the RLC's at four times
    that, within [64, 8192]."""
    cutover = 8
    while cutover * t_host < t_launch and cutover < 4096:
        cutover *= 2
    return cutover, max(64, min(4 * cutover, 8192))


def maybe_autotune() -> None:
    """Start the one-shot cutover probe (once a process, under a lock)
    when a CUDA device is present, TM_TPU_AUTOTUNE is not off and at least
    one of the two cutovers is not pinned by its environment variable."""
    if _AUTOTUNE["done"]:
        return
    with _AUTOTUNE_LOCK:
        if _AUTOTUNE["done"]:
            return
        _AUTOTUNE["done"] = True
        if not _autotune_enabled():
            return
        dev_pinned = "TM_TPU_BATCH_CUTOVER" in os.environ
        msm_pinned = "TM_TPU_MSM_CUTOVER" in os.environ
        if (dev_pinned and msm_pinned) or not _accelerator_present():
            return
        t = threading.Thread(target=_autotune_probe, args=(dev_pinned, msm_pinned),
                             daemon=True, name="tm-engine-autotune")
        _AUTOTUNE["thread"] = t
        t.start()


def _autotune_probe(dev_pinned: bool, msm_pinned: bool) -> None:
    """Time the host and the card, then set the cutovers not pinned."""
    try:
        from ..crypto import ed25519 as ed
        from ..crypto import ed25519_ref as ref
        from . import verify as V

        sk = ref.gen_privkey(b"\x5a" * 32)
        pk, msg = sk[32:], b"tm-engine-autotune-probe"
        sig = ref.sign(sk, msg)
        t0 = time.perf_counter()
        for _ in range(16):
            ed._single_verify(pk, msg, sig)
        t_host = (time.perf_counter() - t0) / 16
        jobs = ([pk] * 8, [msg] * 8, [sig] * 8)
        V.verify_batch(*jobs)  # build and warm
        t0 = time.perf_counter()
        for _ in range(3):
            V.verify_batch(*jobs)
        t_launch = (time.perf_counter() - t0) / 3
        _AUTOTUNE.update(t_host=t_host, t_launch=t_launch)
        dev_cut, msm_cut = cutovers(t_host, t_launch)
        if not dev_pinned:
            ed.DEVICE_BATCH_CUTOVER = dev_cut
        if not msm_pinned:
            ed.MSM_BATCH_CUTOVER = msm_cut
        _AUTOTUNE.update(device_batch_cutover=ed.DEVICE_BATCH_CUTOVER,
                         msm_batch_cutover=ed.MSM_BATCH_CUTOVER)
    except Exception as e:  # noqa: BLE001 - the defaults stay; the failure is recorded
        _AUTOTUNE["error"] = e
