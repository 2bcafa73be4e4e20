"""ed25519 keys + the CUDA-backed batch verifier (ref: crypto/ed25519/ed25519.go).

Key and signature formats match the reference node exactly: 32-byte
pubkeys, 64-byte privkeys (seed || pubkey), 64-byte signatures, address =
SHA256(pubkey)[:20]. Single verification uses ZIP-215 semantics
(ed25519.go:24-31); batch verification runs the port's device plane with
identical acceptance.

TM_TPU_ENGINE=auto (the default), unset or on sends each batch to the
coalescing engine (ops/engine.py), which merges concurrent callers' batches
into one launch; off runs the direct dispatch below, per caller. Both route
a batch (the engine: a coalesced group) of n signatures the same way, with
the same device branch (`device_dispatch`):
  - n < DEVICE_BATCH_CUTOVER, or TM_TPU_CRYPTO=off: on the host (direct:
    serial checks; the engine: its threaded host plane);
  - n >= MSM_BATCH_CUTOVER (with TM_TPU_MSM on): the RLC all-valid check
    first, and the bitmap plane only when it fails; with TM_TPU_MSM_CACHE=on
    (default off) and the pubkey cache on, the RLC reads A from the cache;
  - otherwise the bitmap plane, through the device pubkey cache
    (TM_TPU_PK_CACHE, default on), which falls back to the uncached kernel
    when a batch has more distinct keys than the cache holds.
TM_TPU_CRYPTO=auto (the default) and on both mean the card: with no card
the verifier raises instead of running on the host. Verdicts are the same
on both schedules.
"""

from __future__ import annotations

import os

from .. import trace as _trace
from . import BatchVerifier, PrivKey, PubKey, address_hash
from . import ed25519_ref as ref

KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64
SIG_SIZE = 64


class Ed25519PubKey(PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes, got {len(data)}")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return address_hash(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIG_SIZE:
            return False
        return _single_verify(self._bytes, msg, sig)

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def __repr__(self):
        return f"PubKeyEd25519{{{self._bytes.hex().upper()}}}"


class Ed25519PrivKey(PrivKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PRIVKEY_SIZE:
            raise ValueError(f"ed25519 privkey must be {PRIVKEY_SIZE} bytes, got {len(data)}")
        self._bytes = bytes(data)

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "Ed25519PrivKey":
        return cls(ref.gen_privkey(seed))

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        return ref.sign(self._bytes, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._bytes[32:])

    @property
    def type_name(self) -> str:
        return KEY_TYPE


def _flag(name: str, default: str, on: bool) -> bool:
    """An on/off knob: default-on knobs parse the off-list, default-off
    knobs the on-list."""
    val = os.environ.get(name, default).strip().lower()
    if on:
        return val not in ("off", "0", "false", "no")
    return val in ("on", "1", "true", "yes")


def _use_device() -> bool:
    """TM_TPU_CRYPTO: off = serial host verification (an explicit request);
    on, auto or unset = the card (the verifier raises if there is none).
    Routing by batch size (DEVICE_BATCH_CUTOVER) applies either way."""
    mode = os.environ.get("TM_TPU_CRYPTO", "auto").strip().lower()
    if mode in ("off", "0", "false", "no"):
        return False
    if mode not in ("on", "1", "true", "yes", "auto", ""):
        import warnings

        warnings.warn(f"unrecognized TM_TPU_CRYPTO={mode!r}; using auto", stacklevel=2)
    return True


def _pk_cache_enabled() -> bool:
    """TM_TPU_PK_CACHE gate for the device pubkey cache. Default: on."""
    return _flag("TM_TPU_PK_CACHE", "on", True)


# Below this many signatures a device launch costs more than it saves;
# the batch is then verified serially on the host (routing by size, not a
# fallback on failure). The environment pins it; otherwise it is a default
# that ops/engine.maybe_autotune refines on the card.
DEVICE_BATCH_CUTOVER = int(os.environ.get("TM_TPU_BATCH_CUTOVER", "64"))

# At or above this batch size the RLC kernel (ops/msm.py) runs first and
# the bitmap plane only on failure (types/validation.go:245-255 shape).
# Autotuned like DEVICE_BATCH_CUTOVER.
MSM_BATCH_CUTOVER = int(os.environ.get("TM_TPU_MSM_CUTOVER", "256"))


def _msm_enabled() -> bool:
    return _flag("TM_TPU_MSM", "on", True)


def _msm_cache_enabled() -> bool:
    """TM_TPU_MSM_CACHE routes the ed25519 RLC through the pubkey cache.
    Default off, as the reference's; it takes effect only with the pubkey
    cache on."""
    return _flag("TM_TPU_MSM_CACHE", "off", False)


try:  # native (OpenSSL) fast path for single verification
    from cryptography.exceptions import InvalidSignature as _InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey as _OsslPubKey,
    )
except ImportError:  # pragma: no cover
    _OsslPubKey = None


def _single_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single verification. OpenSSL verifies the cofactorless
    equation over a stricter encoding set, so whatever it accepts is
    ZIP-215-valid; its rejections go to the pure-Python ZIP-215 oracle so
    acceptance stays byte-exact (ed25519.go:24-31). Without the
    `cryptography` package, the native library's libcrypto loop gives the
    same OpenSSL check."""
    if _OsslPubKey is not None:
        try:
            _OsslPubKey.from_public_bytes(pub).verify(sig, msg)
            return True
        except (_InvalidSignature, ValueError):
            pass  # may still be ZIP-215-acceptable
    elif len(pub) == 32 and len(sig) == 64:
        from ..native import host_verify_batch

        bitmap = host_verify_batch([pub], [msg], [sig])
        if bitmap is not None and bitmap[0]:
            return True
    return ref.verify(pub, msg, sig, zip215=True)


class Ed25519BatchVerifier(BatchVerifier):
    """Accumulate jobs, verify them in device launches (ref: BatchVerifier
    crypto/ed25519/ed25519.go:198-233); acceptance is byte-identical and
    the per-signature bitmap needs no serial re-verification."""

    def __init__(self, device=None):
        self.device = device
        self._pks: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def __len__(self):
        return len(self._sigs)

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.type_name != KEY_TYPE:
            # ref: ErrNotEd25519Key (crypto/ed25519/ed25519.go:209)
            raise ValueError("pubkey is not ed25519")
        pk = pub_key.bytes()
        if len(pk) != PUBKEY_SIZE:
            raise ValueError("invalid pubkey size")
        if len(sig) != SIG_SIZE:
            raise ValueError("invalid signature size")
        self._pks.append(pk)
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))

    def verify(self) -> tuple[bool, list[bool]]:
        return self.verify_async()()

    def verify_async(self):
        """Dispatch now, return a completion callable yielding (all_ok,
        bools): callers overlap the kernels with host work. Through the
        engine unless TM_TPU_ENGINE=off; the direct host path completes
        eagerly."""
        return dispatch_batch(KEY_TYPE, self._pks, self._msgs, self._sigs, self.device,
                              self.journey)


def _rlc_async(pks, msgs, sigs, device):
    """The ed25519 RLC dispatch: through the pubkey cache with
    TM_TPU_MSM_CACHE=on (and the cache on), else uncached."""
    from ..ops import msm

    if _pk_cache_enabled() and _msm_cache_enabled():
        return msm.verify_batch_rlc_cached_async(pks, msgs, sigs, device=device)
    return msm.verify_batch_rlc_async(pks, msgs, sigs, device=device)


def plane_ops(plane: str):
    """(bitmap module, RLC dispatch, serial host check) of a signature
    plane: ops/verify.py or ops/verify_sr.py, `rlc_async(pks, msgs, sigs,
    device)` (None on precheck refusal), `host_verify(pk, msg, sig)`."""
    if plane == KEY_TYPE:
        from ..ops import verify

        return verify, _rlc_async, _single_verify
    from ..ops import msm, verify_sr
    from . import sr25519

    return verify_sr, msm.verify_batch_rlc_sr_async, sr25519.verify


def device_dispatch(pks, msgs, sigs, device, bitmap, rlc_async):
    """The device branch of one batch on a resolved device, shared by the
    direct dispatch and the engine (ops/engine.py): the RLC all-valid check
    first at MSM_BATCH_CUTOVER and above (a precheck refusal dispatches the
    bitmap at once), else the bitmap plane, through the pubkey cache unless
    TM_TPU_PK_CACHE=off. Launches now; returns (collect, path): collect()
    blocks and gives the (n,) bools, path is "two_phase_msm" or "bitmap"."""
    n = len(sigs)

    def bitmap_async():
        if _pk_cache_enabled():
            return bitmap.verify_batch_cached_async(pks, msgs, sigs, device)
        return bitmap.verify_batch_async(pks, msgs, sigs, device)

    if _msm_enabled() and n >= MSM_BATCH_CUTOVER:
        # Phase 1: the RLC all-valid check; phase 2 localizes with the
        # bitmap plane on failure or precheck refusal.
        from ..ops import msm

        handle = rlc_async(pks, msgs, sigs, device=device)
        # a refusal makes phase 2 certain: dispatch it now
        dispatched = bitmap_async() if handle is None else None

        def collect_two_phase():
            if handle is not None and msm.collect_rlc(handle):
                return [True] * n
            pending = dispatched if dispatched is not None else bitmap_async()
            return [bool(b) for b in bitmap.collect(pending)]

        return collect_two_phase, "two_phase_msm"

    dispatched = bitmap_async()
    return (lambda: [bool(b) for b in bitmap.collect(dispatched)]), "bitmap"


def dispatch_batch(plane: str, pks, msgs, sigs, device=None, journey=None):
    """One batch of either signature plane: to the engine
    (ops/engine.verify_async_via_engine) unless TM_TPU_ENGINE=off, else the
    direct dispatch, which routes it by size and reports the path to
    EngineMetrics as direct_*. Returns the completion callable."""
    n = len(sigs)
    if n == 0:
        return lambda: (False, [])
    from ..ops import engine

    if engine.engine_enabled():
        return engine.verify_async_via_engine(plane, pks, msgs, sigs, journey=journey,
                                              device=device)
    # the cutovers below deserve the one-shot launch-latency probe (a no-op
    # after the first call, and without a card)
    engine.maybe_autotune()
    bitmap, rlc_async, host_verify = plane_ops(plane)
    if _use_device() and n >= DEVICE_BATCH_CUTOVER:
        collect, path = device_dispatch(pks, msgs, sigs, bitmap.resolve_device(device), bitmap,
                                        rlc_async)

        def complete():
            bools = collect()
            _observe_direct(plane, path, n, sum(bools))
            return all(bools), bools

        return complete
    with _trace.span("verify.direct_host", "crypto", plane=plane, rows=n):
        bools = [host_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    _observe_direct(plane, "host", n, sum(bools))
    result = (all(bools), bools)
    return lambda: result


def _observe_direct(plane: str, path: str, n: int, accepted: int) -> None:
    """Fold a direct-dispatch (TM_TPU_ENGINE=off) batch into the engine's
    path counters, labeled direct_* (EngineMetrics.observe_direct)."""
    from ..metrics import engine_metrics

    engine_metrics().observe_direct(plane, path, n, accepted)
