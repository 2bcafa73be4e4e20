"""ed25519 keys + the CUDA-backed batch verifier (ref: crypto/ed25519/ed25519.go).

Key and signature formats match the reference node exactly: 32-byte
pubkeys, 64-byte privkeys (seed || pubkey), 64-byte signatures, address =
SHA256(pubkey)[:20]. Single verification uses ZIP-215 semantics
(ed25519.go:24-31); batch verification runs the port's device plane with
identical acceptance.

Routing of a batch of n signatures (direct dispatch):
  - n < DEVICE_BATCH_CUTOVER, or TM_TPU_CRYPTO=off: serial host checks;
  - n >= MSM_BATCH_CUTOVER (with TM_TPU_MSM on): the RLC all-valid check
    first, and the bitmap plane only when it fails; with TM_TPU_MSM_CACHE=on
    (default off) and the pubkey cache on, the RLC reads A from the cache;
  - otherwise the bitmap plane, through the device pubkey cache
    (TM_TPU_PK_CACHE, default on), which falls back to the uncached kernel
    when a batch has more distinct keys than the cache holds.
TM_TPU_CRYPTO=auto (the default) and on both mean the card: with no card
the verifier raises instead of running on the host. TM_TPU_ENGINE=auto (the
default) or unset is this direct dispatch; an explicit TM_TPU_ENGINE=on
raises, since the coalescing engine comes with a later slice of the port.
"""

from __future__ import annotations

import os

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


def _engine_setting() -> None:
    """TM_TPU_ENGINE: auto (the default) or unset runs the direct dispatch
    below, which is what the reference's engine computes, scheduled per
    caller; off asks for direct dispatch by name. An explicit on asks for
    the coalescing engine (tendermint_tpu/ops/engine.py), which this slice
    does not cover, so it raises instead of quietly running direct."""
    if _flag("TM_TPU_ENGINE", "auto", False):
        raise NotImplementedError(
            "TM_TPU_ENGINE=on: the coalescing verify engine (ops/engine.py) comes "
            "with the port's engine slice; unset it or use auto for direct dispatch"
        )


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
        """Launch now, return a completion callable: callers overlap the
        kernels with host work. The host path completes eagerly."""
        from ..ops import msm, verify

        def rlc_async(pks, msgs, sigs, device):
            if _pk_cache_enabled() and _msm_cache_enabled():
                return msm.verify_batch_rlc_cached_async(pks, msgs, sigs, device=device)
            return msm.verify_batch_rlc_async(pks, msgs, sigs, device=device)

        return dispatch_batch(self._pks, self._msgs, self._sigs, self.device, verify, rlc_async,
                              _single_verify)


def dispatch_batch(pks, msgs, sigs, device, bitmap, rlc_async, host_verify):
    """The direct two-phase dispatch of one batch, shared by the ed25519 and
    sr25519 verifiers: `bitmap` is the plane's bitmap module (ops/verify.py
    or ops/verify_sr.py), `rlc_async(pks, msgs, sigs, device=...)` its RLC
    dispatch (None on precheck refusal), `host_verify(pk, msg, sig)` its
    serial check. Returns the completion callable."""
    n = len(sigs)
    if n == 0:
        return lambda: (False, [])
    _engine_setting()
    # the cutovers below deserve the one-shot launch-latency probe (a no-op
    # after the first call, and without a card)
    from ..ops import engine

    engine.maybe_autotune()
    if _use_device() and n >= DEVICE_BATCH_CUTOVER:
        device = bitmap.resolve_device(device)

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

            def complete_msm():
                if handle is not None and msm.collect_rlc(handle):
                    return True, [True] * n
                pending = dispatched if dispatched is not None else bitmap_async()
                bools = [bool(b) for b in bitmap.collect(pending)]
                return all(bools), bools

            return complete_msm

        dispatched = bitmap_async()

        def complete():
            bools = [bool(b) for b in bitmap.collect(dispatched)]
            return all(bools), bools

        return complete
    bools = [host_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    result = (all(bools), bools)
    return lambda: result
