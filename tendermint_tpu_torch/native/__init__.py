"""Native host prep: C built at first use with the system compiler.

`prep.c` is a trimmed copy of the JAX package's native/prep.c: the
SHA-512 challenges mod L, the s < L precheck and the row shaping of the
ed25519 bitmap and RLC planes (`prepare_batch`, called from
ops/verify.py), the RLC scalars (`tm_rlc_scalars`, from ops/msm.py and
the sharded RLC), the libcrypto ed25519 host verify (`tm_host_verify`,
through `host_verify_batch`) and the SHA-256 / RFC-6962 merkle plane of
crypto/merkle.py (`sha256_batch`, `merkle_root`, `merkle_proofs`,
`merkle_multiproof`) and the secret connection's ChaCha20-Poly1305 through
libcrypto (`aead_chacha20poly1305`, from crypto/softcrypto.py). Each is one
ctypes call that releases the GIL and
threads across up to 8 cores inside C. The bytes equal the pure-Python
paths' (`tests/test_torch_native_prep.py`, `tests/test_torch_merkle.py`).

The library builds on first use with

    cc -O3 -march=native -shared -fPIC -pthread -o _build/prep-<hash>.so native/prep.c

into `tendermint_tpu_torch/_build/` (git-ignored), named by a hash of the
source and the flags; concurrent builders (processes or threads) each
write a file of their own and rename it into place. A failed build or
load raises with the compiler's output, and a failed allocation inside C
raises MemoryError: nothing falls back quietly.

`TM_TPU_NATIVE=0` (also `off`, `false`, `no`) is the explicit request for
the pure-Python paths: every caller then takes its Python version and
nothing is built. It is read on every call, so tests can flip it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "prep.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CC = "cc"
CFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
# The C entry points the port calls, with their argument and return types.
ENTRY_POINTS = {
    "prepare_batch": (
        [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, _i64p, ctypes.c_int64,
         _u8p, _u8p, _u8p, _u8p, ctypes.c_char_p],  # pks, sigs, msgs, offsets, n, a, r, s, k, precheck
        ctypes.c_int,
    ),
    "tm_rlc_scalars": (
        [ctypes.c_char_p, _u8p, _u8p, ctypes.c_int64, _u8p, _u8p],  # z_raw, s, k, n, zk, zs
        None,
    ),
    "tm_host_verify": (
        [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, _i64p, ctypes.c_int64, _u8p],
        ctypes.c_int,  # pks, sigs, msgs, offsets, n, out; 0: no libcrypto
    ),
    "tm_mod_l": ([ctypes.c_char_p, ctypes.c_char_p], None),  # digest (64), out (32)
    # the merkle plane: 0, or -1 when a buffer could not be allocated
    "tm_sha256_batch": ([ctypes.c_char_p, _i64p, ctypes.c_int64, _u8p], ctypes.c_int),
    "tm_merkle_root": ([ctypes.c_char_p, _i64p, ctypes.c_int64, _u8p], ctypes.c_int),
    "tm_merkle_proofs": (
        [ctypes.c_char_p, _i64p, ctypes.c_int64, ctypes.c_int64,
         _u8p, _u8p, _u8p, ctypes.POINTER(ctypes.c_int32)],  # items, offsets, n, stride,
        ctypes.c_int,                                        # root, leaves, aunts, counts
    ),
    "tm_merkle_multiproof": (
        [ctypes.c_char_p, _i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
         _u8p, _u8p, _u8p, _i64p],  # items, offsets, n, indices, k, root, leaves, nodes, n_nodes
        ctypes.c_int,
    ),
    # enc, key, nonce, aad, aad_len, in, in_len, out; the output's length,
    # -1 on a failed authentication, -2 without libcrypto
    "tm_aead_chacha20poly1305": (
        [ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
         ctypes.c_char_p, ctypes.c_int64, _u8p],
        ctypes.c_int64,
    ),
}

_lock = threading.Lock()
_lib = None


def native_disabled() -> bool:
    """TM_TPU_NATIVE=0 (or off/false/no): the explicit request for the
    pure-Python paths."""
    return os.environ.get("TM_TPU_NATIVE", "").strip().lower() in ("0", "off", "false", "no")


def target() -> Path:
    """The library's path: the source's and the flags' hash in its name."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CC] + CFLAGS).encode())
    return BUILD_DIR / f"prep-{h.hexdigest()[:16]}.so"


def command(out) -> list[str]:
    return [CC, *CFLAGS, "-o", str(out), str(SRC)]


def build() -> list[str] | None:
    """Compile the library unless it is there. Returns the command it ran,
    or None when the library was already built; raises with the
    compiler's output when the build fails."""
    out = target()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native prep: cannot run {CC!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native prep: {' '.join(cmd)} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return cmd


def load_prep() -> ctypes.CDLL:
    """The loaded prep library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            try:
                lib = ctypes.CDLL(str(target()))
                for fn, (argtypes, restype) in ENTRY_POINTS.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"native prep: cannot load {target()}: {e}") from e
            _lib = lib
    return _lib


def offsets_of(items) -> np.ndarray:
    """(n + 1,) int64 offsets of the items in b"".join(items)."""
    n = len(items)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, items), np.int64, count=n), out=offsets[1:])
    return offsets


def host_verify_batch(pubkeys, msgs, sigs):
    """Batched ed25519 host verification through libcrypto's EVP verify,
    in one C call (prep.c tm_host_verify).

    Returns an (n,) bool array where True is final (OpenSSL's acceptance
    is a subset of ZIP-215's) and False means "check with the ZIP-215
    oracle"; or None, sending the caller to its per-signature Python
    chain, for non-standard lengths (the C ABI packs 32-byte keys and
    64-byte signatures) and under TM_TPU_NATIVE=0. Raises when the C
    side finds no libcrypto."""
    n = len(sigs)
    if (
        n == 0
        or len(pubkeys) != n
        or len(msgs) != n
        or any(len(pk) != 32 for pk in pubkeys)
        or any(len(sg) != 64 for sg in sigs)
        or native_disabled()
    ):
        return None
    lib = load_prep()
    offsets = offsets_of(msgs)
    out = np.zeros(n, np.uint8)
    rc = lib.tm_host_verify(
        b"".join(pubkeys), b"".join(sigs), b"".join(msgs),
        offsets.ctypes.data_as(_i64p), n, out.ctypes.data_as(_u8p),
    )
    if not rc:
        raise RuntimeError("native prep: tm_host_verify found no libcrypto "
                           "(libcrypto.so.3, .so.1.1 or .so); set TM_TPU_NATIVE=0 for the Python path")
    return out.astype(bool)


def _merkle_call(fn: str, items, *args) -> None:
    """Call a merkle-plane entry point on the items (concatenated, with
    their offsets) and the outputs in args; raises MemoryError when C
    could not allocate a buffer."""
    offsets = offsets_of(items)
    rc = getattr(load_prep(), fn)(b"".join(items), offsets.ctypes.data_as(_i64p), len(items), *args)
    if rc != 0:
        raise MemoryError(f"native {fn} failed (status {rc}): a buffer could not be allocated")


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _rows(buf: bytes, k: int, start: int = 0) -> list[bytes]:
    """The k 32-byte rows of buf from byte `start` on."""
    return [buf[start + 32 * i: start + 32 * i + 32] for i in range(k)]


def sha256_batch(items) -> list[bytes] | None:
    """SHA-256 of each item in one native call (threaded inside C for
    large totals); None under TM_TPU_NATIVE=0."""
    if native_disabled():
        return None
    n = len(items)
    if n == 0:
        return []
    out = np.empty(n * 32, np.uint8)
    _merkle_call("tm_sha256_batch", items, _u8(out))
    return _rows(out.tobytes(), n)


def merkle_root(items) -> bytes | None:
    """RFC-6962 merkle root in one native call; None under TM_TPU_NATIVE=0."""
    if native_disabled():
        return None
    out = np.empty(32, np.uint8)
    _merkle_call("tm_merkle_root", items, _u8(out))
    return out.tobytes()


def merkle_proofs(items) -> tuple[bytes, list[bytes], list[list[bytes]]] | None:
    """(root, per-item leaf hashes, per-item aunt lists) in one native
    call; None under TM_TPU_NATIVE=0. Needs at least one item."""
    if native_disabled():
        return None
    n = len(items)
    if n == 0:
        raise ValueError("merkle_proofs needs at least one item")
    stride = max(1, (n - 1).bit_length())  # ceil(log2(n)) = the most aunts an item has
    root = np.empty(32, np.uint8)
    leaves = np.empty(n * 32, np.uint8)
    aunts = np.empty(n * stride * 32, np.uint8)
    counts = np.zeros(n, np.int32)
    _merkle_call("tm_merkle_proofs", items, stride, _u8(root), _u8(leaves), _u8(aunts),
                 counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    aunt_buf = aunts.tobytes()
    aunt_lists = [_rows(aunt_buf, int(counts[i]), i * stride * 32) for i in range(n)]
    return root.tobytes(), _rows(leaves.tobytes(), n), aunt_lists


def merkle_multiproof(items, indices) -> tuple[bytes, list[bytes], list[bytes]] | None:
    """(root, proven leaf hashes, deduplicated shared-node list) for k
    sorted distinct indices against one tree, in one native call; None
    under TM_TPU_NATIVE=0. At least one item and one index; the indices
    strictly ascending in [0, n), as C indexes the tree with them."""
    if native_disabled():
        return None
    n, k = len(items), len(indices)
    if n == 0 or k == 0:
        raise ValueError("merkle_multiproof needs at least one item and one index")
    idx = np.asarray(indices, np.int64)
    if idx[0] < 0 or idx[-1] >= n or np.any(np.diff(idx) <= 0):
        raise ValueError(f"merkle_multiproof indices must ascend strictly within [0, {n})")
    max_nodes = k * max(1, (n - 1).bit_length())  # at most one emission an ancestor a level
    root = np.empty(32, np.uint8)
    leaves = np.empty(k * 32, np.uint8)
    nodes = np.empty(max_nodes * 32, np.uint8)
    n_nodes = np.zeros(1, np.int64)
    _merkle_call("tm_merkle_multiproof", items, idx.ctypes.data_as(_i64p), k, _u8(root),
                 _u8(leaves), _u8(nodes), n_nodes.ctypes.data_as(_i64p))
    return root.tobytes(), _rows(leaves.tobytes(), k), _rows(nodes.tobytes(), int(n_nodes[0]))


class AeadAuthError(ValueError):
    """A ChaCha20-Poly1305 open whose tag did not authenticate: a verdict on
    the frame (crypto/softcrypto.py raises it as InvalidTag)."""


def aead_chacha20poly1305(enc: bool, key: bytes, nonce: bytes, aad: bytes, data: bytes) -> bytes:
    """ChaCha20-Poly1305 seal (enc) or open through libcrypto's EVP cipher,
    in one call that releases the GIL. Raises AeadAuthError when an open
    fails to authenticate, and RuntimeError when libcrypto is missing or
    refuses the cipher: nothing falls back to Python (TM_TPU_NATIVE=0 is
    the request for softcrypto's Python cipher, made by its caller)."""
    lib = load_prep()
    out = ctypes.create_string_buffer(len(data) + 16)  # a seal grows by the tag, an open shrinks
    rc = lib.tm_aead_chacha20poly1305(1 if enc else 0, key, nonce, aad, len(aad), data, len(data),
                                      ctypes.cast(out, _u8p))
    if rc == -1 and not enc:
        raise AeadAuthError("chacha20poly1305 open failed: bad tag or malformed input")
    if rc < 0:
        raise RuntimeError("native prep: tm_aead_chacha20poly1305 found no usable libcrypto "
                           "(libcrypto.so.3, .so.1.1 or .so); set TM_TPU_NATIVE=0 for the Python path")
    return out.raw[: int(rc)]
