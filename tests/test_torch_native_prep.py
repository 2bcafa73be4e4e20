"""The port's native host prep (tendermint_tpu_torch/native/prep.c) against
the JAX package's, byte for byte on the same seeded inputs: prepare_batch's
rows and precheck (the reference's Python and native paths, the port's
Python and native paths) on tests/test_native_prep.py's edge set, on a
2,100-row batch that takes the threaded path and on bad lengths that take
the Python route; tm_mod_l on adversarial digests; the RLC scalars with n
below the padded row count; host_verify_batch and _single_verify (no
`cryptography` on either side) on the ZIP-215 edges of
chip_smoke.edge_batch; TM_TPU_NATIVE=0 routing to Python; and the
failures that must raise: a missing compiler, a compile error, a library
that does not load, a failed allocation, no libcrypto."""

import ctypes
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.native import host_verify_batch as ref_host_verify_batch
from tendermint_tpu.native import load_prep as ref_load_prep
from tendermint_tpu.ops import msm as JM
from tendermint_tpu.ops import verify as JV
from tendermint_tpu_torch import native as N
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V

from test_native_prep import _cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = V.L


@pytest.fixture(scope="module")
def libs():
    """(the reference's library, the port's): both must build here."""
    ref_lib = ref_load_prep()
    assert ref_lib is not None, "the reference's native prep did not build"
    return ref_lib, N.load_prep()


def edge_jobs():
    cases = _cases()
    return [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases]


def threaded_jobs(n=2100, seed=11):
    """n rows past the 2,048-row threshold: random keys and R, s below L
    but on every 13th row, messages of 0-300 bytes with a long one (the
    heap path) every 500th row."""
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        s = int.from_bytes(rng.bytes(32), "little")
        s = s % L if i % 13 else L + s % (2**256 - L)
        pks.append(rng.bytes(32))
        sigs.append(rng.bytes(32) + s.to_bytes(32, "little"))
        msgs.append(rng.bytes(5000 if i % 500 == 7 else int(rng.integers(0, 301))))
    return pks, msgs, sigs


def bad_length_jobs():
    pks, msgs, sigs = [list(x[:12]) for x in edge_jobs()]
    pks[3] = pks[3] + b"\x00"
    sigs[5] = sigs[5][:63]
    sigs[8] = b""
    return pks, msgs, sigs


JOBS = {"edges": edge_jobs, "threaded-2100": threaded_jobs, "bad-lengths": bad_length_jobs}


def _same_rows(got, want):
    for name, g, w in zip(("a", "r", "s", "k", "precheck"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", list(JOBS))
def test_prepare_batch_matches_reference(libs, case):
    ref_lib, lib = libs
    jobs = JOBS[case]()
    want = JV._prepare_batch_py(*jobs)
    _same_rows(JV.prepare_batch(*jobs), want)
    _same_rows(V._prepare_batch_py(*jobs), want)
    _same_rows(V.prepare_batch(*jobs), want)
    if case != "bad-lengths":
        _same_rows(JV._prepare_batch_native(ref_lib, *jobs), want)
        _same_rows(V._prepare_batch_native(lib, *jobs), want)
    pre = want[4]
    assert 0 < pre.sum() < len(pre)


def test_mod_l_adversarial_digests(libs):
    """tm_mod_l over digests that push the Horner remainder into [2^252,
    L), where random digests never go (tests/test_native_prep.py's set)."""
    import random

    lib = libs[1]
    cases = [bytes([pat]) * 64 for pat in range(256)]
    lm1 = (L - 1).to_bytes(32, "little")
    cases += [bytes(32) + lm1, lm1 + bytes(32), lm1 + lm1, b"\xff" * 64]
    for shift in range(0, 260, 4):
        for off in (-2, -1, 0, 1, 2):
            cases.append((((L << shift) + off) % 2**512).to_bytes(64, "little"))
    rng = random.Random(77)
    cases += [rng.randbytes(64) for _ in range(2000)]
    out = ctypes.create_string_buffer(32)
    for d in cases:
        lib.tm_mod_l(d, out)
        assert int.from_bytes(out.raw, "little") == int.from_bytes(d, "little") % L, d.hex()


@pytest.mark.parametrize("n, rows", [(300, 512), (2100, 4096), (1, 8)])
def test_rlc_scalars_match_reference(n, rows):
    """zk, z and zs of the port's native path equal the reference's
    Python and native paths and the port's Python path; rows past n hold
    garbage that every path must ignore; z = 0 and all-ones, s and k at
    L - 1."""
    rng = np.random.default_rng(n)

    def below_l(count):
        return np.stack([np.frombuffer((int.from_bytes(rng.bytes(32), "little") % L).to_bytes(32, "little"),
                                       np.uint8) for _ in range(count)])

    s_rows = np.concatenate([below_l(n), rng.integers(0, 256, (rows - n, 32), dtype=np.uint8)])
    k_rows = np.concatenate([below_l(n), rng.integers(0, 256, (rows - n, 32), dtype=np.uint8)])
    z_raw = bytearray(rng.bytes(16 * n))
    if n > 3:
        z_raw[0:16] = b"\x00" * 16
        z_raw[16:32] = b"\xff" * 16
        s_rows[2] = np.frombuffer((L - 1).to_bytes(32, "little"), np.uint8)
        k_rows[3] = np.frombuffer((L - 1).to_bytes(32, "little"), np.uint8)
    z_raw = bytes(z_raw)
    want = JM._rlc_scalars_py(s_rows, k_rows, n, z_raw)
    for got in (JM._rlc_scalars(s_rows, k_rows, n, z_raw), M._rlc_scalars_py(s_rows, k_rows, n, z_raw),
                M._rlc_scalars(s_rows, k_rows, n, z_raw)):
        for name, g, w in zip(("zk", "z", "zs"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert want[0].shape == (rows, 32) and not want[0][n:].any()


@pytest.fixture(scope="module")
def zip215_jobs():
    """chip_smoke.edge_batch's 64 rows: honest and tampered signatures,
    small-order keys, a non-point key, non-canonical A and R (y >= p,
    x = 0 with the sign bit), a small-order and an undecodable R, and R
    plus a point of order 8."""
    jobs = chip_smoke.edge_batch(np.random.default_rng(215))
    oracle = [ref.verify(*row, zip215=True) for row in zip(*jobs)]
    return jobs, oracle


@pytest.mark.parametrize("rows", [64, 12])
def test_host_verify_batch_matches_reference(libs, zip215_jobs, rows):
    """64 rows take the threaded path, the last 12 (3 honest rows and the
    edges) the serial one (below 16)."""
    jobs, oracle = zip215_jobs
    jobs = [list(x[-rows:]) for x in jobs]
    want = ref_host_verify_batch(*jobs)
    got = N.host_verify_batch(*jobs)
    assert want is not None and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    # True is final: OpenSSL's acceptance is a subset of ZIP-215's
    assert all(o for g, o in zip(got, oracle[-rows:]) if g)
    assert got.any() and not got.all()
    for bad in (([b"\x00" * 31] + jobs[0][1:], jobs[1], jobs[2]), (jobs[0], jobs[1], jobs[2][:-1]), ([], [], [])):
        assert N.host_verify_batch(*bad) is None and ref_host_verify_batch(*bad) is None


def test_single_verify_without_cryptography(monkeypatch, zip215_jobs):
    """With no `cryptography` package on either side, _single_verify asks
    host_verify_batch first and the ZIP-215 oracle after a False: the
    verdicts equal the reference's and the oracle's on every edge row."""
    jobs, oracle = zip215_jobs
    monkeypatch.setattr(ed, "_OsslPubKey", None)
    monkeypatch.setattr(jed, "_OsslPubKey", None)
    calls = []
    host = N.host_verify_batch
    monkeypatch.setattr(N, "host_verify_batch", lambda *a: calls.append(a) or host(*a))
    got = [ed._single_verify(*row) for row in zip(*jobs)]
    assert got == [jed._single_verify(*row) for row in zip(*jobs)] == oracle
    assert len(calls) == len(oracle)
    calls.clear()
    assert ed._single_verify(jobs[0][0] + b"\x00", jobs[1][0], jobs[2][0]) is False  # 33-byte key
    assert not calls


@pytest.mark.parametrize("setting", ["0", "off", "false", "no", None, "1"])
def test_native_setting_routes(monkeypatch, zip215_jobs, setting):
    """TM_TPU_NATIVE=0 (off, false, no) takes every Python path and builds
    nothing; unset or anything else takes the C paths. The calls are
    counted."""
    if setting is None:
        monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_NATIVE", setting)
    python = setting in ("0", "off", "false", "no")
    assert N.native_disabled() is python
    calls = []

    def counted(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a: calls.append(name) or fn(*a))

    for mod, name in ((V, "_prepare_batch_py"), (V, "_prepare_batch_native"), (M, "_rlc_scalars_py"),
                      (N, "load_prep")):
        counted(mod, name)
    jobs, oracle = zip215_jobs
    a, r, s, k, pre = V.prepare_batch(*jobs)
    _same_rows((a, r, s, k, pre), JV._prepare_batch_py(*jobs))
    z_raw = bytes(range(16)) * len(pre)
    zk, z, zs = M._rlc_scalars(s, k, len(pre), z_raw)
    for g, w in zip((zk, z, zs), JM._rlc_scalars_py(s, k, len(pre), z_raw)):
        np.testing.assert_array_equal(g, w)
    bitmap = N.host_verify_batch(*jobs)
    if python:
        assert calls == ["_prepare_batch_py", "_rlc_scalars_py"] and bitmap is None
    else:
        assert calls == ["load_prep", "_prepare_batch_native", "load_prep", "load_prep"]
        np.testing.assert_array_equal(bitmap, ref_host_verify_batch(*jobs))
    monkeypatch.setattr(ed, "_OsslPubKey", None)
    assert [ed._single_verify(*row) for row in zip(*jobs)] == oracle


_MISSING_CC = r"""
import sys
sys.path.insert(0, sys.argv[1])
from tendermint_tpu_torch import native as N
from tendermint_tpu_torch.ops import verify as V
N.BUILD_DIR = N.Path(sys.argv[2])
N.CC = sys.argv[2] + "/no-such-cc"
try:
    V.prepare_batch([b"\x01" * 32], [b"m"], [b"\x02" * 64])
except RuntimeError as e:
    print("raised:", e)
    sys.exit(0 if N._lib is None and not list(N.BUILD_DIR.iterdir()) else 1)
sys.exit(1)
"""


def test_missing_compiler_raises(tmp_path):
    """A fresh process whose compiler does not exist: prepare_batch raises
    (no Python fallback) and nothing is left in the build directory."""
    env = {k: v for k, v in os.environ.items() if k != "TM_TPU_NATIVE"}
    proc = subprocess.run([sys.executable, "-c", _MISSING_CC, ROOT, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised: native prep: cannot run" in proc.stdout and "no-such-cc" in proc.stdout


def test_failed_build_and_load_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    bad_src = tmp_path / "prep.c"
    bad_src.write_text("this is not C;\n")
    monkeypatch.setattr(N, "SRC", bad_src)
    with pytest.raises(RuntimeError, match=r"(?s)failed \(rc [1-9].*error"):
        N.load_prep()
    assert not list((tmp_path / "build").iterdir())  # no partial library left
    monkeypatch.setattr(N, "SRC", N.Path(N.__file__).with_name("prep.c"))
    N.target().write_bytes(b"not a shared library")
    with pytest.raises(RuntimeError, match="cannot load"):
        N.load_prep()
    assert N._lib is None


def test_concurrent_first_builds(monkeypatch, tmp_path):
    """Builders that start together (one per test worker in the tier-1
    run) each write a file of their own and rename it into place."""
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    errors = []

    def build():
        try:
            N.build()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in tmp_path.iterdir()] == [N.target().name]


@pytest.mark.parametrize("n", [1, 2048])
def test_failed_allocation_raises(libs, n):
    """prepare_batch's last row claims a 2^62-byte message: its buffer
    cannot be allocated, and the C call returns -1 on the serial and the
    threaded path (no byte of that message is read). The wrapper turns a
    nonzero status into an error."""
    lib = libs[1]
    offsets = np.arange(n + 1, dtype=np.int64)
    offsets[n] = offsets[n - 1] + 2**62
    sig = b"\x01" * 32 + b"\x02" * 32  # s < L
    rows = np.zeros((4, n, 32), np.uint8)
    pre = np.zeros(n, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.prepare_batch(b"\x03" * 32 * n, sig * n, b"m" * n,
                           offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                           *(x.ctypes.data_as(u8p) for x in rows), pre.ctypes.data_as(ctypes.c_char_p))
    assert rc == -1 and not pre[n - 1] and pre[:n - 1].all()
    fake = SimpleNamespace(prepare_batch=lambda *a: -1)
    with pytest.raises(MemoryError, match="could not be allocated"):
        V._prepare_batch_native(fake, [b"\x03" * 32], [b"m"], [sig])


def test_missing_libcrypto_raises(monkeypatch):
    """tm_host_verify returns 0 without libcrypto: host_verify_batch raises
    unless TM_TPU_NATIVE=0, where it returns None without calling C."""
    monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    monkeypatch.setattr(N, "load_prep", lambda: SimpleNamespace(tm_host_verify=lambda *a: 0))
    job = ([b"\x01" * 32], [b"m"], [b"\x02" * 64])
    with pytest.raises(RuntimeError, match="no libcrypto"):
        N.host_verify_batch(*job)
    monkeypatch.setenv("TM_TPU_NATIVE", "0")
    assert N.host_verify_batch(*job) is None
