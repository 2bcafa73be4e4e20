"""The port stands alone and runs on the card unless told otherwise:
importing every module of tendermint_tpu_torch (the sr25519 plane's, the
engine's, the telemetry's, the secp256k1 key type's, the merkle plane's, the
light client's with its stores and providers, and evidence's included) loads no JAX and nothing of tendermint_tpu, the
native host prep and merkle plane load the port's own library (never the
reference's prep.so), a default-device verifier raises without CUDA instead
of running on the host, and TM_TPU_ENGINE selects the engine or direct
dispatch as the reference's does."""

import os
import subprocess
import sys

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as B
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as sr
from tendermint_tpu_torch.metrics import engine_metrics
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import engine as E
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import tendermint_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in ("crypto.merlin", "crypto.merlin_batch", "crypto.sr25519", "native", "ops.engine",
             "ops.ristretto", "ops.verify_sr", "parallel.sharded_verify", "parallel.multihost",
             "trace", "metrics", "devobs", "crypto.secp256k1", "crypto.encoding", "crypto.softcrypto",
             "crypto.merkle", "types.light_block", "light", "light.verifier", "types.vote",
             "types.evidence", "evidence", "evidence.verify", "store", "store.kv", "light.client",
             "light.store", "light.provider"):
    assert pkg.__name__ + "." + name in names, name
for name in names:
    importlib.import_module(name)
from tendermint_tpu_torch import devobs, evidence, light, metrics, native, store, trace
from tendermint_tpu_torch.crypto import encoding, merkle, secp256k1
from tendermint_tpu_torch.ops import engine, msm, verify, verify_sr
for mod, fns in ((verify, ("build_pk_tables", "verify_kernel_cached")),
                 (verify_sr, ("build_sr_tables", "verify_sr_kernel_cached")),
                 (msm, ("msm_verify_kernel_cached", "verify_batch_rlc_cached_async")),
                 (engine, ("get_engine", "verify_async_via_engine", "engine_enabled")),
                 (trace, ("span", "export", "journey_key")),
                 (metrics, ("engine_metrics", "device_metrics", "global_registry")),
                 (devobs, ("install", "transfer_span", "sample_residency", "record_build")),
                 (metrics, ("hash_metrics", "proof_metrics")),
                 (native, ("sha256_batch", "merkle_root", "merkle_proofs", "merkle_multiproof")),
                 (merkle, ("hash_from_byte_slices", "proofs_from_byte_slices",
                           "multiproof_from_byte_slices", "sha256_batch")),
                 (secp256k1, ("route",)), (encoding, ("pubkey_to_proto", "pubkey_from_proto")),
                 (light, ("verify", "verify_adjacent", "verify_non_adjacent", "header_expired",
                          "LightClient", "TrustOptions", "MemLightStore", "DBLightStore", "LocalProvider")),
                 (evidence, ("verify_evidence", "verify_duplicate_vote", "verify_light_client_attack")),
                 (store, ("MemDB", "FileDB")), (metrics, ("evidence_metrics",))):
    for fn in fns:
        assert callable(getattr(mod, fn)), fn
native.load_prep()
assert merkle.hash_from_byte_slices([b"x"] * 16) == native.merkle_root([b"x"] * 16)
with open("/proc/self/maps") as f:
    maps = f.read()
assert str(native.target()) in maps and "tendermint_tpu/native/" not in maps, "prep library"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tendermint_tpu" or m.startswith("tendermint_tpu."))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_import_loads_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def _jobs(n):
    bv = ed.Ed25519BatchVerifier()
    for i in range(n):
        priv = ref.gen_privkey(bytes([i + 1]) * 32)
        bv.add(ed.Ed25519PubKey(priv[32:]), b"m", ref.sign(priv, b"m"))
    return bv


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _jobs(3).verify()
    # routing by size is not a fallback: below the cutover the host verifies
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 64)
    assert _jobs(3).verify() == (True, [True, True, True])
    # an explicit request for the host path stays one
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    monkeypatch.setenv("TM_TPU_CRYPTO", "off")
    assert _jobs(3).verify() == (True, [True, True, True])


def test_uncovered_settings_raise(monkeypatch):
    """TM_TPU_MSM_CACHE=on verifies (here through the plain versions): the
    RLC reads the pubkey cache, and with TM_TPU_PK_CACHE=off it takes the
    uncached RLC, as the reference's routing does."""
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    monkeypatch.setattr(ed, "DEVICE_BATCH_CUTOVER", 2)
    monkeypatch.setattr(ed, "MSM_BATCH_CUTOVER", 2)
    monkeypatch.setenv("TM_TPU_MSM_CACHE", "on")
    monkeypatch.setattr(V, "_PK_CACHES", {})
    calls = []
    for name in ("verify_batch_rlc_cached_async", "verify_batch_rlc_async"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name)
                            or _fn(*a, **k))
    for pk_cache, want in (("on", "verify_batch_rlc_cached_async"), ("off", "verify_batch_rlc_async")):
        monkeypatch.setenv("TM_TPU_PK_CACHE", pk_cache)
        calls.clear()
        bv = _jobs(2)
        bv.device = "cpu"
        assert bv.verify() == (True, [True, True])
        assert calls == [want]
        assert len(V.pubkey_cache("cpu")._lru) == 2  # filled by the cached RLC, kept

    sr_key = sr.Sr25519PubKey(b"\x01" * 32)
    assert B.supports_batch_verifier(sr_key)
    bv = B.create_batch_verifier(sr_key, device="cpu")
    assert isinstance(bv, sr.Sr25519BatchVerifier) and bv.device == "cpu"
    with pytest.raises(ValueError, match="pubkey is not ed25519"):
        B.create_batch_verifier(ed.Ed25519PubKey(b"\x01" * 32)).add(sr_key, b"", b"\x00" * 64)


def _counted(series, *labels):
    """A metric child's value in the port's global registry (0 if unset)."""
    return {tuple(s[1].values()): s[2] for s in series.samples()}.get(labels, 0)


@pytest.mark.parametrize("setting", ["on", "auto", "off", None])
def test_engine_setting(monkeypatch, setting):
    """TM_TPU_ENGINE, as the reference reads it: on, auto or unset submits
    each batch of both verifiers to the coalescing engine (get_engine()
    counts the job), off runs direct dispatch (counted as direct_host);
    the verdicts are the same."""
    if setting is None:
        monkeypatch.delenv("TM_TPU_ENGINE", raising=False)
    else:
        monkeypatch.setenv("TM_TPU_ENGINE", setting)
    monkeypatch.setenv("TM_TPU_CRYPTO", "off")
    msg = b"engine"
    priv = sr.Sr25519PrivKey(b"\x02" * 32)
    sr_bv = sr.Sr25519BatchVerifier(device="cpu")
    sr_bv.add(priv.pub_key(), msg, priv.sign(msg))
    m = engine_metrics()
    for plane, bv in (("ed25519", _jobs(2)), ("sr25519", sr_bv)):
        before = (_counted(m.submitted_jobs, plane), _counted(m.launches, plane, "direct_host"))
        assert bv.verify() == (True, [True] * len(bv))
        after = (_counted(m.submitted_jobs, plane), _counted(m.launches, plane, "direct_host"))
        if setting == "off":
            assert after == (before[0], before[1] + 1)
        else:
            assert after == (before[0] + 1, before[1])
    assert E.engine_enabled() == (setting != "off")


def test_kernel_build_needs_nvcc(monkeypatch):
    """No quiet fallback when the toolkit is missing: the build raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert set(_build.KERNELS) == {"verify", "pk_tables", "verify_cached", "msm", "verify_sr",
                                   "sr_tables", "verify_sr_cached", "msm_sr", "pk_tables_single",
                                   "verify_cached_single", "msm_cached", "sr_tables_single",
                                   "verify_sr_cached_single", "fail_count"}
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
