"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

Builds run at first use, into `tendermint_tpu_torch/_build/` (git-ignored),
named by a hash of the sources so an edited kernel is rebuilt. `build_all`
starts one nvcc per source at once. A failed build raises with nvcc's
output; `check` raises on a nonzero CUDA error code returned by an entry
point, which each entry point reads with cudaGetLastError() right after
its launch. Each nvcc run and each library load is reported to the device
observatory (devobs.record_build, kind "nvcc" or "load").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .. import devobs as _devobs

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of each library, with their argument types.
_CACHE_HIT = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P]  # ... n, capacity, stream
KERNELS = {
    "verify": {"tm_verify": [_P, _P, _P, _P, _P, _P, _P, _I, _P]},
    "pk_tables": {"tm_build_pk_tables": [_P, _P, _P, _I, _I, _P]},
    "verify_cached": {"tm_verify_cached_split": _CACHE_HIT[:-1] + [_I, _P]},
    "msm": {"tm_msm_verify": [_P] * 11 + [_I, _I, _I, _P]},
    "pk_tables_single": {"tm_build_pk_tables_single": [_P, _P, _P, _I, _P]},
    "verify_cached_single": {"tm_verify_cached": _CACHE_HIT},
    "msm_cached": {"tm_msm_verify_cached": [_P] * 13 + [_I, _I, _I, _I, _P]},
    "verify_sr": {"tm_verify_sr": [_P, _P, _P, _P, _P, _P, _P, _I, _P]},
    "sr_tables": {"tm_build_sr_tables": [_P, _P, _P, _I, _I, _P]},
    "verify_sr_cached": {"tm_verify_sr_cached_split": _CACHE_HIT[:-1] + [_I, _P]},
    "msm_sr": {"tm_msm_verify_sr": [_P] * 11 + [_I, _I, _I, _P]},
    "sr_tables_single": {"tm_build_sr_tables_single": [_P, _P, _P, _I, _P]},
    "verify_sr_cached_single": {"tm_verify_sr_cached": _CACHE_HIT},
    "fail_count": {"tm_fail_count": [_P, _I, _I, _P, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=None) -> dict[str, str]:
    """Compile every kernel library that is missing, one nvcc per source,
    all started together. Returns each library's ptxas report (registers,
    spills) for the ones built now. Raises on the first failed build."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (
            subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        # all started together: a build's wall time is when it was reaped
        _devobs.record_build(name, time.perf_counter() - t0, "nvcc")
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_target(name)))
            _devobs.record_build(name, time.perf_counter() - t0, "load")
            for fn, argtypes in KERNELS[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {rc}")


def stream_of(t) -> int:
    """The handle of the current CUDA stream of tensor t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
