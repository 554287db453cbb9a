"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file is compiled at first use into one shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/libvqhmm_<hash>.so csrc/*.cu

The sources in the repository are the only inputs; no PyTorch header is
included, so the build takes seconds rather than minutes.  The library
name carries a hash of the sources, so an edited kernel is never served
from a stale build.  Each C entry point returns `cudaGetLastError()`
after its launch, and `check` raises when that is not 0: a launch the
CUDA runtime refused never runs, and no later synchronise reports it.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are c_void_p (ctypes would
# otherwise pass a Python int as a 32-bit int and cut the address)
_SIGNATURES = {
    # x, valid_to, 13 weight arrays, mu, logvar, q,
    # B, C, T, H1, H2, K, D, stream
    "vqhmm_fused_infer": [_P] * 2 + [_P] * 13 + [_P] * 3 + [_I] * 7 + [_P],
    # C, H1, H2, K, D -> dynamic shared memory bytes per block
    "vqhmm_fused_infer_smem_bytes": [_I] * 5,
    # log_pi, log_A, a_stride_b, a_stride_t, log_obs, lengths,
    # bp scratch, states, score, B, T, K, stream
    "vqhmm_viterbi": [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                      _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call (thread-safe)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        digest = hashlib.sha256()
        for s in srcs:
            digest.update(s.name.encode())
            digest.update(s.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libvqhmm_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + proc.stdout + proc.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vqhmm_error_string.argtypes = [_I]
        lib.vqhmm_error_string.restype = ctypes.c_char_p
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = library().vqhmm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
