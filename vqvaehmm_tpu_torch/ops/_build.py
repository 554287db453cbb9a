"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file is compiled at first use, each by its own nvcc
process and all of them at once, and the objects are linked into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c csrc/<name>.cu -o <name>.o  # each
    nvcc -shared -o build/torch_kernels/libvqhmm_<hash>.so *.o

One process a source makes the build as long as its slowest source
(fused_train.cu) rather than the sum of all: on an H100 machine, 7.5 s
against 15.2 s for a single nvcc over the first four sources.
`build_log` keeps what ptxas printed (registers, shared memory and
spills of each kernel).  The sources in the repository are the only
inputs; no PyTorch header is included, so the build takes seconds
rather than minutes.  The library name carries a hash of the sources and
of the `csrc/*.cuh` headers they share, so an edited kernel or header is
never served from a stale build.  Each C entry point returns
`cudaGetLastError()` after its launch, and `check` raises when that is
not 0: a launch the CUDA runtime refused never runs, and no later
synchronise reports it.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
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
    "vqhmm_viterbi": [_P, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # pool_x, pool_u, si, st, ln, x, u, N, C, U, Tmax, B, T, stream
    "vqhmm_gather": [_P] * 7 + [_I] * 6 + [_P],
    # x, u, u strides (batch, channel, time), lengths, 18 weight arrays,
    # scratch, partials, loss partials, grads, loss,
    # B, C, T, U, H1, H2, K, HP, D, beta, stream
    "vqhmm_fused_train": [_P, _P, _L, _L, _L, _P] + [_P] * 18 + [_P] * 5
    + [_I] * 9 + [ctypes.c_float, _P],
    # x, valid_to, 6 encoder weight arrays, logits, B, C, T, H1, H2, K,
    # stream
    "vqhmm_fused_encode": [_P] * 2 + [_P] * 6 + [_P] + [_I] * 6 + [_P],
    # C, H1, H2, K -> dynamic shared memory bytes per block
    "vqhmm_fused_encode_smem_bytes": [_I] * 4,
    # x, u, u strides (batch, channel, time), valid_to, 6 encoder and 4
    # prior weight arrays, log_obs, log_A, B, C, T, U, H1, H2, K, HP, stream
    "vqhmm_fused_evidence": [_P, _P, _L, _L, _L, _P] + [_P] * 10 + [_P] * 2
    + [_I] * 8 + [_P],
    # x, u, u strides, valid_to, lengths (or null), log_pi, 10 weight
    # arrays, backpointer scratch, states, B, C, T, U, H1, H2, K, HP, stream
    "vqhmm_fused_decode": [_P, _P, _L, _L, _L, _P, _P, _P] + [_P] * 10
    + [_P] * 2 + [_I] * 8 + [_P],
    # C, H1, H2, K, U, HP -> dynamic shared memory bytes per block
    "vqhmm_fused_evidence_smem_bytes": [_I] * 6,
    "vqhmm_fused_decode_smem_bytes": [_I] * 6,
    # z, z strides (batch, channel, time), codebook, z_q, idx, B, T, M, D,
    # stream
    "vqhmm_vq_nearest": [_P, _L, _L, _L, _P, _P, _P] + [_I] * 4 + [_P],
}
# entry points returning a long long: B, C, T, U, H1, H2, K, HP, D, what
_SIZE_SIGNATURES = {"vqhmm_fused_train_sizes": [_I] * 10}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log = ""


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


def headers():
    """The `csrc/*.cuh` headers the sources include; they enter the
    build's digest beside the sources."""
    return sorted(CSRC.glob("*.cuh"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of every entry point of `lib`."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    lib.vqhmm_error_string.argtypes = [_I]
    lib.vqhmm_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call (thread-safe)."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        digest = hashlib.sha256()
        for s in srcs + headers():
            digest.update(s.name.encode())
            digest.update(s.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libvqhmm_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
            objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(srcs, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            for cmd, proc, log in zip(cmds, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed:\n" + " ".join(cmd)
                                       + "\n" + log)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + proc.stdout + proc.stderr)
            for o in objs:
                o.unlink()
            os.replace(tmp, out)
        lib = bind(ctypes.CDLL(str(out)))
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = library().vqhmm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
