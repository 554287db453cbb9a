"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `csrc/*.cu` file is compiled at first use, each by its own nvcc
process and all of them at once, and the objects are linked into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c csrc/<name>.cu -o <name>.o  # each
    nvcc -shared -o <BUILD_DIR>/libvqhmm_<hash>.so *.o

One process a source makes the build as long as its slowest source
(fused_train.cu) rather than the sum of all: on an H100 machine, 7.5 s
against 15.2 s for a single nvcc over the first four sources.
`build_log` keeps what ptxas printed (registers, shared memory and
spills of each kernel), also written beside the library and read back
where a process finds the library built.  The sources in the repository are the only
inputs; no PyTorch header is included, so the build takes seconds
rather than minutes.  The library name carries a hash of the sources and
of the `csrc/*.cuh` headers they share, so an edited kernel or header is
never served from a stale build.  Each C entry point returns
`cudaGetLastError()` after its launch, and `check` raises when that is
not 0: a launch the CUDA runtime refused never runs, and no later
synchronise reports it.

`BUILD_DIR` is `build/torch_kernels/` of a source checkout, and the
user's cache directory for an installed package (`build_dir`): the
library's name carries the sources' hash, so versions never collide, and
objects tagged with the pid and an `os.replace` keep builds that start at
once in several processes (the workers of a server) apart.
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

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: every pointer and the stream are c_void_p (ctypes would
# otherwise pass a Python int as a 32-bit int and cut the address)
_SIGNATURES = {
    # x, valid_to, packed weights, 6 biases, mu, logvar, q, B, C, T, H1,
    # H2, K, D, tile, bf16, grid, stream
    "vqhmm_fused_infer": [_P] * 3 + [_P] * 6 + [_P] * 3 + [_I] * 10 + [_P],
    # 7 weight arrays, packed weights, C, H1, H2, K, D, bf16, stream
    "vqhmm_fused_infer_pack": [_P] * 8 + [_I] * 6 + [_P],
    # C, H1, H2, K, D, tile, bf16 -> dynamic shared memory bytes per block
    "vqhmm_fused_infer_smem_bytes": [_I] * 7,
    # log_pi, log_A, a_stride_b, a_stride_t, log_obs, lengths,
    # backpointer words, states, score, B, T, K, lanes, seqs, stream
    "vqhmm_viterbi": [_P, _P, _L, _L, _P, _P, _P, _P, _P] + [_I] * 5 + [_P],
    # T, K, stationary, lanes, seqs -> dynamic shared memory bytes a block
    "vqhmm_viterbi_smem_bytes": [_I] * 5,
    # pool_x, pool_u, si, st, ln, x, u, N, C, U, Tmax, B, T, stream
    "vqhmm_gather": [_P] * 7 + [_I] * 6 + [_P],
    # x, u, u strides (batch, channel, time), lengths, 18 weight arrays,
    # packed weights, scratch, partials, loss partials, grads, loss,
    # B, C, T, U, H1, H2, K, HP, D, tile, splits, bf16, beta, stream
    "vqhmm_fused_train": [_P, _P, _L, _L, _L, _P] + [_P] * 18 + [_P] * 6
    + [_I] * 12 + [ctypes.c_float, _I, _L, _I, _P],
    # 3 encoder and 2 prior weight arrays (or null), packed weights, C, H1,
    # H2, K, U, HP, bf16, stream
    "vqhmm_encoder_pack": [_P] * 6 + [_I] * 7 + [_P],
    # x, valid_to, packed weights, 3 encoder biases, logits, B, C, T, H1,
    # H2, K, tile, bf16, grid, stream
    "vqhmm_fused_encode": [_P] * 3 + [_P] * 3 + [_P] + [_I] * 9 + [_P],
    # C, H1, H2, K, tile, bf16, staged -> dynamic shared memory bytes per
    # block
    "vqhmm_fused_encode_smem_bytes": [_I] * 7,
    # x, u, u strides (batch, channel, time), lengths (or null), packed
    # weights, 3 encoder and 2 prior biases, log_obs, log_A, B, C, T, U,
    # H1, H2, K, HP, tile, split, bf16, staged, inert, stream
    "vqhmm_fused_evidence": [_P, _P, _L, _L, _L, _P, _P] + [_P] * 5
    + [_P] * 2 + [_I] * 13 + [_P],
    # x, u, u strides (batch, channel, time), lengths (or null), packed
    # weights, 3 encoder and 2 prior biases, log_pi, the segment scratch
    # (aggregates, selector maps, end states), states, B, C, T, U, H1, H2,
    # K, HP, tile, bf16, staged, stream
    "vqhmm_fused_decode": [_P, _P, _L, _L, _L, _P, _P] + [_P] * 5
    + [_P] * 5 + [_I] * 11 + [_P],
    # B, C, T, U, H1, H2, K, HP, tile, bf16, staged, out[5] -> error code
    "vqhmm_fused_decode_plan": [_I] * 11 + [_P],
    # C, H1, H2, K, U, HP, tile, bf16, staged -> dynamic shared memory
    # bytes per block
    "vqhmm_fused_evidence_smem_bytes": [_I] * 9,
    # z, z strides (batch, channel, time), codebook, z_q, idx, B, T, M, D,
    # stream
    "vqhmm_vq_nearest": [_P, _L, _L, _L, _P, _P, _P] + [_I] * 4 + [_P],
    # z, z strides, mask (or null), mask mode, mask strides, codebook,
    # beta, z_q_st, idx, partials, commitment, codebook loss, counter, B,
    # T, M, D, stream
    "vqhmm_vq_quantize_forward": [_P, _L, _L, _L, _P, _I, _L, _L, _P,
                                  ctypes.c_float] + [_P] * 6 + [_I] * 4
    + [_P],
    # g, g strides, g_commit, g_cb, z, z strides, mask (or null), mask
    # mode, mask strides, codebook, idx, denom, 2 beta, dz_e, dcodebook,
    # partials, counter, B, T, M, D, stream
    "vqhmm_vq_quantize_backward": [_P, _L, _L, _L, _P, _P, _P, _L, _L, _L,
                                   _P, _I, _L, _L, _P, _P, _P,
                                   ctypes.c_float] + [_P] * 4 + [_I] * 4
    + [_P],
}
# entry points returning a long long: B, C, T, U, H1, H2, K, HP, D, tile,
# what, bf16
_SIZE_SIGNATURES = {"vqhmm_fused_train_sizes": [_I] * 12,
                    # C, H1, H2, K, D, bf16 -> values (floats, or
                    # bfloat16 values where bf16) of the packed weights
                    "vqhmm_fused_infer_packed_floats": [_I] * 6,
                    # C, H1, H2, K, U, HP, bf16 -> the same
                    "vqhmm_encoder_packed_floats": [_I] * 7,
                    # B, T, M, D, what -> the quantizer's blocks and
                    # shared memory
                    "vqhmm_vq_quantize_sizes": [_I] * 5}



def build_dir(package: Path) -> Path:
    """Where the library of the package at `package` is built: in a source
    checkout (the package's parent holds pyproject.toml, and the package
    its csrc/) `build/torch_kernels/` beside it, which .gitignore lists;
    otherwise, as for a package installed into an environment's
    directories, `${XDG_CACHE_HOME:-~/.cache}/vqvaehmm_tpu_torch/`."""
    root = package.parent
    if (root / "pyproject.toml").is_file() and (package / "csrc").is_dir():
        return root / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / PACKAGE.name


BUILD_DIR = build_dir(PACKAGE)
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
            out.with_suffix(".log").write_text(build_log)
            os.replace(tmp, out)
        elif out.with_suffix(".log").exists():
            build_log = out.with_suffix(".log").read_text()
        lib = bind(ctypes.CDLL(str(out)))
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def sass_counts(names, opcode: str = "HMMA") -> dict:
    """{name: instructions of `opcode` in the built library's SASS} for the
    kernels named (plain, unmangled names; a template instance as its
    mangled tail, e.g. "fused_decode_kernelILi3ELb1E"), read with the
    toolkit's cuobjdump --dump-sass: HMMA counts the tensor-core
    instructions.  A kernel the SASS does not hold raises."""
    import re

    lib = library()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "--dump-sass", lib._name],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("cuobjdump --dump-sass failed: " + proc.stderr)

    def mangled(n):
        # a mangled name holds a name's length just before the name, and a
        # template's arguments after it
        base = n.split("IL", 1)[0]
        return f"{len(base)}{n}"

    counts, current = {}, None
    for line in proc.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = next((n for n in names
                            if mangled(n) in found.group(1)), None)
            if current is not None:
                counts[current] = 0
        elif current is not None and re.search(rf"\b{opcode}\b", line):
            counts[current] += 1
    missing = set(names) - set(counts)
    if missing:
        raise RuntimeError(f"the library's SASS has no function for "
                           f"{sorted(missing)}")
    return counts


_sm_counts: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch plans size
    their grids by it), read once a device."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = library().vqhmm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
