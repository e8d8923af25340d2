"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  All sources compile in
parallel, one nvcc process each, at first use; a library is named by the
hash of its source, the shared header and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Outputs go to ``ops/build/``
(ignored by git); ``-Xptxas -v`` reports (registers, spills) are kept there
beside each library as ``<name>.ptxas.txt``.

``host_library`` builds a host C++ source (the circuit scheduler,
``native/circuit_sched.cpp``) the same way with ``g++``, so the port never
loads a library built on another machine.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v", "-lineinfo"]

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_U64 = ctypes.c_uint64
# Every C entry point: name -> (symbol, argtypes[, source]); the source is
# csrc/<name>.cu unless named.  Each returns the cudaError_t of its launch,
# but the *_occupancy queries, which return blocks per SM (or -cudaError).
SIGNATURES = {
    "materialize_w": ("tfhe_materialize_w", [_P, _P, _I, _I, _I, _I, _P]),
    "rotate_decompose": ("tfhe_rotate_decompose",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _U, _P]),
    "mm_recombine_acc": ("tfhe_mm_recombine_acc",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "mm_recombine_acc_occupancy": ("tfhe_mm_recombine_acc_occupancy", [_I],
                                   "mm_recombine_acc"),
    "fused_cmux_step": ("tfhe_fused_cmux_step",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _I, _I,
                         _P]),
    "rotate_decompose64_ck": ("tfhe_rotate_decompose64_ck",
                              [_P, _P, _P, _I, _I, _I, _I, _I, _U64, _I, _I,
                               _I, _P]),
    "ck_dot64p": ("tfhe_ck_dot64p", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                     _P]),
    "ck_dot64p_acc": ("tfhe_ck_dot64p_acc", [_P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _I, _I, _I, _I, _P]),
    "ck_cmux_step32": ("tfhe_ck_cmux_step32",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _I,
                        _I, _I, _P]),
    "ck_cmux_step32_occupancy": ("tfhe_ck_cmux_step32_occupancy",
                                 [_I, _I, _I], "ck_cmux_step32"),
    "fused_cmux_step_v1": ("tfhe_fused_cmux_step_v1",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _P]),
    "rotate_decompose64": ("tfhe_rotate_decompose64",
                           [_P, _P, _P, _I, _I, _I, _I, _I, _U64, _I, _P],
                           "rotate_decompose64_ck"),
    "ck_dot64p_sacc": ("tfhe_ck_dot64p_sacc", [_P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _I, _I, _I, _P]),
    "ck_cmux_step64": ("tfhe_ck_cmux_step64",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U64,
                        _I, _I, _P]),
}


def _source(name: str) -> str:
    return SIGNATURES[name][2] if len(SIGNATURES[name]) > 2 else name


SOURCES = sorted({_source(name) for name in SIGNATURES})

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source whose library is missing (in parallel) and load
    them all.  Raises with nvcc's output if a build fails."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            out.with_suffix(".ptxas.txt").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        for name, (sym, argtypes, *_) in SIGNATURES.items():
            fn = getattr(_libs[_source(name)], sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        return _libs


HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def host_library(source: Path) -> ctypes.CDLL:
    """Compile a host C++ source with g++ at first use into BUILD_DIR,
    named by the hash of the source and the flags, and load it.  Raises
    with g++'s output if the build fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    out = BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"
    with _lock:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", str(tmp),
                 str(source)], capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on {source.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        return ctypes.CDLL(str(out))


def entry(name: str):
    """The ctypes function of entry point ``name`` (building at first
    use)."""
    return getattr(build_all()[_source(name)], SIGNATURES[name][0])
