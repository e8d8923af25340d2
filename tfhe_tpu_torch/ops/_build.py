"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds).  All sources compile in
parallel, one nvcc process each, at first use; a library is named by the
hash of its source, the shared header and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Outputs go to ``ops/build/``
(ignored by git); ``-Xptxas -v`` reports (registers, spills) are kept there
beside each library as ``<name>.ptxas.txt``.  Builds hold an ``fcntl`` lock
on that directory, so processes that start together build once.

``host_library`` builds a host C++ source (the circuit scheduler,
``native/circuit_sched.cpp``) the same way with ``g++``, so the port never
loads a library built on another machine.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
# but the *_occupancy queries, which return blocks per SM (or -cudaError),
# and ck_cmux_step64_stages, which returns a plan's key-ring stages.
SIGNATURES = {
    "materialize_w": ("tfhe_materialize_w", [_P, _P] + [_I] * 7 + [_P]),
    "materialize_wt": ("tfhe_materialize_wt", [_P, _P] + [_I] * 7 + [_P],
                       "materialize_w"),
    "rotate_decompose": ("tfhe_rotate_decompose",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I, _I,
                          _P]),
    "mm_recombine_acc": ("tfhe_mm_recombine_acc",
                         [_P, _P, _P, _P] + [_I] * 8 + [_P]),
    "fused_cmux_step": ("tfhe_fused_cmux_step",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _I, _I,
                         _P]),
    "rotate_decompose64_ck": ("tfhe_rotate_decompose64_ck",
                              [_P, _P, _P, _I, _I, _I, _I, _I, _U64, _I, _I,
                               _I, _I, _I, _I, _P]),
    "ck_dot64p": ("tfhe_ck_dot64p", [_P, _P, _P] + [_I] * 9 + [_P]),
    "ck_dot64p_acc": ("tfhe_ck_dot64p_acc", [_P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _I, _I, _I, _I, _I, _I,
                                             _P]),
    "ck_cmux_step32": ("tfhe_ck_cmux_step32",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _I,
                        _I, _I, _P]),
    "ck_cmux_step32_occupancy": ("tfhe_ck_cmux_step32_occupancy",
                                 [_I, _I, _I], "ck_cmux_step32"),
    "fused_cmux_step_v1": ("tfhe_fused_cmux_step_v1",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I,
                            _P]),
    "rotate_decompose64": ("tfhe_rotate_decompose64",
                           [_P, _P, _P, _I, _I, _I, _I, _I, _U64, _I, _I,
                            _I, _I, _P],
                           "rotate_decompose64_ck"),
    "ck_dot64p_sacc": ("tfhe_ck_dot64p_sacc", [_P, _P, _P, _P, _I, _I, _I,
                                               _I, _I, _I, _I, _I, _I, _I,
                                               _P]),
    "ck_cmux_step64": ("tfhe_ck_cmux_step64",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _U64,
                        _I, _I, _I, _P]),
    "ck_cmux_step64_stages": ("tfhe_ck_cmux_step64_stages", [_I, _I],
                              "ck_cmux_step64"),
    "priv_keyswitch": ("tfhe_priv_keyswitch", [_P, _P, _P] + [_I] * 8 + [_P]),
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


def _lib_path(src: Path, defines: tuple = ()) -> Path:
    """The library of source ``src`` built with ``defines``: named by the
    hash of the source, the headers beside it and the flags."""
    h = hashlib.sha256()
    for f in sorted(src.parent.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS + [f"-D{d}" for d in defines]).encode())
    tag = "".join(f"-{d}" for d in defines)
    return BUILD_DIR / f"{src.stem}{tag}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def build_lock():
    """An exclusive ``fcntl`` lock on BUILD_DIR, held around every build:
    processes that start together (the ranks of ``parallel``) build each
    library once, the others waiting for it and then finding it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(targets):
    """Run one nvcc per (source path, defines) whose library is missing,
    all in parallel, under ``build_lock``; raises with nvcc's output if a
    build fails."""
    with build_lock():
        jobs = []
        for src, defines in targets:
            out = _lib_path(src, defines)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *FLAGS, *(f"-D{d}" for d in defines), "-o",
                   str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            out.with_suffix(".ptxas.txt").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {src} (exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _bind(lib: ctypes.CDLL, name: str):
    sym, argtypes, *_ = SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source whose library is missing (in parallel) and load
    them all.  Raises with nvcc's output if a build fails."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        _compile([(CSRC / f"{name}.cu", ()) for name in SOURCES])
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_lib_path(CSRC / f"{name}.cu")))
        for name in SIGNATURES:
            _bind(_libs[_source(name)], name)
        build_seconds = time.perf_counter() - t0
        return _libs


def variants(name: str, defines: list, source: Path | None = None) -> list:
    """Entry point ``name`` built once per tuple of ``defines`` (nvcc -D
    flags, e.g. ("FCS_PART=1",); () for none), in parallel: the stripped
    variants that time a kernel's parts.  ``source`` is another .cu file to
    build instead of the entry's own (an edited copy, or an earlier tree's
    kernel), compiled with the headers beside it.  Returns their ctypes
    functions in order."""
    src = Path(source) if source else CSRC / f"{_source(name)}.cu"
    with _lock:
        _compile([(src, tuple(d)) for d in defines])
    return [_bind(ctypes.CDLL(str(_lib_path(src, tuple(d)))), name)
            for d in defines]


HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def host_library(source: Path) -> ctypes.CDLL:
    """Compile a host C++ source with g++ at first use into BUILD_DIR,
    named by the hash of the source and the flags, and load it.  Raises
    with g++'s output if the build fails."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    out = BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"
    with _lock, build_lock():
        if not out.exists():
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
