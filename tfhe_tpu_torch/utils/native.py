"""ctypes bindings for the native C++ oracle library
(``native/tfhe_native.cpp``), the counterpart of ``tfhe_tpu.utils.native``.

The source (standard headers only) is compiled with g++ at first use into
the port's ignored build directory (``ops._build.host_library``), as the
circuit scheduler is.  A failed build raises with g++'s output; there is no
"oracle unavailable" state.  The library is an independent host oracle:
exact negacyclic products, the anticyclic f64 FFT and its torus iFFT, the
Lagrange-domain multiply-add and the gadget decompositions.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from tfhe_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tfhe_native.cpp"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once) and load the oracle library, with its signatures bound."""
    lib = _build.host_library(SOURCE)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.negacyclic_mul32.argtypes = [i32p, i32p, i32p, ctypes.c_int]
    lib.negacyclic_mul64.argtypes = [i64p, i32p, i64p, ctypes.c_int]
    lib.anticyclic_fft_i32.argtypes = [f64p, f64p, i32p, ctypes.c_int]
    lib.anticyclic_fft_i64.argtypes = [f64p, f64p, i64p, ctypes.c_int]
    lib.anticyclic_ifft_t64.argtypes = [i64p, f64p, f64p, ctypes.c_int]
    lib.anticyclic_ifft_t32.argtypes = [i32p, f64p, f64p, ctypes.c_int]
    lib.lagrange_addmul.argtypes = [f64p] * 6 + [ctypes.c_int]
    lib.decompose64.argtypes = [i32p, i64p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint64]
    lib.decompose32.argtypes = [i32p, i32p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint32]
    for name in ("negacyclic_mul32", "negacyclic_mul64", "anticyclic_fft_i32",
                 "anticyclic_fft_i64", "anticyclic_ifft_t64",
                 "anticyclic_ifft_t32", "lagrange_addmul", "decompose64",
                 "decompose32"):
        getattr(lib, name).restype = None
    return lib


def negacyclic_mul32(a, b):
    """a (*) b mod X^n+1 on the 32-bit torus, a small ints, b int32."""
    lib = load()
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    out = np.zeros_like(b)
    lib.negacyclic_mul32(out, a, b, len(a))
    return out


def negacyclic_mul64(a, b):
    """a (*) b mod X^n+1 on the 64-bit torus, a small ints, b int64."""
    lib = load()
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int64)
    out = np.zeros_like(b)
    lib.negacyclic_mul64(out, a, b, len(a))
    return out


def anticyclic_fft(a):
    """(n,) int32 or int64 -> (re, im), the n/2 evaluations at the odd
    roots of unity."""
    lib = load()
    a = np.ascontiguousarray(a)
    n = len(a)
    re = np.zeros(n // 2)
    im = np.zeros(n // 2)
    if a.dtype == np.int64:
        lib.anticyclic_fft_i64(re, im, a, n)
    else:
        lib.anticyclic_fft_i32(re, im, np.ascontiguousarray(a, np.int32), n)
    return re, im


def anticyclic_ifft_t64(re, im):
    """n/2 evaluations -> (n,) int64 torus coefficients, wrapped mod 2^64."""
    lib = load()
    n = 2 * len(re)
    out = np.zeros(n, np.int64)
    lib.anticyclic_ifft_t64(out, np.ascontiguousarray(re),
                            np.ascontiguousarray(im), n)
    return out


def decompose64(x, l, bgbit, offset):
    """(n,) int64 torus -> (l, n) int32 balanced gadget digits."""
    lib = load()
    x = np.ascontiguousarray(x, np.int64)
    out = np.zeros((l, len(x)), np.int32)
    lib.decompose64(out.reshape(-1), x, len(x), l, bgbit,
                    ctypes.c_uint64(offset))
    return out
