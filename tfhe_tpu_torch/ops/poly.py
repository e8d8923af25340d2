"""Negacyclic polynomial operations over Z[X]/(X^N+1), batched.

All functions act on the LAST axis (length N) and broadcast over leading
axes, as in ``tfhe_tpu.ops.poly``.  A data-dependent rotation is one gather
with a sign mask here (the TPU version chains log2(2N) bit-gated rolls
because it avoids gathers); both compute X^a * x exactly.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import torus as T


def negacyclic_shift(x, r: int):
    """X^r * x for a STATIC exponent r in [0, 2N)
    (torusPolynomialMulByXai, numeric_functions.cpp:327-347)."""
    N = x.shape[-1]
    r = r % (2 * N)
    sign = 1
    if r >= N:
        r -= N
        sign = -1
    if r == 0:
        return -x if sign < 0 else x
    out = torch.cat([-x[..., N - r:], x[..., :N - r]], dim=-1)
    return -out if sign < 0 else out


def mul_by_xai(power, x, two_n: int | None = None):
    """X^power * x with a PER-BATCH exponent ``power`` (int tensor aligned
    with x's LEADING axes), power taken mod 2N."""
    N = x.shape[-1]
    two_n = two_n or 2 * N
    power = torch.as_tensor(power, device=x.device).to(torch.int64)
    p = (power & (two_n - 1)).reshape(power.shape
                                      + (1,) * (x.ndim - power.ndim))
    i = torch.arange(N, device=x.device)
    src = i - p                                  # in (-2N, N)
    idx = torch.remainder(src, N).expand(x.shape)
    # X^N = -1: one wrap negates, two wraps (src < -N) restore the sign
    neg = ((src < 0) & (src >= -N)).expand(x.shape)
    out = torch.gather(x, -1, idx)
    return torch.where(neg, -out, out)


def mul_by_xai_minus_one(power, x, two_n: int | None = None):
    """(X^power - 1) * x, per-batch exponent (torusPolynomialMulByXaiMinusOne,
    numeric_functions.cpp:304-323)."""
    return mul_by_xai(power, x, two_n) - x


def negacyclic_matrix(poly):
    """Dense negacyclic multiplication matrix M with (a @ M) = a *neg* poly:
    M[t, i] = poly[i - t] for i >= t, -poly[i - t + N] otherwise."""
    N = poly.shape[-1]
    doubled = torch.cat([poly, -poly], dim=-1)
    ar = torch.arange(N, device=poly.device)
    idx = (ar[None, :] - ar[:, None]) % (2 * N)              # (t, i)
    return doubled[..., idx]


def sample_extract(tlwe_av, index: int = 0):
    """Extract the LWE sample of coefficient ``index`` from a TRLWE sample
    (tLweExtractLweSampleIndex, tlwe_functions.cpp:351-362).

    tlwe_av: (..., k+1, N).  Returns (..., k*N + 1), LWE body last."""
    N = tlwe_av.shape[-1]
    k = tlwe_av.shape[-2] - 1
    a, b = tlwe_av[..., :k, :], tlwe_av[..., k, :]
    # a_out[i*N + j] = a[i, index-j] for j<=index ; -a[i, N+index-j] for j>index
    rolled = torch.roll(torch.flip(a, dims=(-1,)), index + 1, dims=-1)
    j = torch.arange(N, device=tlwe_av.device)
    a_out = torch.where(j <= index, rolled, -rolled)
    a_out = a_out.reshape(*tlwe_av.shape[:-2], k * N)
    return torch.cat([a_out, b[..., index:index + 1]], dim=-1)


def mul_fft(a_int, b_torus, precision: str = "auto"):
    """Approximate negacyclic product through the evaluation domain
    (torusPolynomialMultFFT, numeric_functions.cpp:140-148), the FFTEngine
    path as a one-shot convenience.  "auto" is "f64" on both devices (the
    H100 has native f64; the JAX package picks "dd" off its CPU)."""
    from tfhe_tpu_torch.ops import fft
    b = torch.as_tensor(b_torus)
    a = torch.as_tensor(a_int).to(b.device)
    N = b.shape[-1]
    bits = 32 if b.dtype == torch.int32 else 64
    if precision == "auto":
        precision = "f64"
    if precision == "f64":
        ha = fft.negacyclic_fft(a, precision="highest")
        hb = fft.negacyclic_fft(b, precision="highest")
        return fft.round_wrap(fft.negacyclic_ifft(ha * hb, N),
                              bits).to(b.dtype)
    xa = fft.negacyclic_fft_dd_dev(a)
    xb = fft.negacyclic_fft_dd_dev(b)
    return fft.negacyclic_ifft_dd_dev(fft._dd_cmul(*xa, *xb), N, bits)


def add_mul_fft(accum, a_int, b_torus, precision: str = "auto"):
    """accum + a (*) b through the FFT path (torusPolynomialAddMulRFFT,
    numeric_functions.cpp:149-160)."""
    accum = torch.as_tensor(accum)
    return T.add(accum, mul_fft(a_int, b_torus, precision).to(accum.dtype))


def sub_mul_fft(accum, a_int, b_torus, precision: str = "auto"):
    """accum - a (*) b through the FFT path (torusPolynomialSubMulRFFT,
    numeric_functions.cpp:161-172)."""
    accum = torch.as_tensor(accum)
    return T.sub(accum, mul_fft(a_int, b_torus, precision).to(accum.dtype))
