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


def negacyclic_mul_exact(a_int, b_torus):
    """Exact negacyclic product of an integer polynomial with a torus
    polynomial, wrapping in b's dtype: the O(N^2) oracle (the analog of the
    reference's exact Karatsuba path, poc_karatsuba.cpp:60-94).

    a_int: (..., N) integer; b_torus: (..., N) int32 or int64
    (broadcastable).  Summed in int64, which wraps mod 2^64 (and so stays
    right mod 2^32), as an elementwise product: integer matrix products do
    not run on CUDA."""
    b = torch.as_tensor(b_torus)
    M = negacyclic_matrix(b).to(torch.int64)                 # (..., N, N)
    a = torch.as_tensor(a_int).to(device=b.device, dtype=torch.int64)
    y = (a[..., :, None] * M).sum(-2)
    return y if b.dtype == torch.int64 else T.wrap32(y)


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


# ---------------------------------------------------------------------------
# Scalar mul-adds and norms (numeric_functions.cpp:140-460)
# ---------------------------------------------------------------------------

def add_mul_z(accum, p, x):
    """accum + p * x with the torus wrap of accum's dtype
    (torusPolynomialAddMulZTo, numeric_functions.cpp:316-322).  p: an
    integer scalar or a (..., 1) tensor."""
    accum = torch.as_tensor(accum)
    prod = (torch.as_tensor(p).to(torch.int64)
            * torch.as_tensor(x).to(torch.int64))
    return T.add(accum, prod.to(accum.device))


def sub_mul_z(accum, p, x):
    """accum - p * x with the torus wrap of accum's dtype
    (torusPolynomialSubMulZTo, numeric_functions.cpp:324-330)."""
    accum = torch.as_tensor(accum)
    prod = (torch.as_tensor(p).to(torch.int64)
            * torch.as_tensor(x).to(torch.int64))
    return T.sub(accum, prod.to(accum.device))


def int_norm_sq2(x):
    """Euclidean norm^2 of integer polynomials over the last axis
    (intPolynomialNormSq2/Norm2sq, numeric_functions.cpp:361-371,437-446),
    float64."""
    x = torch.as_tensor(x).to(torch.float64)
    return (x * x).sum(-1)


def int_norm_infty_dist(a, b):
    """max |a - b| over the last axis (intPolynomialNormInftyDist,
    numeric_functions.cpp:449-461), float64."""
    d = torch.as_tensor(a).to(torch.int64) - torch.as_tensor(b).to(
        torch.int64)
    return d.abs().to(torch.float64).amax(-1)


def torus_norm_infty_dist(a, b):
    """max |t2double(a - b)| over the last axis, with the wrap-aware
    difference (torusPolynomialNormInftyDist, numeric_functions.cpp:419-428).
    """
    a = torch.as_tensor(a)
    d = T.sub(a, torch.as_tensor(b).to(a.dtype))        # the torus wrap
    bits = 32 if a.dtype == torch.int32 else 64
    return (d.to(torch.float64) / 2.0**bits).abs().amax(-1)


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
