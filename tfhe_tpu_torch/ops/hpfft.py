"""High-precision anticyclic FFT study (the port of ``tfhe_tpu.ops.hpfft``,
the parity module for H1-H6 of SURVEY.md §2.2).

The reference subproject (high-precision-anticyclic-fft/src/code.cpp) asks
what an exact-ish negacyclic FFT over Torus64 costs when the reals are
128-bit fixed point (Real96: signed v/2^64 in a __uint128_t, code.cpp:25-41)
instead of doubles.  Its answer, viable but expensive, is why the library
computes its products exactly in int8 limbs (``ops.engine``).

  * **HP fixed point**: signed fixed-point reals with 64 fractional bits,
    stored as ``limbs`` 16-bit limbs in int64 tensors (16-bit limbs keep
    every partial product and carry inside int64).  ``limbs=6`` is the
    reference's Real96, ``limbs=8`` its 128-bit storage; other values give
    the GMP/MPFR precision sweep (bench_fft_gmp.cpp:16-25).
  * **Exact twiddles**: cos/sin(2*pi*i/n) rounded to 64 fractional bits by
    stdlib ``decimal`` Taylor series (the NTL-RR analog of
    accurate_cos/sin, code.cpp:246-277); this module keeps its own copy.
  * **The transform pair**: iFFT Torus64^N -> Cplx^{N/2} (twist by omega^j,
    then log2(N/4) DIF butterfly stages, code.cpp:391-443); FFT: DIT
    stages, untwist, then an arithmetic >> log2(n/4) for the 1/ns4
    normalization (code.cpp:446-512).
  * ``naive_eval``: the float oracle of the stage checks (code.cpp:302-374).

All arithmetic wraps mod 2^(16*limbs) as the reference's __uint128_t wraps
mod 2^128.  Torch's int64 ``>>`` is arithmetic, as ``jnp``'s is, so every
function equals the JAX module's bit for bit.  Everything runs on the
device of its input tensors (the card unless the caller passes CPU
tensors; numpy inputs and Python ints go to ``device``, the card by
default); the twiddle tables are cached per device.
"""

from __future__ import annotations

import decimal
import functools
import math

import numpy as np
import torch

from tfhe_tpu_torch import device as _device

FRAC_LIMBS = 4          # 64 fractional bits, 16 bits per limb
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _int64(x, device=None):
    """x as an int64 tensor: a tensor stays on its device; anything else
    goes to ``device`` (``device.resolve``: the card by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, np.int64),
                           device=_device.resolve(device))


# ---------------------------------------------------------------------------
# HP fixed-point arithmetic (H1: Real96, code.cpp:25-233)
# ---------------------------------------------------------------------------

def _normalize(z, limbs: int):
    """Propagate carries so every limb lands in [0, 2^16); wrap at the top."""
    outs = []
    carry = torch.zeros_like(z[..., 0])
    for i in range(limbs):
        t = z[..., i] + carry
        outs.append(t & LIMB_MASK)
        carry = t >> LIMB_BITS          # arithmetic shift: signed-safe
    return torch.stack(outs, dim=-1)


def hp_from_int(v, limbs: int, device=None):
    """Signed integer tensor -> HP value v (an integer-valued real)."""
    v = _int64(v, device)
    fr = [torch.zeros_like(v)] * FRAC_LIMBS
    out = [(v >> min(LIMB_BITS * i, 63)) & LIMB_MASK
           for i in range(limbs - FRAC_LIMBS)]
    return torch.stack(fr + out, dim=-1)


def hp_from_t64(x, limbs: int, device=None):
    """Torus64 (int64, value x/2^64) -> HP (t64tor96, code.cpp:193-198)."""
    x = _int64(x, device)
    out = [(x >> min(LIMB_BITS * i, 63)) & LIMB_MASK for i in range(limbs)]
    return torch.stack(out, dim=-1)


def hp_to_t64(a):
    """HP -> Torus64: the low 64 bits of v (FFT output path, code.cpp:502)."""
    r = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(FRAC_LIMBS):
        r = r | (a[..., i].to(torch.int64) << (LIMB_BITS * i))
    return r


def hp_to_float(a) -> np.ndarray:
    """HP -> float64 (display and tests only; Real96's operator<<)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    limbs = a.shape[-1]
    total = np.zeros(a.shape[:-1], object)
    for i in reversed(range(limbs)):
        total = total * (1 << LIMB_BITS) + a[..., i].astype(object)
    half = 1 << (LIMB_BITS * limbs - 1)
    total = np.where(total >= half, total - (1 << (LIMB_BITS * limbs)), total)
    return (total / float(2 ** (LIMB_BITS * FRAC_LIMBS))).astype(np.float64)


def hp_add(a, b):
    return _normalize(a + b, a.shape[-1])


def hp_sub(a, b):
    return _normalize(a - b, a.shape[-1])


def hp_neg(a):
    return _normalize(-a, a.shape[-1])


def hp_rshift(a, s: int):
    """Arithmetic right shift of the signed multi-limb value by s bits
    (the FFT's /ns4 normalization, code.cpp:502-503)."""
    limbs = a.shape[-1]
    q, r = divmod(s, LIMB_BITS)
    sign = (a[..., -1] >> (LIMB_BITS - 1)) & 1
    ext = sign * LIMB_MASK
    shifted = [a[..., i + q] if i + q < limbs else ext for i in range(limbs)]
    if r == 0:
        return torch.stack(shifted, dim=-1)
    out = []
    for i in range(limbs):
        hi = shifted[i + 1] if i + 1 < limbs else ext
        out.append(((shifted[i] >> r) | (hi << (LIMB_BITS - r))) & LIMB_MASK)
    return torch.stack(out, dim=-1)


def hp_mul(a, b):
    """Signed fixed-point product, truncated: intmul_ref (code.cpp:79-97),
    dest = (int(a) * int(b)) >> 64, wrapped mod 2^(16*limbs).

    The full 2L-limb unsigned product (partials < 2^32, sums < L*2^32: all
    in int64) plus two's-complement sign corrections, then the window
    [FRAC_LIMBS, FRAC_LIMBS+L) after carry normalization."""
    limbs = a.shape[-1]
    L2 = 2 * limbs
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    z = [torch.zeros(shape, dtype=torch.int64, device=a.device)
         for _ in range(L2)]
    for i in range(limbs):
        ai = a[..., i]
        for j in range(limbs):
            p = ai * b[..., j]
            z[i + j] = z[i + j] + (p & LIMB_MASK)
            if i + j + 1 < L2:
                z[i + j + 1] = z[i + j + 1] + (p >> LIMB_BITS)
    # signed correction: a*b = au*bu - sa*bu*2^(16L) - sb*au*2^(16L) (+ drop)
    sa = (a[..., -1] >> (LIMB_BITS - 1)) & 1
    sb = (b[..., -1] >> (LIMB_BITS - 1)) & 1
    for j in range(limbs):
        if limbs + j < FRAC_LIMBS + limbs:   # only limbs inside kept window
            z[limbs + j] = z[limbs + j] - sa * b[..., j] - sb * a[..., j]
    full = _normalize(torch.stack(z, dim=-1), L2)
    return full[..., FRAC_LIMBS:FRAC_LIMBS + limbs]


def hp_cmul(ar, ai, br, bi):
    """(ar+i*ai)*(br+i*bi) on HP parts: complex<Real96> operator*."""
    rr = hp_sub(hp_mul(ar, br), hp_mul(ai, bi))
    ii = hp_add(hp_mul(ar, bi), hp_mul(ai, br))
    return rr, ii


# ---------------------------------------------------------------------------
# Exact twiddles by decimal Taylor series (H2: accurate_cos/sin,
# code.cpp:246-277, NTL RR replaced by stdlib arbitrary-precision decimal)
# ---------------------------------------------------------------------------

_PI_50 = decimal.Decimal("3.14159265358979323846264338327950288419716939937511")


def _dec_cos_sin(x: decimal.Decimal):
    """cos(x), sin(x) by Taylor series at 50-digit working precision."""
    with decimal.localcontext() as ctx:
        ctx.prec = 50
        c = decimal.Decimal(1)
        s = decimal.Decimal(0)
        term = decimal.Decimal(1)
        k = 0
        while abs(term) > decimal.Decimal("1e-45"):
            k += 1
            term = term * x / k
            if k % 4 == 1:
                s += term
            elif k % 4 == 2:
                c -= term
            elif k % 4 == 3:
                s -= term
            else:
                c += term
        return c, s


@functools.cache
def _twiddle_ints(n: int):
    """round(cos/sin(2*pi*i/n) * 2^64) as Python ints, i < n."""
    cos_i, sin_i = [], []
    scale = 1 << 64
    with decimal.localcontext() as ctx:
        ctx.prec = 50
        for i in range(n):
            x = _PI_50 * 2 * i / n
            c, s = _dec_cos_sin(x)
            cos_i.append(int((c * scale).to_integral_value(
                rounding=decimal.ROUND_HALF_EVEN)))
            sin_i.append(int((s * scale).to_integral_value(
                rounding=decimal.ROUND_HALF_EVEN)))
    return cos_i, sin_i


def _ints_to_hp(vals, limbs: int) -> np.ndarray:
    out = np.zeros((len(vals), limbs), np.int64)
    mod = 1 << (LIMB_BITS * limbs)
    for r, v in enumerate(vals):
        u = v % mod
        for i in range(limbs):
            out[r, i] = (u >> (LIMB_BITS * i)) & LIMB_MASK
    return out


@functools.cache
def precomp_ifft(n: int, limbs: int, device: torch.device):
    """powomega[i] = (cos, sin)(2*pi*i/n) as HP parts (code.cpp:378-382),
    on ``device``."""
    cos_i, sin_i = _twiddle_ints(n)
    return (torch.from_numpy(_ints_to_hp(cos_i, limbs)).to(device),
            torch.from_numpy(_ints_to_hp(sin_i, limbs)).to(device))


@functools.cache
def precomp_fft(n: int, limbs: int, device: torch.device):
    """powombar[i] = (cos(i), sin(n-i)), the conjugates (code.cpp:384-388),
    on ``device``."""
    cos_i, sin_i = _twiddle_ints(n)
    sbar = [sin_i[(n - i) % n] for i in range(n)]
    return (torch.from_numpy(_ints_to_hp(cos_i, limbs)).to(device),
            torch.from_numpy(_ints_to_hp(sbar, limbs)).to(device))


# ---------------------------------------------------------------------------
# The anticyclic transform pair (H3: iFFT/FFT, code.cpp:391-512)
# ---------------------------------------------------------------------------

def _twiddle_index(ns4: int, half: int, n: int, device):
    return torch.from_numpy((2 * (ns4 // half) * np.arange(half)) % n).to(
        device)


def _dif(re, im, wr, wi, limbs: int):
    """The twist by omega^j, then the DIF butterflies nn = n/4 .. 2 with
    twiddle omega^{2*(ns4/halfnn)*off}, on HP (re, im) of (..., N/2)."""
    ns4 = re.shape[-2]
    n = 4 * ns4
    re, im = hp_cmul(re, im, wr[:ns4], wi[:ns4])
    nn = ns4
    while nn >= 2:
        half = nn // 2
        sh = re.shape[:-2]
        re_b = re.reshape(*sh, ns4 // nn, nn, limbs)
        im_b = im.reshape(*sh, ns4 // nn, nn, limbs)
        t1r, t1i = re_b[..., :half, :], im_b[..., :half, :]
        t2r, t2i = re_b[..., half:, :], im_b[..., half:, :]
        sr, si = hp_add(t1r, t2r), hp_add(t1i, t2i)
        dr, di = hp_sub(t1r, t2r), hp_sub(t1i, t2i)
        idx = _twiddle_index(ns4, half, n, re.device)
        dr, di = hp_cmul(dr, di, wr[idx], wi[idx])
        re = torch.cat([sr, dr], dim=-2).reshape(*sh, ns4, limbs)
        im = torch.cat([si, di], dim=-2).reshape(*sh, ns4, limbs)
        nn = half
    return re, im


def hp_ifft(coefs, limbs: int = 6, device=None):
    """Torus64 coefficients (..., N) -> evaluations at odd 2N-th roots.

    Returns (re, im) HP tensors of shape (..., N/2, limbs).  Structure per
    code.cpp:391-443: twist out[j] = (in[j] + i*in[j+N/2]) * omega^j, then
    DIF butterflies nn = n/4 .. 2 with twiddle omega^{2*(ns4/halfnn)*off}.
    """
    coefs = _int64(coefs, device)
    N = coefs.shape[-1]
    ns4 = N // 2
    wr, wi = precomp_ifft(2 * N, limbs, coefs.device)
    re = hp_from_t64(coefs[..., :ns4], limbs)
    im = hp_from_t64(coefs[..., ns4:], limbs)
    return _dif(re, im, wr, wi, limbs)


def hp_fft(re, im):
    """Evaluations -> Torus64 coefficients (..., N), code.cpp:446-512.

    DIT butterflies nn = 2 .. n/4 with conjugate twiddles, untwist by
    ombar^j, then >> log2(ns4) (the reference's hardcoded >>10) and the
    low-64-bit extraction."""
    limbs = re.shape[-1]
    ns4 = re.shape[-2]
    n = 4 * ns4
    wr, wi = precomp_fft(n, limbs, re.device)
    nn = 2
    while nn <= ns4:
        half = nn // 2
        sh = re.shape[:-2]
        re_b = re.reshape(*sh, ns4 // nn, nn, limbs)
        im_b = im.reshape(*sh, ns4 // nn, nn, limbs)
        t1r, t1i = re_b[..., :half, :], im_b[..., :half, :]
        t2r, t2i = re_b[..., half:, :], im_b[..., half:, :]
        idx = _twiddle_index(ns4, half, n, re.device)
        t2r, t2i = hp_cmul(t2r, t2i, wr[idx], wi[idx])
        sr, si = hp_add(t1r, t2r), hp_add(t1i, t2i)
        dr, di = hp_sub(t1r, t2r), hp_sub(t1i, t2i)
        re = torch.cat([sr, dr], dim=-2).reshape(*sh, ns4, limbs)
        im = torch.cat([si, di], dim=-2).reshape(*sh, ns4, limbs)
        nn *= 2
    re, im = hp_cmul(re, im, wr[:ns4], wi[:ns4])
    s = int(math.log2(ns4))
    lo = hp_to_t64(hp_rshift(re, s))
    hi = hp_to_t64(hp_rshift(im, s))
    return torch.cat([lo, hi], dim=-1)


def hp_ifft_int(a_int, limbs: int = 6, device=None):
    """iFFT of an INTEGER polynomial: hp_ifft's pipeline with the input
    embedded at integer scale (value a_j, not a_j/2^64) so the evaluations
    stay exact-magnitude reals.  For the gadget-digit operand of an external
    product (|a| <= Bg/2) the integer part needs log2(N * Bg/2) bits, well
    within limbs=6's 32 integer bits."""
    a_int = _int64(a_int, device)
    N = a_int.shape[-1]
    ns4 = N // 2
    wr, wi = precomp_ifft(2 * N, limbs, a_int.device)
    re = hp_from_int(a_int[..., :ns4], limbs)
    im = hp_from_int(a_int[..., ns4:], limbs)
    return _dif(re, im, wr, wi, limbs)


def hp_negacyclic_mul(a_int, b_t64, limbs: int = 6, device=None):
    """Precision-study negacyclic product: int poly x Torus64 poly.

    The H4 key-switch use case (code.cpp:590-636): both operands to the
    evaluation domain, pointwise complex product, back.  The int operand
    rides at integer scale (hp_ifft_int), so no torus precision is spent on
    it; the result is the torus64 product a*b mod X^N+1 up to the FFT's
    fixed-point rounding (a few thousand ulps of 2^-64 at limbs=6, the
    reference's very_close tolerance, code.cpp:235).  ``a_int`` and
    ``b_t64`` lie on one device (``device`` for non-tensors)."""
    ar, ai = hp_ifft_int(a_int, limbs, device)
    br, bi = hp_ifft(b_t64, limbs, device)
    pr, pi = hp_cmul(ar, ai, br, bi)
    return hp_fft(pr, pi)


# ---------------------------------------------------------------------------
# Stage-invariant oracle (H3 checkers: ifft_check/fft_check,
# code.cpp:302-374): naive evaluation, in float64 on the host
# ---------------------------------------------------------------------------

def naive_eval(coefs: np.ndarray) -> np.ndarray:
    """Evaluate sum_j c_j X^j (c Torus64) at ALL N odd 2N-th roots
    omega^(2k+1), k < N (a conjugate-closed set).

    The float oracle of the checkers' content (the reference asserts
    stagewise closeness, code.cpp:310-343).  The transform's N/2 slots land
    on N/2 conjugate-distinct members of this set in bit-reversed block
    order."""
    coefs = np.asarray(coefs)
    N = len(coefs)
    k = np.arange(N)[:, None]
    w = np.exp(1j * np.pi * (2 * k + 1) * np.arange(N)[None, :] / N)
    return (coefs.astype(np.float64)[None, :] * w).sum(axis=1) / 2.0**64


def gmp_sweep_params(alpha_bits: int):
    """Precision-sweep parameters of the GMP/MPFR study
    (bench_fft_gmp.cpp:16-25): the noise parameter alpha = 2^-alpha_bits
    sets the minimal ring size and the fixed-point widths.

    Returns dict(alpha_bits, min_n, log2n, N, fprec, iprec, limbs), where
    ``limbs`` is the 16-bit limb count covering fprec + iprec bits here."""
    min_n = 1000 * alpha_bits // 35
    log2n = int(math.ceil(math.log2(min_n)))
    N = 1 << log2n
    fprec = alpha_bits + 4
    iprec = fprec // 2
    limbs = -(-(fprec + iprec) // 16)
    return {"alpha_bits": alpha_bits, "min_n": min_n, "log2n": log2n,
            "N": N, "fprec": fprec, "iprec": iprec, "limbs": limbs}
