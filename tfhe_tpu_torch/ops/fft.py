"""Anticyclic (negacyclic) FFT engines, the counterpart of
``tfhe_tpu.ops.fft``.

  * ``negacyclic_fft`` / ``negacyclic_ifft``: the complex evaluation
    transform through ``torch.fft`` (cuFFT on the card) over complex128,
    with the odd-root twist as an elementwise pre/post multiply;
  * a double-float (f32 x 2, ~49-bit mantissa) radix-2 FFT built from
    error-free transforms (TwoSum, split, TwoProd);
  * ``FFTEngine``: the engine contract in the evaluation domain.
    APPROXIMATE by design, like the reference's spqlios path; the integer
    engines of ``ops.engine`` are exact.

Convention (the reference's layout, fft_processor_spqlios.cpp:21-24): the
evaluation vector of a real polynomial a of length N is
  hat(a)_k = sum_j a_j w^{(2k+1) j},  w = exp(i*pi/N),  k < N/2.

The double-float chain is right only if every product and every sum is
rounded on its own.  It runs as eager elementwise PyTorch operations, one
kernel each, so nothing can contract ``a*b + c`` into an FMA: no
``torch.compile``, fused kernel, ``addcmul``/``addcdiv``/``baddbmm`` may
touch it.  The JAX package needs optimization barriers and broadcast
workarounds here (XLA's algebraic simplifier and an XLA:CPU miscompile);
eager PyTorch has neither pass, so the port has no such helpers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops.engine import _EngineBase

# ---------------------------------------------------------------------------
# f64 transform (torch.fft + twist)
# ---------------------------------------------------------------------------

def _twist(N: int, dtype):
    return np.exp(1j * np.pi * np.arange(N) / N).astype(dtype)


@functools.lru_cache(maxsize=None)
def _twist_t(N: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_twist(N, np.complex128)).to(device)


def spqlios_order(N: int):
    """Map the natural-order evaluation vector onto the spqlios buffer order
    (spqlios-fft-impl.cpp:48-155):

        slot[2t]   = hat(a)_{bitrev(t)}
        slot[2t+1] = conj(hat(a)_{N/2-1-bitrev(t)})

    with bitrev over log2(N/2) bits.  Returns (perm, conj): natural index
    feeding slot s is perm[s]; conj[s] marks slots holding the conjugate.
    """
    half = N // 2
    bits = half.bit_length() - 1
    t = np.arange(half // 2)
    br = np.zeros(half // 2, np.int64)
    for b in range(bits):
        br |= ((t >> b) & 1) << (bits - 1 - b)
    perm = np.zeros(half, np.int64)
    conj = np.zeros(half, bool)
    perm[0::2] = br
    perm[1::2] = half - 1 - br
    conj[1::2] = True
    return perm, conj


def to_spqlios(hat):
    """(..., N/2) complex natural-order evaluations -> (..., N) float64 in
    the reference's buffer layout (re[N/2] ++ im[N/2], spqlios slot order)."""
    hat = torch.as_tensor(hat)
    half = hat.shape[-1]
    perm, conj = spqlios_order(2 * half)
    v = hat[..., torch.from_numpy(perm).to(hat.device)]
    v = torch.where(torch.from_numpy(conj).to(hat.device), v.conj(), v)
    return torch.cat([v.real, v.imag], dim=-1)


def from_spqlios(buf):
    """Inverse of to_spqlios: (..., N) float64 -> (..., N/2) complex128."""
    buf = torch.as_tensor(buf)
    half = buf.shape[-1] // 2
    v = torch.complex(buf[..., :half], buf[..., half:])
    perm, conj = spqlios_order(2 * half)
    v = torch.where(torch.from_numpy(conj).to(buf.device), v.conj(), v)
    out = torch.empty_like(v)
    out[..., torch.from_numpy(perm).to(buf.device)] = v
    return out


def negacyclic_fft(a, precision: str = "auto"):
    """(..., N) real/int -> (..., N/2) complex evaluations at odd roots:
    hat(a)_k = N * ifft(a * w^j)_k.

    "auto" and "highest" run in complex128 on both devices (the H100 has
    native f64; the JAX package's "auto" takes complex64 on its TPU); any
    other precision runs in complex64."""
    a = torch.as_tensor(a)
    N = a.shape[-1]
    w = _twist_t(N, a.device)
    if precision in ("auto", "highest"):
        b = a.to(torch.float64) * w
    else:
        b = a.to(torch.float32) * w.to(torch.complex64)
    return torch.fft.ifft(b, dim=-1)[..., : N // 2] * N


def negacyclic_ifft(ahat, N: int | None = None):
    """(..., N/2) complex evaluations -> (..., N) real coefficients."""
    ahat = torch.as_tensor(ahat)
    N = N or 2 * ahat.shape[-1]
    full = torch.cat([ahat, torch.flip(ahat, dims=(-1,)).conj()], dim=-1)
    w = _twist_t(N, ahat.device).to(full.dtype)
    b = torch.fft.fft(full, dim=-1) / N
    return (b * w.conj()).real


# ---------------------------------------------------------------------------
# Double-float (f32 x 2) building blocks: error-free transforms
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a):
    """a = hi + lo with hi holding 12 significand bits, so hi*hi' is exact
    in f32: the mantissa masked (a - hi is exact by Sterbenz)."""
    hi = (a.view(torch.int32) & ~0xFFF).view(torch.float32)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def dd_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    hi = s + e
    return hi, e - (hi - s)


def dd_mul(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    hi = p + e
    return hi, e - (hi - p)


def dd_from_f64(x, device=None):
    """Split f64 values into (hi, lo) f32 pairs (on ``device``)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(hi).to(device or "cpu"),
            torch.from_numpy(lo).to(device or "cpu"))


def _dd_cmul(ar_h, ar_l, ai_h, ai_l, br_h, br_l, bi_h, bi_l):
    """(a * b) for dd-complex: (ar+i*ai)(br+i*bi)."""
    rr_h, rr_l = dd_mul(ar_h, ar_l, br_h, br_l)
    ii_h, ii_l = dd_mul(ai_h, ai_l, bi_h, bi_l)
    ri_h, ri_l = dd_mul(ar_h, ar_l, bi_h, bi_l)
    ir_h, ir_l = dd_mul(ai_h, ai_l, br_h, br_l)
    re_h, re_l = dd_add(rr_h, rr_l, -ii_h, -ii_l)
    im_h, im_l = dd_add(ri_h, ri_l, ir_h, ir_l)
    return re_h, re_l, im_h, im_l


@functools.lru_cache(maxsize=None)
def _bitrev_perm(N: int) -> np.ndarray:
    bits = N.bit_length() - 1
    out = np.zeros(N, np.int64)
    for i in range(N):
        out[i] = int(format(i, f"0{bits}b")[::-1], 2)
    return out


@functools.lru_cache(maxsize=None)
def _fft_tables(N: int, inverse: bool, device: torch.device):
    """The bit reversal and every stage's dd twiddles, on ``device``."""
    sign = 1.0 if inverse else -1.0
    stages, m = [], 2
    while m <= N:
        idx = np.arange(m // 2) * (N // m)
        t = np.exp(sign * 2j * np.pi * idx / N)
        stages.append((*dd_from_f64(t.real, device),
                       *dd_from_f64(t.imag, device)))
        m *= 2
    return torch.from_numpy(_bitrev_perm(N)).to(device), stages


@functools.lru_cache(maxsize=None)
def _dd_twist(N: int, sign: float, device: torch.device):
    w = np.exp(sign * 1j * np.pi * np.arange(N) / N)
    return (*dd_from_f64(w.real, device), *dd_from_f64(w.imag, device))


def dd_fft(re_h, re_l, im_h, im_l, inverse: bool = False):
    """Iterative radix-2 DIT FFT over dd-complex, batched on leading axes."""
    N = re_h.shape[-1]
    rev, stages = _fft_tables(N, inverse, re_h.device)
    xs = [torch.as_tensor(v).index_select(-1, rev)
          for v in (re_h, re_l, im_h, im_l)]
    m = 2
    for trh, trl, tih, til in stages:
        half = m // 2
        sh = xs[0].shape[:-1]
        blk = [v.reshape(*sh, N // m, m) for v in xs]
        ar = [v[..., :half] for v in blk]
        br = [v[..., half:] for v in blk]
        tr_h, tr_l, ti_h, ti_l = _dd_cmul(
            br[0], br[1], br[2], br[3], trh, trl, tih, til)
        o1 = dd_add(ar[0], ar[1], tr_h, tr_l)
        o2 = dd_add(ar[2], ar[3], ti_h, ti_l)
        o3 = dd_add(ar[0], ar[1], -tr_h, -tr_l)
        o4 = dd_add(ar[2], ar[3], -ti_h, -ti_l)
        xs = [torch.cat([p, q], dim=-1).reshape(*sh, N)
              for p, q in ((o1[0], o3[0]), (o1[1], o3[1]),
                           (o2[0], o4[0]), (o2[1], o4[1]))]
        m *= 2
    return xs


def negacyclic_fft_dd(a):
    """(..., N) host int/real -> dd-complex evaluations (4 CPU tensors of
    (..., N/2)), the twist applied in f64 on the host."""
    a = np.asarray(a)
    N = a.shape[-1]
    w = np.exp(1j * np.pi * np.arange(N) / N)
    rh, rl = dd_from_f64(a * w.real)
    ih, il = dd_from_f64(a * w.imag)
    out = dd_fft(rh, rl, ih, il, inverse=True)
    return [v[..., : N // 2] for v in out]


def dd_from_int(a):
    """Integer tensor -> real dd pair (hi, lo) f32, exact to ~48 bits."""
    a = torch.as_tensor(a)
    ah = a.to(torch.float32)
    al = (a.to(torch.int64) - ah.to(torch.int64)).to(torch.float32)
    return ah, al


def negacyclic_fft_dd_dev(a):
    """(..., N) integer tensor (on its device) -> 4 x (..., N/2) f32
    dd-complex parts.  The twist multiply runs in dd, so torus32-scale
    inputs keep ~49 significant bits."""
    a = torch.as_tensor(a)
    N = a.shape[-1]
    wrh, wrl, wih, wil = _dd_twist(N, 1.0, a.device)
    ah, al = dd_from_int(a)
    rh, rl = dd_mul(ah, al, wrh, wrl)
    ih, il = dd_mul(ah, al, wih, wil)
    out = dd_fft(rh, rl, ih, il, inverse=True)
    return [v[..., : N // 2] for v in out]


def _hermitian_extend(parts):
    """Hermitian-odd extension of the N/2 evaluations: hat(a)_{N-1-k} =
    conj(hat(a)_k) under this convention's index map."""
    rh, rl, ih, il = [torch.as_tensor(v) for v in parts]
    return (torch.cat([rh, torch.flip(rh, dims=(-1,))], dim=-1),
            torch.cat([rl, torch.flip(rl, dims=(-1,))], dim=-1),
            torch.cat([ih, -torch.flip(ih, dims=(-1,))], dim=-1),
            torch.cat([il, -torch.flip(il, dims=(-1,))], dim=-1))


def negacyclic_ifft_dd_dev(parts, N: int, bits: int):
    """Inverse: dd-complex (..., N/2) -> (..., N) torus ints with exact
    mod-2^bits wrap (rounded to nearest)."""
    orh, orl, oih, oil = dd_fft(*_hermitian_extend(parts), inverse=False)
    wrh, wrl, wih, wil = _dd_twist(N, -1.0, orh.device)
    re_h, re_l, _, _ = _dd_cmul(orh, orl, oih, oil, wrh, wrl, wih, wil)
    inv = 1.0 / N                              # N a power of 2: exact scale
    return dd_to_int(re_h * inv, re_l * inv, bits)


def dd_to_int(hi, lo, bits: int):
    """Round a dd value to the nearest integer mod 2^bits, exactly.

    hi may reach ~2^(49+log2 N), past f32's 24-bit integer range, so split
    hi = q*2^16 + r with q = rint(hi/2^16) (q*2^16 exact; r exact by
    Sterbenz), then assemble in int64, where wrap-around is native
    (the dd analog of fft_processor_spqlios.cpp:105-156)."""
    q = torch.round(hi * 2.0**-16)
    r = hi - q * 2.0**16
    v = (q.to(torch.int64) << 16) + torch.round(r + lo).to(torch.int64)
    return v.to(torch.int32) if bits == 32 else v


def negacyclic_ifft_dd(parts, N: int):
    """Inverse of negacyclic_fft_dd: dd-complex (..., N/2) -> (..., N)
    float64 coefficients."""
    orh, orl, oih, oil = dd_fft(*_hermitian_extend(parts), inverse=False)
    wrh, wrl, wih, wil = _dd_twist(N, -1.0, orh.device)
    re_h, re_l, _, _ = _dd_cmul(orh, orl, oih, oil, wrh, wrl, wih, wil)
    return (re_h.to(torch.float64) + re_l.to(torch.float64)) / N


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def round_wrap(y, bits: int):
    """float64 coefficients -> the nearest integers mod 2^bits, centred
    (int32 at 32 bits, int64 at 64)."""
    m = 2.0**bits
    w = (torch.round(y) - m * torch.round(y / m)).to(torch.int64)
    return w.to(torch.int32) if bits == 32 else w


class FFTEngine(_EngineBase):
    """Evaluation-domain negacyclic product engine (the spqlios production
    path, fft_processor_spqlios.cpp:18-170), ``tfhe_tpu.ops.fft.FFTEngine``.

        prepare(key (J, U, N) torus) -> {"hat": eval-domain key}
        accumulate(x (..., J, N) digits) -> (..., U, N) torus

    APPROXIMATE by design.  Two precisions:
      "f64" - complex128 through torch.fft (cuFFT on the card) and a
              complex128 einsum over j; envelope ~2^4 absolute on torus32
              gate shapes;
      "dd"  - the double-float radix-2 FFT above, eager f32 operations;
              envelope ~2^8 on torus32, torus32 outputs only; its prepared
              key is the tuple of the 4 f32 parts.
    Device adaptation: the JAX package allows "f64" on its CPU backend only
    and lets "auto" pick dd elsewhere, because its TPU has no f64.  The
    H100 has native f64, so here "f64" runs on the card too and "auto"
    picks f64 on both devices (the JAX package's own choice on the CPU).
    ``cmux_step`` returns None (``_EngineBase``): the blind rotation takes
    the generic step."""

    def __init__(self, cfg, precision: str = "auto"):
        self.cfg = cfg
        if precision == "auto":
            precision = "f64"
        if precision not in ("f64", "dd"):
            raise ValueError(f"unknown FFT precision {precision!r}")
        if precision == "dd" and cfg.out_bits != 32:
            raise ValueError("dd FFT engine covers torus32 outputs only "
                             "(~49-bit mantissa)")
        self.precision = precision

    def prepare(self, key_polys):
        key_polys = torch.as_tensor(key_polys)
        assert key_polys.shape[-1] == self.cfg.N
        if self.precision == "f64":
            return {"hat": negacyclic_fft(key_polys, precision="highest")}
        return {"hat": tuple(negacyclic_fft_dd_dev(key_polys))}

    def accumulate(self, x, prepared):
        cfg = self.cfg
        x = torch.as_tensor(x)
        J = x.shape[-2]
        if self.precision == "f64":
            hk = prepared["hat"]                            # (J, U, N/2)
            hx = negacyclic_fft(x, precision="highest")     # (..., J, N/2)
            hy = torch.einsum("...jk,juk->...uk", hx, hk)
            return round_wrap(negacyclic_ifft(hy, cfg.N), cfg.out_bits)
        kh = prepared["hat"]                                # 4 x (J, U, N/2)
        xh = negacyclic_fft_dd_dev(x)                       # 4 x (..., J, N/2)
        U = kh[0].shape[1]
        outs = []
        for u in range(U):
            acc = None
            for j in range(J):
                parts = _dd_cmul(*(v[..., j, :] for v in xh),
                                 *(v[j, u] for v in kh))
                if acc is None:
                    acc = list(parts)
                else:
                    acc[0], acc[1] = dd_add(acc[0], acc[1], parts[0],
                                            parts[1])
                    acc[2], acc[3] = dd_add(acc[2], acc[3], parts[2],
                                            parts[3])
            outs.append(negacyclic_ifft_dd_dev(acc, cfg.N, cfg.out_bits))
        return torch.stack(outs, dim=-2)

    def accumulate_into(self, acc, x, prepared):
        return T.add(acc, self.accumulate(x, prepared))
