"""Nussbaumer-factored negacyclic engine, the counterpart of
``tfhe_tpu.ops.nussbaumer``: sub-quadratic integer products.

With N = m*r (r >= m, powers of two) and Y = X^m, a polynomial of
Z[X]/(X^N+1) is m slot polynomials of A = Z[Y]/(Y^r+1), and the product is
a length-2m cyclic convolution over A whose DFT twiddles are powers of
Y^(r/m): negacyclic rolls, data movement only.  What multiplies is 2m
pointwise products in A, length-r negacyclic products run as int8 limb
GEMMs (one ``lwe._int8_matmul`` per slot and digit plane: PyTorch has no
batched int8 GEMM on CUDA; J*r and U*L*r are multiples of 8, as
``torch._int_mm`` needs).

The key is pre-divided by 2m with rounding (k' = round(k / 2m)), which
folds the inverse transform's 1/2m scale into the key: the result differs
from the exact product by a (*) eps, eps = k - 2m*k' in [-m, m], and is
bit-exact for keys whose coefficients are multiples of 2m.  Every step is
deterministic integer arithmetic mod 2^32 or 2^64 (int64 here, wrapped to
32 bits at the end), so the engine equals the JAX package's bit for bit on
any key.  The DFT is the JAX package's radix-2 decimation in time, run
stage by stage over all blocks at once (bit-reversed slots, one gather a
stage for the twiddle rolls) instead of its recursion.

Engine contract (``ops.engine``):
    prepare(key_polys (J, U, N) torus) -> {"w": (2m, J*r, U*L*r) int8}
    accumulate(x (..., J, N) int digits, prepared) -> (..., U, N) torus
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tfhe_tpu_torch import lwe
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops.engine import EngineConfig, _EngineBase


def split_mr(N: int) -> tuple[int, int]:
    """N = m * r with m = 2^floor(log4 N) <= r (A = Z[Y]/(Y^r+1) then holds
    a 2m-th root of unity, Y^(r/m))."""
    k = N.bit_length() - 1
    m = 1 << (k // 2)
    return m, N // m


@functools.lru_cache(maxsize=None)
def _roll_table(shifts: tuple, r: int, device) -> tuple:
    """Row index, gather index and sign of Y^shift * b for each shift of
    ``shifts``: out[s, q] = sign[s, q] * b[rows[s], idx[s, q]] in
    Z[Y]/(Y^r+1).  Built once a shape, on ``device``: a host tensor in the
    step would copy to the card, which waits for the stream."""
    sh = torch.tensor(shifts, dtype=torch.int64)[:, None] % (2 * r)
    src = torch.arange(r)[None, :] - sh                    # in (-2r, r)
    sign = torch.where((src < 0) & (src >= -r), -1, 1)
    rows = torch.arange(len(shifts))[:, None]
    return (rows.to(device), torch.remainder(src, r).to(device),
            sign.to(device))


def _neg_shift(x, s: int):
    """Negacyclic roll by s over the last axis (Y^s * x in Z[Y]/(Y^r+1))."""
    r = x.shape[-1]
    s = s % (2 * r)
    sign = 1
    if s >= r:
        s -= r
        sign = -1
    if s == 0:
        return sign * x
    return sign * torch.cat([-x[..., r - s:], x[..., :r - s]], dim=-1)


@functools.lru_cache(maxsize=None)
def _bitrev(S: int, device) -> torch.Tensor:
    bits = S.bit_length() - 1
    return torch.tensor([int(format(i, f"0{bits}b")[::-1], 2)
                         for i in range(S)], device=device)


def _dft(x, root_shift: int):
    """Cyclic DFT over the slot axis (-2, length S a power of two) with root
    eta = Y^root_shift of order S, the twiddles negacyclic rolls over the
    last axis: radix-2 decimation in time, one pass a stage."""
    *lead, S, r = x.shape
    if S == 1:
        return x
    x = x.index_select(-2, _bitrev(S, x.device))
    mm = 2
    while mm <= S:
        half = mm // 2
        rows, idx, sign = _roll_table(tuple(root_shift * (S // mm) * s
                                            for s in range(half)), r,
                                      x.device)
        blk = x.reshape(*lead, S // mm, mm, r)
        a, b = blk[..., :half, :], blk[..., half:, :]
        t = b[..., rows, idx] * sign.to(x.dtype)
        x = torch.cat([a + t, a - t], dim=-2).reshape(*lead, S, r)
        mm *= 2
    return x


def _slot_split(x, m: int, r: int):
    """(..., N) -> (..., m, r): slot i holds a_i[q] = x[q*m + i]."""
    return x.reshape(*x.shape[:-1], r, m).transpose(-1, -2)


def _slot_fold(c, m: int, r: int):
    """(..., 2m, r) slot-domain product -> (..., N): reduce X^m = Y.
    c_i = c'_i + Y * c'_{i+m} for i < m, then out[q*m + i] = c_i[q]."""
    ci = c[..., :m, :] + _neg_shift(c[..., m:, :], 1)       # (..., m, r)
    return ci.transpose(-1, -2).reshape(*c.shape[:-2], m * r)


def _fold_planes(bound: int, plane_bits: int = 7) -> int:
    """Balanced base-2^plane_bits planes that hold values up to ``bound``."""
    planes, mm = 0, bound
    base_half = 1 << (plane_bits - 1)
    while mm:
        mm = (mm + base_half) >> plane_bits
        planes += 1
    return planes


class NussbaumerEngine(_EngineBase):
    """Sub-quadratic integer negacyclic engine (see the module docstring).
    ``cmux_step`` returns None: the blind rotation takes the generic
    step."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.m, self.r = split_mr(cfg.N)
        assert self.m * self.r == cfg.N and self.r >= self.m
        # the digit-side transform sums m rolled slot polys
        self.growth_bound = self.m << (cfg.digit_bits - 1)
        self.planes = _fold_planes(self.growth_bound)

    def prepare(self, key_polys):
        """key (J, U, N) torus -> {"w": (2m, J*r, U*L*r) int8}: k' =
        round(k / 2m), the slot DFT, balanced int8 limbs of khat and of
        -khat (a -128 limb has no int8 negation), dense negacyclic r x r
        blocks in the GEMM layout."""
        cfg, m, r = self.cfg, self.m, self.r
        key_polys = torch.as_tensor(key_polys)
        J, U, N = key_polys.shape
        assert N == cfg.N
        shift = (2 * m).bit_length() - 1                   # log2(2m)
        kp = key_polys.to(torch.int64) + (1 << (shift - 1))
        if cfg.kbits <= 32:
            kp = T.wrap32(kp).to(torch.int64)             # the int32 add wraps
        kp = kp >> shift
        slots = _slot_split(kp, m, r)                      # (J, U, m, r)
        slots = torch.cat([slots, torch.zeros_like(slots)], dim=-2)
        khat = _dft(slots, r // m)                         # (J, U, 2m, r)
        if cfg.kbits <= 32:
            khat = T.wrap32(khat)
        limbs = T.balanced_limbs(khat, cfg.num_limbs, cfg.limb_bits)
        neg = T.wrap32(-khat.to(torch.int64)) if cfg.kbits <= 32 else -khat
        neg_limbs = T.balanced_limbs(neg, cfg.num_limbs, cfg.limb_bits)
        doubled = torch.cat([limbs, neg_limbs], dim=-1)    # (L,J,U,2m,2r)
        ar = torch.arange(r, device=key_polys.device)
        idx = (ar[None, :] - ar[:, None]) % (2 * r)
        mat = doubled[..., idx]                            # (L,J,U,2m,t,i)
        w = mat.permute(3, 1, 4, 2, 0, 5)                  # (2m,J,t,U,L,i)
        return {"w": w.reshape(2 * m, J * r,
                               U * cfg.num_limbs * r).contiguous()}

    def accumulate(self, x, prepared):
        cfg, m, r = self.cfg, self.m, self.r
        w = prepared["w"]
        twoM, Jr, ULr = w.shape
        J, L = Jr // r, cfg.num_limbs
        U = ULr // (L * r)
        x = torch.as_tensor(x)
        lead = x.shape[:-2]
        B = int(np.prod(lead, dtype=np.int64)) if lead else 1
        slots = _slot_split(x.to(torch.int64).reshape(B, J, cfg.N), m, r)
        slots = torch.cat([slots, torch.zeros_like(slots)], dim=-2)
        dhat = _dft(slots, r // m)                         # (B, J, 2m, r)
        planes = T.signed_planes(dhat, 7, self.planes)     # (P, B, J, 2m, r)
        planes = planes.permute(0, 3, 1, 2, 4).reshape(self.planes, twoM, B,
                                                        Jr)
        acc = None
        for p in range(self.planes):
            y = torch.stack([lwe._int8_matmul(planes[p, s].contiguous(), w[s])
                             for s in range(twoM)])         # (2m, B, U*L*r)
            v = y.reshape(twoM, B, U, L, r).movedim(3, 0)  # (L, 2m, B, U, r)
            v = T.recombine_limbs(v, cfg.limb_bits, 64)
            v = v << (7 * p) if p else v
            acc = v if acc is None else acc + v            # (2m, B, U, r)
        c = _dft(acc.movedim(0, -2), -(r // m))            # iDFT, unscaled
        out = _slot_fold(c, m, r).reshape(*lead, U, cfg.N)
        return out if cfg.out_bits == 64 else T.wrap32(out)
