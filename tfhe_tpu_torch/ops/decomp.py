"""Gadget (signed base-2^bgbit) decomposition, batched and branch-free.

The 32-bit variant mirrors tGswTorus32PolynomialDecompH
(tgsw_functions.cpp:224-335); the 64-bit variant mirrors
tGswTorus64PolynomialDecompH (poc_CircuitBootstrapping.cpp:492-515).  At 32
bits the uint32 offset add is carried in int64 and masked (see ``torus``); at
64 bits the int64 add wraps like uint64 and every digit's bits lie below bit
64, so the arithmetic right shift followed by the digit mask is exact.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.params import TGswParams


def decompose_torus_poly(x, p: TGswParams):
    """Decompose torus polynomials (..., N) into l signed digit polynomials.

    Returns (..., l, N) int32 digits in [-half_bg, half_bg)."""
    bits = p.tlwe.bits
    if bits == 32:
        buf = (T.u32(x) + p.offset) & T.MASK32
    else:
        buf = torch.as_tensor(x).to(torch.int64) + T.signed64(p.offset)
    digs = [((buf >> (bits - (i + 1) * p.bgbit)) & p.mask_mod) - p.half_bg
            for i in range(p.l)]
    return torch.stack(digs, dim=-2).to(torch.int32)


def decompose_tlwe(tlwe_av, p: TGswParams):
    """Decompose a TRLWE sample (..., k+1, N) into (..., kpl, N) digit rows,
    row-major over (poly index, gadget level)."""
    d = decompose_torus_poly(tlwe_av, p)          # (..., k+1, l, N)
    return d.reshape(*d.shape[:-3], p.kpl, d.shape[-1])
