"""Batched TRGSW, as in ``tfhe_tpu.tgsw`` (tgsw_functions.cpp:15-449).

Layout: a TRGSW batch is (..., k+1, l, k+1, N): rows indexed (bloc, level),
each row a TRLWE sample.  The external product consumes the rows through a
negacyclic engine (``ops.engine``).
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import tlwe as tlwe_mod
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.params import TGswParams
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.ops.engine import EngineConfig


def engine_config(p: TGswParams) -> EngineConfig:
    return EngineConfig(N=p.tlwe.N, out_bits=p.tlwe.bits, digit_bits=p.bgbit,
                        key_limbs=p.key_limbs)


def encrypt(key: tlwe_mod.TLweKey, messages, p: TGswParams, rng: TfheRng,
            stdev=None, device=None):
    """TRGSW(m): (k+1) x l TLWE(0) rows + m * h_i on the diagonal bloc
    (tGswSymEncrypt).  messages: (...,) small ints.  Returns
    (..., k+1, l, k+1, N) int32 on ``device``.

    With p.key_limbs set, rows are generated on the coarse lattice
    (tlwe.encrypt_zero coarse_bits) so the engines' limb truncation is
    exact; the gadget entries are multiples of the lattice spacing."""
    messages = np.asarray(messages)
    k, l = p.tlwe.k, p.l
    coarse = 0
    if p.key_limbs:
        coarse = p.tlwe.bits - 8 * p.key_limbs
        assert coarse <= p.tlwe.bits - p.l * p.bgbit, (
            "coarse lattice must contain the gadget entries")
    c = tlwe_mod.encrypt_zero(key, rng, tuple(messages.shape) + (k + 1, l),
                              stdev, coarse_bits=coarse, device="cpu")
    h = torch.tensor(p.h, dtype=torch.int64)                     # (l,)
    add = torch.from_numpy(messages.astype(np.int64))[..., None] * h
    c = c.to(torch.int64)
    for bloc in range(k + 1):
        c[..., bloc, :, bloc, 0] += add
    return T.wrap32(c).to(_device.resolve(device))


def rows(gsw):
    """(..., k+1, l, k+1, N) -> (..., kpl, k+1, N), row-major over
    (bloc, level)."""
    s = gsw.shape
    return gsw.reshape(*s[:-4], s[-4] * s[-3], s[-2], s[-1])
