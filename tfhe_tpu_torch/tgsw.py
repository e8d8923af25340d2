"""Batched TRGSW, as in ``tfhe_tpu.tgsw`` (tgsw_functions.cpp:15-449).

Layout: a TRGSW batch is (..., k+1, l, k+1, N): rows indexed (bloc, level),
each row a TRLWE sample.  The external product consumes the rows through a
negacyclic engine (``ops.engine``): decompose -> one int8 contraction ->
recombine.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch import tlwe as tlwe_mod
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.params import TGswParams
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.ops.decomp import decompose_tlwe
from tfhe_tpu_torch.ops.engine import EngineConfig, make_engine


def engine_config(p: TGswParams) -> EngineConfig:
    return EngineConfig(N=p.tlwe.N, out_bits=p.tlwe.bits, digit_bits=p.bgbit,
                        key_limbs=p.key_limbs)


def encrypt(key: tlwe_mod.TLweKey, messages, p: TGswParams, rng: TfheRng,
            stdev=None, device=None):
    """TRGSW(m): (k+1) x l TLWE(0) rows + m * h_i on the diagonal bloc
    (tGswSymEncrypt).  messages: (...,) small ints.  Returns
    (..., k+1, l, k+1, N) on ``device``, int32 or int64 by the torus width.

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
    dev = _device.resolve(device)
    c = tlwe_mod.encrypt_zero(key, rng, tuple(messages.shape) + (k + 1, l),
                              stdev, coarse_bits=coarse, device=dev)
    h = torch.tensor([T.signed64(v) for v in p.h], dtype=torch.int64,
                     device=dev)                                   # (l,)
    add = torch.from_numpy(messages.astype(np.int64)).to(dev)[..., None] * h
    c = c.to(torch.int64)
    for bloc in range(k + 1):
        c[..., bloc, :, bloc, 0] += add                  # wraps mod 2^64
    return c if p.tlwe.bits == 64 else T.wrap32(c)


def rows(gsw):
    """(..., k+1, l, k+1, N) -> (..., kpl, k+1, N), row-major over
    (bloc, level)."""
    s = gsw.shape
    return gsw.reshape(*s[:-4], s[-4] * s[-3], s[-2], s[-1])


def prepare(gsw, p: TGswParams, backend: str = "matmul"):
    """Preprocess one TRGSW (k+1, l, k+1, N) into engine form.  Returns
    (engine, prepared)."""
    eng = make_engine(engine_config(p), backend)
    return eng, eng.prepare(rows(gsw))


def external_product(tlwe_av, prepared, p: TGswParams, backend: str = "matmul"):
    """TRGSW (x) TRLWE -> TRLWE: decompose the sample and contract it with
    the prepared TRGSW rows (tGswFFTExternMulToTLwe,
    tgsw_functions.cpp:424).  tlwe_av: (..., k+1, N)."""
    eng = make_engine(engine_config(p), backend)
    return eng.accumulate(decompose_tlwe(tlwe_av, p), prepared)


def cmux(prepared, d1, d0, p: TGswParams, backend: str = "matmul"):
    """CMux(c, d1, d0) = d0 + c (x) (d1 - d0): d1 when the TRGSW bit is 1,
    d0 when 0 (lwe_functions.cpp:322-328)."""
    return T.add(d0, external_product(T.sub(d1, d0), prepared, p, backend))


def tgsw_phase(gsw, key: tlwe_mod.TLweKey):
    """Phase of every TRGSW row (for tests and the decrypt probes)."""
    return tlwe_mod.tlwe_phase(gsw, key)
