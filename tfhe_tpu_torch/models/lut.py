"""Leveled LUT evaluation with circuit-bootstrapped TRGSW selectors, as in
``tfhe_tpu.models.lut`` (CGGI17; the composed LUT evaluation circuit
bootstrapping exists for).

A k-bit LUT over torus outputs is evaluated as a CMux tree: 2^k leaf TRLWE
samples (noiseless trivial encodings of the table rows) folded level by
level with the TRGSW-encrypted selector bits.  All 2^(k-1-j) CMuxes of tree
level j run as one batched external product.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import tgsw, tlwe
from tfhe_tpu_torch.params import TGswParams


def pack_table(values, N: int, dtype=torch.int32, device=None):
    """Encode a table of torus scalars as constant-coefficient TRLWE leaves:
    leaf v = noiseless trivial of values[v] * X^0.  values: (T,)."""
    values = torch.as_tensor(values, device=device).to(dtype)
    mu = torch.zeros((values.shape[0], N), dtype=dtype, device=values.device)
    mu[:, 0] = values
    return tlwe.noiseless_trivial_poly(mu, 1)            # (T, 2, N)


def cmux_tree(selectors, leaves, p: TGswParams, backend: str = "matmul"):
    """selectors: list of k prepared TRGSWs (LSB first, from tgsw.prepare);
    leaves: (2^k, k+1, N).  Returns the selected TRLWE.  Level j folds pairs
    (even = bit 0, odd = bit 1) with selector j, batched."""
    acc = leaves
    for prep in selectors:
        acc = tgsw.cmux(prep, acc[1::2], acc[0::2], p, backend)
    return acc[0]


def _dtype(p: TGswParams):
    return torch.int32 if p.tlwe.bits == 32 else torch.int64


def eval_lut(selectors, values, p: TGswParams, backend: str = "matmul"):
    """Evaluate a k-bit -> torus LUT under encrypted selector bits.
    values: (2^k,) torus scalars.  Returns a TRLWE whose coefficient-0 phase
    is values[index]."""
    dev = next(iter(selectors[0].values())).device
    leaves = pack_table(values, p.tlwe.N, _dtype(p), dev)
    return cmux_tree(selectors, leaves, p, backend)


def eval_lut_batch(gsw_batch, values, p: TGswParams, backend: str = "matmul"):
    """Batched variant: gsw_batch is a (B, k, k+1, l, k+1, N) tensor of
    circuit-bootstrapped selectors (k bits per instance, LSB first).
    Returns (B, k+1, N) selected TRLWEs.  The JAX package vmaps over the
    instances; here they run one after another (each has its own keys)."""
    B, k = gsw_batch.shape[0], gsw_batch.shape[1]
    eng = tgsw.make_engine(tgsw.engine_config(p), backend)
    leaves = pack_table(values, p.tlwe.N, _dtype(p), gsw_batch.device)
    outs = []
    for b in range(B):
        sels = [eng.prepare(tgsw.rows(gsw_batch[b, j])) for j in range(k)]
        outs.append(cmux_tree(sels, leaves, p, backend))
    return torch.stack(outs)
