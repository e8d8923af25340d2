"""Leveled LUT evaluation with circuit-bootstrapped TRGSW selectors, as in
``tfhe_tpu.models.lut`` (CGGI17; the composed LUT evaluation circuit
bootstrapping exists for).

A k-bit LUT over torus outputs is evaluated as a CMux tree: 2^k leaf TRLWE
samples (noiseless trivial encodings of the table rows) folded level by
level with the TRGSW-encrypted selector bits.  All 2^(k-1-j) CMuxes of tree
level j run as one batched external product.

A batch of instances, each with its own k selectors, folds its trees
together (``lut_tree``): level j is one ``kernels.lut_cmux`` launch whose
groups are the instances, each contracting its rows against its own
selector j.  ``make_lut_staged`` puts the whole query on the staged path:
the circuit bootstrap's programs A, B and C, then the tree as one more
program (site ``lut.tree``).
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch import graphs, tgsw, tlwe
from tfhe_tpu_torch.boot import circuit
from tfhe_tpu_torch.ops import kernels
from tfhe_tpu_torch.params import CircuitParams, TGswParams
from tfhe_tpu_torch.utils import observability as obs


def pack_table(values, N: int, dtype=torch.int32, device=None):
    """Encode a table as TRLWE leaves: leaf v = noiseless trivial of
    values[v] * X^0 for values (T,) of torus scalars, or of the polynomial
    values[v] for values (T, N) (horizontal packing: up to N outputs a leaf,
    CGGI17's multi-output LUT).  Returns (T, 2, N)."""
    values = torch.as_tensor(values, device=device).to(dtype)
    if values.ndim == 2:
        if values.shape[1] != N:
            raise ValueError(f"pack_table: rows of {values.shape[1]} "
                             f"coefficients, expected N = {N}")
        mu = values
    else:
        mu = torch.zeros((values.shape[0], N), dtype=dtype,
                         device=values.device)
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


def lut_tree(gsw, leaves, p: TGswParams):
    """The CMux trees of G instances at once: gsw (G, k, k+1, l, k+1, N)
    int32, instance g's selectors LSB first; leaves (2^k, k+1, N), shared by
    every instance, or (G, 2^k, k+1, N).  Returns (G, k+1, N): instance g's
    selected TRLWE, ``cmux_tree`` of its selectors bit for bit.  Level j is
    one ``kernels.lut_cmux`` launch, instance g's 2^(k-1-j) rows against
    its own selector j; nothing of a selector is prepared first."""
    if p.tlwe.bits != 32 or p.key_limbs not in (0, 4):
        raise ValueError("lut_tree: the batched tree takes torus32 selectors "
                         "with their exact 4-limb key (key_limbs 0)")
    G, k = gsw.shape[:2]
    if leaves.shape[-3] != 1 << k:
        raise ValueError(f"lut_tree: {leaves.shape[-3]} leaves for {k} "
                         f"selector bits")
    acc = leaves if leaves.ndim == 4 else leaves.expand(G, *leaves.shape)
    for j in range(k):
        acc = kernels.lut_cmux(acc, gsw[:, j], l=p.l, bgbit=p.bgbit,
                               offset=p.offset)
    return acc[:, 0]


def eval_lut_batch(gsw_batch, values, p: TGswParams, backend: str = "matmul"):
    """Batched variant: gsw_batch is a (B, k, k+1, l, k+1, N) tensor of
    circuit-bootstrapped selectors (k bits per instance, LSB first).
    Returns (B, k+1, N) selected TRLWEs (the JAX package vmaps over the
    instances).  The trees run together (``lut_tree``) on every backend:
    every engine's product is exact, so ``backend`` (kept for the JAX
    package's signature) changes no bit."""
    leaves = pack_table(values, p.tlwe.N, _dtype(p), gsw_batch.device)
    return lut_tree(gsw_batch, leaves, p)


def make_lut_staged(p: CircuitParams, backend: str = "chunked",
                    lut_bits: int = 4):
    """fn(samples, key_data, leaves) -> (B // lut_bits, k+1, N1): the
    ``lut_bits``-bit LUT queries of B LWE32 lvl1 bits (instance i's bits,
    LSB first, are samples i*lut_bits .. i*lut_bits + lut_bits - 1), each
    folded over ``leaves`` (2^lut_bits, k+1, N1), ``pack_table`` of the
    table.  The circuit bootstrap runs as
    ``circuit.make_circuit_bootstrap_staged``'s programs A, B and C, then
    ``lut_tree`` as one more program (``graphs.run`` site ``lut.tree``, the
    leaves a key it reads): on the card, one captured CUDA graph replayed
    on later calls.

    A call is the span ``lut.eval``, whose children are the circuit
    bootstrap's ``circuit.bootstrap`` and the tree's ``graph.lut.tree``; it
    counts ``lut.launches``, ``lut.instances`` and ``lut.cmux_rows``
    (instances * (2^lut_bits - 1)) outside the programs."""
    cb = circuit.make_circuit_bootstrap_staged(p, backend)
    q = p.tgsw_lvl1

    def fn(samples, key_data, leaves):
        B = samples.shape[0]
        if B % lut_bits or tuple(leaves.shape) != (1 << lut_bits, q.tlwe.k
                                                   + 1, q.tlwe.N):
            raise ValueError(f"make_lut_staged: {B} samples and leaves "
                             f"{tuple(leaves.shape)} for {lut_bits}-bit LUTs")
        inst = B // lut_bits
        obs.count("lut.launches")
        obs.count("lut.instances", inst)
        obs.count("lut.cmux_rows", inst * ((1 << lut_bits) - 1))
        with obs.span("lut.eval"):
            gsw = cb(samples, key_data)
            gsw = gsw.reshape(inst, lut_bits, *gsw.shape[1:])
            return graphs.run("lut.tree", (q, lut_bits),
                              lambda g: lut_tree(g, leaves, q), (gsw,),
                              (leaves,))
    return fn
