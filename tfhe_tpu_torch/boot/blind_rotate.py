"""Blind rotation — the bootstrap hot loop (tfhe_blindRotate_FFT,
lwe_functions.cpp:337-357), as in ``tfhe_tpu.boot.blind_rotate``.

The n sequential CMux steps are a Python loop; the whole ciphertext batch
advances through each step together, so every step is one large int8
tensor-core contraction.  Each step takes, in order:

  * the engine's own step (``engine.cmux_step``) when it has one for these
    parameters: at 32 bits the fused step (materialize the step's key, then
    one ``fused_cmux_step_v2`` kernel: one digit plane, bgbit <= 8, at most
    3 key limbs); at 64 bits the chunked engine's step
    (``rotate_decompose64_ck`` + ``ck_dot64p`` + an int64 epilogue), with
    the Torus64 accumulator carried natively as (B, k+1, N) int64;
  * else the generic step: ``rotate_decompose`` (32 bits, bgbit <= 8) or the
    plain rotate + decompose, then ``engine.accumulate_into``
    (``materialize_w`` + ``mm_recombine_acc`` on the onthefly engine).  At
    64 bits the generic step is plain torch code and serves only the CPU.

The decision is the same on the CPU and on the GPU; only the kernel
wrappers choose between a plain version and a kernel.
"""

from __future__ import annotations

from tfhe_tpu_torch import tgsw, tlwe
from tfhe_tpu_torch.params import TGswParams
from tfhe_tpu_torch.ops import kernels, poly
from tfhe_tpu_torch.ops.decomp import decompose_tlwe
from tfhe_tpu_torch.ops.engine import make_engine


def blind_rotate(acc, bk_prepared, abar, p: TGswParams,
                 backend: str = "matmul"):
    """Run the n-step CMux loop.

    acc:         (B, k+1, N) int32 or int64 accumulator (noiseless test
                 vector).
    bk_prepared: dict of tensors with leading axis n (the engine-prepared
                 TRGSW of every small-LWE key bit).
    abar:        (B, n) int32 rotation exponents in [0, 2N).
    Returns the rotated accumulator (B, k+1, N).
    """
    eng = make_engine(tgsw.engine_config(p), backend)
    steps = abar.t().contiguous()                     # (n, B): rows contiguous
    for i in range(steps.shape[0]):
        prep_i = {name: t[i] for name, t in bk_prepared.items()}
        a_i = steps[i]
        fused = eng.cmux_step(a_i, acc, prep_i, l=p.l, bgbit=p.bgbit,
                              offset=p.offset)
        if fused is not None:
            acc = fused
            continue
        if p.tlwe.bits == 64 and acc.device.type != "cpu":
            raise ValueError(
                f"backend {backend!r} has no 64-bit step for the card; the "
                f"64-bit blind rotation runs on the 'chunked' backend")
        if p.tlwe.bits == 32 and p.bgbit <= 8:
            digits = kernels.rotate_decompose(a_i, acc, l=p.l, bgbit=p.bgbit,
                                              offset=p.offset)
        else:
            digits = decompose_tlwe(tlwe.mul_by_xai_minus_one(a_i, acc), p)
        acc = eng.accumulate_into(acc, digits, prep_i)
    return acc


def rotate_and_extract(testvect, bk_prepared, barb, bara, p: TGswParams,
                       backend: str = "matmul"):
    """testvector * X^{2N - barb}, blind-rotate by bara, extract coefficient 0
    (tfhe_blindRotateAndExtract_FFT, lwe_functions.cpp:366-393).

    testvect: (N,) or (B, N); barb: (B,); bara: (B, n).
    Returns LWE batch (B, k*N + 1)."""
    N = p.tlwe.N
    tv = testvect
    if tv.ndim == 1:
        tv = tv.expand(barb.shape[0], N)
    tv = poly.mul_by_xai((2 * N - barb) % (2 * N), tv)
    acc = tlwe.noiseless_trivial_poly(tv, p.tlwe.k)
    acc = blind_rotate(acc, bk_prepared, bara, p, backend)
    return tlwe.extract_lwe(acc, 0)
