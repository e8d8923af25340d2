"""Blind rotation — the bootstrap hot loop (tfhe_blindRotate_FFT,
lwe_functions.cpp:337-357), as in ``tfhe_tpu.boot.blind_rotate``.

The n sequential CMux steps are a Python loop; the whole ciphertext batch
advances through each step together, so every step is one large int8
tensor-core contraction.  Each step takes, in order:

  * the engine's own step (``engine.cmux_step``) when it has one for these
    parameters: on the onthefly and matmul engines at 32 bits the fused
    step (materialize the step's key, then one ``fused_cmux_step_v2``
    kernel: one digit plane, bgbit <= 8, at most 3 key limbs); on the
    chunked engine at 32 bits one ``ck_cmux_step32`` kernel (one digit
    plane, bgbit <= 8); on the chunked engine at 64 bits
    ``rotate_decompose64_ck`` + ``ck_dot64p`` + an int64 epilogue, with the
    Torus64 accumulator carried natively as (B, k+1, N) int64;
  * else the generic step: ``rotate_decompose`` (32 bits, bgbit <= 8) or the
    plain rotate + decompose, then ``engine.accumulate_into``
    (the K-packed key, ``materialize_wt`` or the matmul engine's dense key
    transposed, + ``mm_recombine_acc_wt`` on the onthefly, matmul and conv
    engines at 32 bits; on the conv engine at 64 bits ``materialize_wt``
    and one int8 GEMM a limb and digit plane; the Nussbaumer and FFT
    engines' own products).  The conv, Nussbaumer and FFT engines have no step of
    their own and take it on both devices; the chunked engine's 64-bit
    generic step is plain torch code and serves only the CPU.

At 64 bits two environment variables select the JAX package's opt-in
steps, with its precedence: ``TFHE_CK64_PATH`` first (``acc``: the chunked
engine's fused-epilogue step, ``rotate_decompose64_ck_flat`` +
``ck_dot64p_acc``; ``sacc``: the same with the limb axis in the grid,
``rotate_decompose64_ck_flat`` + ``ck_dot64p_sacc``), then
``TFHE_CK64_FUSED`` when set and not ``"0"`` (the whole step in one
``ck_cmux_step64`` kernel), then the default step.  The loop carries the
accumulator as (B, k+1, N) on every step; the opt-in steps take its flat
view, (B, (k+1)*N) int64, the JAX package's layout (the tensor is
contiguous, so the view copies nothing).  None falls back to another step:
a selected step that does not apply raises.

The decision is the same on the CPU and on the GPU; only the kernel
wrappers choose between a plain version and a kernel.

On the card ``blind_rotate`` runs the whole n-step loop as one captured
CUDA graph (``graphs.run``, the counterpart of the JAX package's
``lax.scan``), replayed on later calls with the same shapes, parameters,
step knobs and key tensors; inside an outer program (``make_bootstrap_fn``,
the circuit stages, the scheduler's waves) the loop is recorded into that
program instead.  ``rotate_steps``, which yields after every step (the
decrypt probes), stays eager.
"""

from __future__ import annotations

import functools
import os

from tfhe_tpu_torch import graphs, tgsw, tlwe
from tfhe_tpu_torch.params import TGswParams
from tfhe_tpu_torch.ops import kernels, poly
from tfhe_tpu_torch.ops.decomp import decompose_tlwe
from tfhe_tpu_torch.ops.engine import (ChunkedEngine, make_engine,
                                       step_prepared)


_CK64_STEPS = {"acc": "cmux_step_acc", "sacc": "cmux_step_sacc",
               "fused": "cmux_step_flat"}


def _ck64_path(eng, p: TGswParams, backend: str) -> str:
    """The 64-bit step chosen by the environment, in the JAX package's
    order: TFHE_CK64_PATH ("acc" or "sacc"), then TFHE_CK64_FUSED ("fused"),
    else "" (the default step)."""
    if p.tlwe.bits != 64:
        return ""
    path = os.environ.get("TFHE_CK64_PATH", "")
    if path:
        if path not in ("acc", "sacc"):
            raise ValueError(f"unknown TFHE_CK64_PATH {path!r}: '', 'acc' or "
                             f"'sacc'")
        what = f"TFHE_CK64_PATH={path}"
    elif os.environ.get("TFHE_CK64_FUSED", "") not in ("", "0"):
        path, what = "fused", "TFHE_CK64_FUSED"
    else:
        return ""
    if not hasattr(eng, _CK64_STEPS[path]):
        raise ValueError(f"{what} runs on the 'chunked' backend, not "
                         f"{backend!r}")
    return path


def cmux_step(eng, a, acc, prep, p: TGswParams, path: str = ""):
    """One CMux step of the loop: acc + (X^a - 1) acc (x) TRGSW on the
    (B, k+1, N) accumulator.  ``path`` is the 64-bit opt-in step that
    ``_ck64_path`` chose: its engine method runs on acc's flat view and
    raises where it does not apply.  Else the engine's own step where it
    has one, else the generic step."""
    if path:
        B, kp1, N = acc.shape
        out = getattr(eng, _CK64_STEPS[path])(
            a, acc.reshape(B, kp1 * N), prep, kp1=kp1, l=p.l, bgbit=p.bgbit,
            offset=p.offset)
        if out is None:
            raise ValueError(f"the 64-bit {path} step does not apply to "
                             f"these parameters")
        return out.view(B, kp1, N)
    fused = eng.cmux_step(a, acc, prep, l=p.l, bgbit=p.bgbit,
                          offset=p.offset)
    if fused is not None:
        return fused
    if (p.tlwe.bits == 64 and acc.device.type != "cpu"
            and isinstance(eng, ChunkedEngine)):
        raise ValueError(
            "no 64-bit step for the card takes these parameters: the 64-bit "
            "blind rotation runs on the 'chunked' backend, in its kernels' "
            "domain (kernels.ck64_kernel_ok and rotdec_ok, or "
            "ck_cmux_step64_ok for TFHE_CK64_FUSED)")
    return eng.accumulate_into(acc, generic_digits(a, acc, p), prep)


def generic_digits(a, acc, p: TGswParams):
    """The generic step's digits (B, kpl, N) of (X^a - 1) * acc:
    ``rotate_decompose`` at 32 bits with bgbit <= 8, else the plain rotate
    + decompose."""
    if p.tlwe.bits == 32 and p.bgbit <= 8:
        return kernels.rotate_decompose(a, acc, l=p.l, bgbit=p.bgbit,
                                        offset=p.offset)
    return decompose_tlwe(tlwe.mul_by_xai_minus_one(a, acc), p)


def rotate_steps(acc, bk_prepared, abar, p: TGswParams,
                 backend: str = "matmul"):
    """Run the n-step CMux loop, yielding (i, a_i, acc) after every step
    (acc as (B, k+1, N)); ``blind_rotate`` and the decrypt probes
    (``boot.probe``) share it, so both take the same dispatch."""
    eng = make_engine(tgsw.engine_config(p), backend)
    steps = abar.t().contiguous()                     # (n, B): rows contiguous
    path = _ck64_path(eng, p, backend)
    # the default step keeps cmux_step's five-argument call, which the
    # benchmark's planted-fault tests replace
    step = functools.partial(cmux_step, path=path) if path else cmux_step
    for i in range(steps.shape[0]):
        prep_i = step_prepared(bk_prepared, i)
        acc = step(eng, steps[i], acc, prep_i, p)
        yield i, steps[i], acc


def blind_rotate(acc, bk_prepared, abar, p: TGswParams,
                 backend: str = "matmul"):
    """Run the n-step CMux loop.

    acc:         (B, k+1, N) int32 or int64 accumulator (noiseless test
                 vector).
    bk_prepared: dict of tensors, or of tuples of tensors (the dd FFT
                 key), with leading axis n (the engine-prepared TRGSW of
                 every small-LWE key bit).
    abar:        (B, n) int32 rotation exponents in [0, 2N).
    Returns the rotated accumulator (B, k+1, N).
    """
    def loop(acc, abar):
        for _, _, acc in rotate_steps(acc, bk_prepared, abar, p, backend):
            pass
        return acc
    return graphs.run("blind_rotate", (p, backend), loop, (acc, abar),
                      graphs.leaves(bk_prepared), backend=backend)


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
