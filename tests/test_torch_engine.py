"""The port's torus, poly, decomp and engine layers against tfhe_tpu's, bit
for bit, on the same numpy inputs (CPU).  Includes the edge probes of the
engines: INT32_MIN keys and +-half_bg digits (the balanced-limb negation
edge).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import torus as jT
from tfhe_tpu.ops import poly as jpoly, decomp as jdecomp
from tfhe_tpu.ops import engine as jeng
from tfhe_tpu.params import GATE_DEFAULT, GATE_FAST2, TGswParams, TLweParams
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.ops import poly, decomp, engine

I32_EDGES = np.array([-2**31, 2**31 - 1, 0, -1, 1, 2**30, -2**30],
                     np.int32)


def _i32(r, shape):
    x = r.integers(-2**31, 2**31, shape).astype(np.int32)
    flat = x.reshape(-1)
    flat[:len(I32_EDGES)] = I32_EDGES[:flat.size]
    return x


def _same(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# torus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("msize", [1024, 2048, 8, 1000])
def test_mod_switch_and_approx_phase(msize):
    x = _i32(np.random.default_rng(0), (512,))
    _same(T.mod_switch_from_torus32(torch.from_numpy(x), msize),
          jT.mod_switch_from_torus32(jnp.asarray(x), msize))
    _same(T.approx_phase32(torch.from_numpy(x), msize),
          jT.approx_phase32(jnp.asarray(x), msize))


@pytest.mark.parametrize("num_limbs", [4, 3, 1])
def test_balanced_limbs_and_recombine(num_limbs):
    x = _i32(np.random.default_rng(1), (64, 7))
    limbs = T.balanced_limbs(torch.from_numpy(x), num_limbs)
    _same(limbs, jT.balanced_limbs(jnp.asarray(x), num_limbs))
    parts = np.random.default_rng(2).integers(-2**20, 2**20, (num_limbs, 33)
                                              ).astype(np.int32)
    _same(T.recombine_limbs(torch.from_numpy(parts), 8),
          jT.recombine_limbs(jnp.asarray(parts), 8, jnp.int32))


def test_signed_planes():
    d = np.random.default_rng(3).integers(-2**31, 2**31, (100,)).astype(np.int64)
    _same(T.signed_planes(torch.from_numpy(d), 7, 5),
          jT.signed_planes(jnp.asarray(d), 7, 5))


# ---------------------------------------------------------------------------
# poly and decomp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [0, 5, 64, 64 + 3, 127])
def test_negacyclic_shift(r):
    x = _i32(np.random.default_rng(4), (3, 64))
    _same(poly.negacyclic_shift(torch.from_numpy(x), r),
          jpoly.negacyclic_shift(jnp.asarray(x), r))


def test_mul_by_xai_and_minus_one():
    r = np.random.default_rng(5)
    N, B = 64, 9
    x = _i32(r, (B, 3, N))
    p = r.integers(0, 2 * N, (B,)).astype(np.int32)
    p[:4] = [0, N, 2 * N - 1, N - 1]
    _same(poly.mul_by_xai(torch.from_numpy(p), torch.from_numpy(x)),
          jpoly.mul_by_xai(jnp.asarray(p), jnp.asarray(x)))
    _same(poly.mul_by_xai_minus_one(torch.from_numpy(p), torch.from_numpy(x)),
          jpoly.mul_by_xai_minus_one(jnp.asarray(p), jnp.asarray(x)))


@pytest.mark.parametrize("index", [0, 5, 63])
def test_negacyclic_matrix_and_sample_extract(index):
    x = _i32(np.random.default_rng(6), (4, 3, 64))
    _same(poly.negacyclic_matrix(torch.from_numpy(x[0, 0])),
          jpoly.negacyclic_matrix(jnp.asarray(x[0, 0])))
    _same(poly.sample_extract(torch.from_numpy(x), index),
          jpoly.sample_extract(jnp.asarray(x), index))


@pytest.mark.parametrize("tgsw", [GATE_DEFAULT.tgsw, GATE_FAST2.tgsw,
                                  TGswParams(l=2, bgbit=8,
                                             tlwe=TLweParams(N=64, k=1))])
def test_decompose(tgsw):
    x = _i32(np.random.default_rng(7), (5, tgsw.tlwe.k + 1, tgsw.tlwe.N))
    _same(decomp.decompose_torus_poly(torch.from_numpy(x), tgsw),
          jdecomp.decompose_torus_poly(jnp.asarray(x), tgsw))
    _same(decomp.decompose_tlwe(torch.from_numpy(x), tgsw),
          jdecomp.decompose_tlwe(jnp.asarray(x), tgsw))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _engine_inputs(seed, J, U, N, digit_bits):
    r = np.random.default_rng(seed)
    key = _i32(r, (J, U, N))
    key[0, 0, :4] = -2**31                   # the negation edge of limbs
    half = 1 << (digit_bits - 1)
    x = r.integers(-half, half + 1, (6, J, N)).astype(np.int32)
    x[0, :, :2] = [-half, half]              # +-half_bg digits
    acc = _i32(r, (6, U, N))
    return key, x, acc


@pytest.mark.parametrize("backend", ["naive", "matmul", "onthefly"])
@pytest.mark.parametrize("key_limbs", [0, 3])
def test_engine_matches_jax(backend, key_limbs):
    N, J, U = 64, 6, 3
    cfg_kw = dict(N=N, out_bits=32, digit_bits=7, key_limbs=key_limbs)
    key, x, acc = _engine_inputs(8, J, U, N, 7)
    je = jeng.make_engine(jeng.EngineConfig(**cfg_kw), backend)
    te = engine.make_engine(engine.EngineConfig(**cfg_kw), backend)
    jprep = je.prepare(jnp.asarray(key))
    tprep = te.prepare(torch.from_numpy(key))
    assert set(tprep) == set(jprep)
    for name in jprep:
        _same(tprep[name], jprep[name])
    want = je.accumulate(jnp.asarray(x), jprep)
    _same(te.accumulate(torch.from_numpy(x), tprep), want)
    _same(te.accumulate_into(torch.from_numpy(acc), torch.from_numpy(x),
                             tprep),
          jnp.asarray(acc) + want)


@pytest.mark.parametrize("backend", ["naive", "matmul", "onthefly"])
def test_engine_wide_digits_match_jax(backend):
    """Full-width torus operands against a small key (the TRLWE key-product
    engine): five base-2^7 digit planes, each folded through the kernel
    wrapper with its own shift."""
    N = 64
    cfg_kw = dict(N=N, out_bits=32, digit_bits=32, key_bits=8)
    r = np.random.default_rng(9)
    key = r.integers(0, 2, (2, 1, N)).astype(np.int32)
    x = _i32(r, (5, 2, N))
    je = jeng.make_engine(jeng.EngineConfig(**cfg_kw), backend)
    te = engine.make_engine(engine.EngineConfig(**cfg_kw), backend)
    want = je.accumulate(jnp.asarray(x), je.prepare(jnp.asarray(key)))
    got = te.accumulate(torch.from_numpy(x), te.prepare(torch.from_numpy(key)))
    _same(got, want)


def test_cmux_step_matches_jax_generic_step():
    """The port's fused step (plain on the CPU) equals the JAX package's
    CPU step: acc + accumulate(decompose((X^a - 1) acc))."""
    p = TGswParams(l=3, bgbit=7, key_limbs=3, tlwe=TLweParams(N=64, k=2))
    cfg = jeng.EngineConfig(N=64, out_bits=32, digit_bits=7, key_limbs=3)
    r = np.random.default_rng(10)
    J, U = 9, 3
    key = _i32(r, (J, U, 64))
    acc = _i32(r, (8, U, 64))
    a = r.integers(0, 128, (8,)).astype(np.int32)
    je = jeng.make_engine(cfg, "onthefly")
    jprep = je.prepare(jnp.asarray(key))
    digits = jdecomp.decompose_tlwe(
        jpoly.mul_by_xai_minus_one(jnp.asarray(a), jnp.asarray(acc)), p)
    want = je.accumulate_into(jnp.asarray(acc), digits, jprep)
    for backend in ("matmul", "onthefly"):
        te = engine.make_engine(
            engine.EngineConfig(**dataclasses.asdict(cfg)), backend)
        got = te.cmux_step(torch.from_numpy(a), torch.from_numpy(acc),
                           te.prepare(torch.from_numpy(key)), l=p.l,
                           bgbit=p.bgbit, offset=p.offset)
        _same(got, want)


def test_unported_backend_names_its_slice():
    """No backend is left unported: every name the JAX package's
    make_engine takes builds in the port, and an unknown name raises
    ValueError."""
    cfg = engine.EngineConfig(N=64, out_bits=32, digit_bits=7)
    for backend in ("naive", "matmul", "onthefly", "chunked", "conv",
                    "conv_bf16", "nussbaumer", "fft", "fft_dd", "fft_f64"):
        assert jeng.make_engine(jeng.EngineConfig(N=64, out_bits=32,
                                                  digit_bits=7), backend)
        assert engine.make_engine(cfg, backend).cfg == cfg
    with pytest.raises(ValueError):
        engine.make_engine(cfg, "no-such-backend")
