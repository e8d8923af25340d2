"""The port's native oracle (tfhe_tpu_torch.utils.native, its own g++ build
of native/tfhe_native.cpp into the port's build directory) on the cases of
tests/test_native.py, against the JAX package's functions and the port's
own FFT, with exact equality where both sides are exact."""

import numpy as np
import jax.numpy as jnp
import torch

from tfhe_tpu.ops import fft as jfft, poly as jpoly
from tfhe_tpu.ops.decomp import decompose_torus_poly
from tfhe_tpu.params import TGswParams, TLweParams
from tfhe_tpu_torch.ops import _build, fft
from tfhe_tpu_torch.utils import native


def test_builds_into_the_port_build_dir():
    lib = native.load()
    assert str(_build.BUILD_DIR) in lib._name
    assert "libtfhe_native.so" not in lib._name


def test_negacyclic_mul32_matches_jax():
    rng = np.random.default_rng(0)
    N = 128
    a = rng.integers(-128, 128, N).astype(np.int32)
    b = rng.integers(-2**31, 2**31, N).astype(np.int32)
    got = native.negacyclic_mul32(a, b)
    want = np.asarray(jpoly.negacyclic_mul_exact(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert np.array_equal(got, want)


def test_negacyclic_mul64_matches_jax():
    rng = np.random.default_rng(1)
    N = 64
    a = rng.integers(-256, 256, N).astype(np.int32)
    b = rng.integers(0, 2**64, N, dtype=np.uint64).astype(np.int64)
    got = native.negacyclic_mul64(a, b)
    want = np.asarray(jpoly.negacyclic_mul_exact(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert np.array_equal(got, want)


def test_anticyclic_fft_matches_python():
    rng = np.random.default_rng(2)
    N = 256
    a = rng.integers(-2**20, 2**20, N).astype(np.int32)
    re, im = native.anticyclic_fft(a)
    for ref in (np.asarray(jfft.negacyclic_fft(a.astype(np.float64),
                                               precision="highest")),
                fft.negacyclic_fft(torch.from_numpy(a),
                                   precision="highest").numpy()):
        assert np.allclose(re, ref.real, rtol=1e-9, atol=1e-3)
        assert np.allclose(im, ref.imag, rtol=1e-9, atol=1e-3)


def _fft_product(a, b):
    are, aim = native.anticyclic_fft(a)
    bre, bim = native.anticyclic_fft(b)
    return native.anticyclic_ifft_t64(are * bre - aim * bim,
                                      are * bim + aim * bre)


def test_fft_product_exact_at_small_scale():
    rng = np.random.default_rng(3)
    N = 1024
    a = rng.integers(-256, 256, N).astype(np.int32)
    b = rng.integers(-2**12, 2**12, N).astype(np.int64)
    want = np.asarray(jpoly.negacyclic_mul_exact(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert np.array_equal(_fft_product(a, b), want)


def test_fft_product_error_bounded_like_reference():
    rng = np.random.default_rng(3)
    N = 1024
    a = rng.integers(-256, 256, N).astype(np.int32)
    b = rng.integers(-2**20, 2**20, N).astype(np.int64)
    want = np.asarray(jpoly.negacyclic_mul_exact(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert np.abs(_fft_product(a, b) - want).max() < 2**12


def test_decompose64_matches_jax():
    p = TGswParams(l=4, bgbit=9, tlwe=TLweParams(N=64, k=1, bits=64))
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2**64, 64, dtype=np.uint64).astype(np.int64)
    got = native.decompose64(x, p.l, p.bgbit, p.offset)
    want = np.asarray(decompose_torus_poly(jnp.asarray(x), p))
    assert np.array_equal(got, np.moveaxis(want, -2, 0))
