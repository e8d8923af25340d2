"""The port's FFT module (tfhe_tpu_torch.ops.fft) and its polynomial FFT
products against tfhe_tpu's, on the CPU: the cases of tests/test_fft.py
(the c128 round trip, the FFT product against the exact negacyclic
product, the twiddles, dd arithmetic below 2^-44, the dd FFT round trip),
the spqlios layout round trip at atol=0, and poly.mul_fft / add_mul_fft /
sub_mul_fft against JAX's on the same numpy inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.ops import fft as jfft, poly as jpoly
from tfhe_tpu_torch.ops import fft, poly


def _exact(a, b):
    return np.asarray(jpoly.negacyclic_mul_exact(
        jnp.asarray(a, jnp.int32), jnp.asarray(b)))


def test_roundtrip_c128():
    N = 128
    a = np.random.default_rng(0).integers(-2**20, 2**20,
                                          (3, N)).astype(np.float64)
    ahat = fft.negacyclic_fft(torch.from_numpy(a), precision="highest")
    assert ahat.dtype == torch.complex128
    back = fft.negacyclic_ifft(ahat, N).numpy()
    assert np.abs(back - a).max() < 1e-6
    want = np.asarray(jfft.negacyclic_fft(a, precision="highest"))
    np.testing.assert_allclose(ahat.numpy(), want,
                               atol=1e-12 * np.abs(want).max())


def test_fft_product_matches_negacyclic():
    N = 64
    rng = np.random.default_rng(1)
    a = rng.integers(-64, 64, N).astype(np.float64)
    b = rng.integers(-2**18, 2**18, N).astype(np.float64)
    ah = fft.negacyclic_fft(torch.from_numpy(a), precision="highest")
    bh = fft.negacyclic_fft(torch.from_numpy(b), precision="highest")
    prod = fft.negacyclic_ifft(ah * bh, N).numpy()
    assert np.abs(np.round(prod) - _exact(a, b.astype(np.int32))).max() == 0


def test_twiddle_properties():
    """|w| = 1 (code.cpp:528-543, 563-572), and the port's twist table is
    the JAX package's."""
    N = 256
    w = fft._twist_t(N, torch.device("cpu")).numpy()
    assert np.abs(np.abs(w) - 1).max() < 1e-15
    np.testing.assert_array_equal(w, jfft._twist(N, np.complex128))


def test_dd_arithmetic_exactness():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1e6, 1e6, 1000)
    y = rng.uniform(-1e6, 1e6, 1000)
    xh, xl = fft.dd_from_f64(x)
    yh, yl = fft.dd_from_f64(y)
    xdd = xh.double().numpy() + xl.double().numpy()
    ydd = yh.double().numpy() + yl.double().numpy()
    sh, sl = fft.dd_add(xh, xl, yh, yl)
    got = sh.double().numpy() + sl.double().numpy()
    scale = np.maximum(np.abs(xdd), np.abs(ydd))
    err = np.abs(got - (xdd + ydd)) / np.maximum(scale, 1e-30)
    assert err.max() < 2**-44
    ph, pl = fft.dd_mul(xh, xl, yh, yl)
    got = ph.double().numpy() + pl.double().numpy()
    err = np.abs(got - xdd * ydd) / np.maximum(np.abs(xdd * ydd), 1e-30)
    assert err.max() < 2**-44
    # the same error-free transforms as the JAX package's, eagerly
    jh, jl = jfft.dd_mul(*jfft.dd_from_f64(x), *jfft.dd_from_f64(y))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


def test_dd_fft_roundtrip_and_precision():
    """Forward dd FFT -> pointwise -> inverse gives the exact negacyclic
    product mod 2^32 at torus32 scale."""
    N = 128
    rng = np.random.default_rng(3)
    a = rng.integers(-64, 64, N)
    b = rng.integers(-2**31, 2**31, N)
    ah = fft.negacyclic_fft_dd(a.astype(np.float64))
    bh = fft.negacyclic_fft_dd(b.astype(np.float64))
    prod = fft.negacyclic_ifft_dd(fft._dd_cmul(*ah, *bh), N).numpy()
    got = np.round(prod).astype(np.int64).astype(np.uint64).astype(np.uint32)
    want = _exact(a, b.astype(np.int32)).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_spqlios_layout_roundtrip():
    N2 = 2048
    rng = np.random.default_rng(0)
    hat = rng.normal(size=(3, N2 // 2)) + 1j * rng.normal(size=(3, N2 // 2))
    buf = fft.to_spqlios(torch.from_numpy(hat))
    np.testing.assert_array_equal(buf.numpy(), jfft.to_spqlios(hat))
    back = fft.from_spqlios(buf)
    np.testing.assert_allclose(back.numpy(), hat, rtol=0, atol=0)
    perm, conj = fft.spqlios_order(N2)
    jperm, jconj = jfft.spqlios_order(N2)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(conj, jconj)


@pytest.mark.parametrize("bits,precision", [(32, "f64"), (64, "f64"),
                                            (32, "dd")])
def test_mul_fft_family_matches_jax(bits, precision):
    """poly.mul_fft, add_mul_fft and sub_mul_fft against JAX's on the same
    inputs (the dd path at 32 bits only: its ~49-bit mantissa), within the
    FFT engines' envelopes of the exact product."""
    N = 256
    rng = np.random.default_rng(4)
    a = rng.integers(-64, 65, (2, N)).astype(np.int32)
    if bits == 32:
        b = rng.integers(-2**31, 2**31, (2, N)).astype(np.int32)
        acc = rng.integers(-2**31, 2**31, (2, N)).astype(np.int32)
    else:
        b = rng.integers(-2**40, 2**40, (2, N)).astype(np.int64)
        acc = rng.integers(-2**62, 2**62, (2, N)).astype(np.int64)
    bound = 2**4 if precision == "f64" else 2**8
    exact = np.stack([_exact(a[i], b[i]) for i in range(2)])
    for name in ("mul_fft", "add_mul_fft", "sub_mul_fft"):
        args = (a, b) if name == "mul_fft" else (acc, a, b)
        got = getattr(poly, name)(*(torch.from_numpy(v) for v in args),
                                  precision=precision)
        want = np.asarray(getattr(jpoly, name)(
            *(jnp.asarray(v) for v in args), precision=precision))
        assert got.dtype == torch.from_numpy(b).dtype
        d = got.numpy().astype(np.int64) - want.astype(np.int64)
        if bits == 32:
            d = d.astype(np.int32)
        assert np.abs(d).max() <= bound
        if name == "mul_fft":
            e = got.numpy().astype(np.int64) - exact.astype(np.int64)
            assert np.abs(e.astype(b.dtype)).max() <= bound
