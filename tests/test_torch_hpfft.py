"""The port's high-precision anticyclic FFT study (tfhe_tpu_torch.ops.hpfft)
against tfhe_tpu.ops.hpfft on the CPU: every case of tests/test_hpfft.py,
on the same integer inputs, bit for bit (tolerance 0), plus that test's own
check of each result (bigint models, the round-trip and product
tolerances, the float oracle)."""

import random

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import hpfft as J
from tfhe_tpu_torch.ops import hpfft as P

LIMB_BITS = P.LIMB_BITS


def _same(got, want):
    """A port tensor (or tuple of them) equals the JAX array(s)."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.device.type == "cpu" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _to_bigint(a):
    """HP tensor -> signed Python ints of the raw 2^-64-scaled value."""
    a = a.numpy()
    limbs = a.shape[-1]
    mod = 1 << (LIMB_BITS * limbs)
    out = []
    for row in a.reshape(-1, limbs):
        u = 0
        for i in reversed(range(limbs)):
            u = (u << LIMB_BITS) | int(row[i])
        out.append(u - mod if u >= mod // 2 else u)
    return out


def _hp(vals, limbs):
    mod = 1 << (LIMB_BITS * limbs)
    return np.array([[(v % mod >> (LIMB_BITS * i)) & P.LIMB_MASK
                      for i in range(limbs)] for v in vals], np.int64)


def test_constants_match_jax():
    assert (P.FRAC_LIMBS, P.LIMB_BITS, P.LIMB_MASK) == \
        (J.FRAC_LIMBS, J.LIMB_BITS, J.LIMB_MASK)


@pytest.mark.parametrize("limbs", [6, 8])
def test_hp_arithmetic_matches_jax_and_bigints(limbs):
    r = random.Random(0)
    mod = 1 << (LIMB_BITS * limbs)
    half = mod // 2
    av = [r.randrange(-half, half) for _ in range(64)]
    bv = [r.randrange(-half, half) for _ in range(64)]
    a, b = _hp(av, limbs), _hp(bv, limbs)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def wrap(v):
        u = v % mod
        return u - mod if u >= half else u

    for name, want in (
            ("hp_add", [wrap(x + y) for x, y in zip(av, bv)]),
            ("hp_sub", [wrap(x - y) for x, y in zip(av, bv)]),
            ("hp_mul", [wrap((x * y) >> 64) for x, y in zip(av, bv)])):
        got = getattr(P, name)(ta, tb)
        _same(got, getattr(J, name)(a, b))
        assert _to_bigint(got) == want, name
    got = P.hp_neg(ta)
    _same(got, J.hp_neg(a))
    assert _to_bigint(got) == [wrap(-x) for x in av]


def test_hp_rshift_matches_jax():
    r = random.Random(1)
    limbs = 6
    vals = [r.randrange(-2**90, 2**90) for _ in range(32)]
    a = _hp(vals, limbs)
    for s in (1, 5, 10, 16, 37):
        got = P.hp_rshift(torch.from_numpy(a), s)
        _same(got, J.hp_rshift(a, s))
        assert _to_bigint(got) == [v >> s for v in vals], s


def test_t64_and_int_embeddings_match_jax():
    r = np.random.default_rng(2)
    x = r.integers(-2**63, 2**63, 64, dtype=np.int64)
    for limbs in (6, 8):
        hp = P.hp_from_t64(x, limbs, device="cpu")
        _same(hp, J.hp_from_t64(x, limbs))
        _same(P.hp_to_t64(hp), J.hp_to_t64(J.hp_from_t64(x, limbs)))
        np.testing.assert_array_equal(P.hp_to_t64(hp).numpy(), x)
        v = r.integers(-2**40, 2**40, 16, dtype=np.int64)
        _same(P.hp_from_int(v, limbs, device="cpu"), J.hp_from_int(v, limbs))
        np.testing.assert_array_equal(
            P.hp_to_float(P.hp_from_int(v, limbs, device="cpu")),
            J.hp_to_float(J.hp_from_int(v, limbs)))


def test_twiddles_match_jax():
    """The port's own copy of the decimal twiddle code gives the JAX
    module's integers, and the identities c^2 + s^2 = 1 (code.cpp:528-543)
    hold; the HP tables equal JAX's."""
    n = 128
    ci, si = P._twiddle_ints(n)
    assert (ci, si) == J._twiddle_ints(n)
    for i in range(n):
        assert abs(ci[i] ** 2 + si[i] ** 2 - (1 << 128)) < (1 << 66), i
    cpu = torch.device("cpu")
    for limbs in (6, 8):
        _same(P.precomp_ifft(n, limbs, cpu), J.precomp_ifft(n, limbs))
        _same(P.precomp_fft(n, limbs, cpu), J.precomp_fft(n, limbs))


@pytest.mark.parametrize("limbs", [6, 8])
def test_round_trip_matches_jax(limbs):
    """FFT(iFFT(x)) equals JAX's bit for bit and x within the reference's
    very_close tolerance (code.cpp:234-241)."""
    r = np.random.default_rng(3)
    x = r.integers(-2**62, 2**62, (3, 64), dtype=np.int64)
    re, im = P.hp_ifft(x, limbs, device="cpu")
    jre, jim = J.hp_ifft(x, limbs)
    _same((re, im), (jre, jim))
    back = P.hp_fft(re, im)
    _same(back, J.hp_fft(jre, jim))
    assert np.abs(back.numpy() - x).max() < 10000


def test_ifft_matches_jax_and_float_oracle():
    """The slots equal JAX's and the naive evaluations at odd roots, as
    multisets (the butterflies emit bit-reversed block order)."""
    r = np.random.default_rng(4)
    N = 32
    x = r.integers(-2**62, 2**62, N, dtype=np.int64)
    re, im = P.hp_ifft(x, 6, device="cpu")
    _same((re, im), J.hp_ifft(x, 6))
    want = P.naive_eval(x)
    np.testing.assert_array_equal(want, J.naive_eval(x))
    got = P.hp_to_float(re) + 1j * P.hp_to_float(im)
    dist = np.abs(got[:, None] - want[None, :])
    nearest = dist.argmin(axis=1)
    assert len({min(int(k), N - 1 - int(k)) for k in nearest}) == N // 2
    assert dist[np.arange(N // 2), nearest].max() < 1e-9 * np.abs(want).max()


def _exact_negacyclic(a, b):
    N = len(a)
    exact = [0] * N
    for i in range(N):
        for j in range(N):
            v = int(a[i]) * int(b[j])
            if i + j < N:
                exact[i + j] += v
            else:
                exact[i + j - N] -= v
    return np.array([((v + 2**63) % 2**64) - 2**63 for v in exact], np.int64)


@pytest.mark.parametrize("limbs", [6, 8])
def test_negacyclic_product_matches_jax(limbs):
    """int x torus64 through the HP FFT: bit for bit against JAX, and
    within the H4 tolerance of the exact bigint convolution."""
    r = np.random.default_rng(5)
    N = 64
    a = r.integers(-64, 64, N).astype(np.int64)
    b = r.integers(-2**63, 2**63, N, dtype=np.int64)
    got = P.hp_negacyclic_mul(torch.from_numpy(a), torch.from_numpy(b),
                              limbs)
    _same(got, J.hp_negacyclic_mul(a, b, limbs))
    assert np.abs(got.numpy() - _exact_negacyclic(a, b)).max() < \
        20000 * N // 16
    _same(P.hp_ifft_int(a, limbs, device="cpu"), J.hp_ifft_int(a, limbs))


@pytest.mark.parametrize("alpha", [35, 60, 120])
def test_gmp_sweep_params_match_jax(alpha):
    assert P.gmp_sweep_params(alpha) == J.gmp_sweep_params(alpha)
