"""The small functions of the JAX package's API that the port adds last
(torus conversions, lwe.decrypt, tlwe.encrypt_poly / encrypt_scalar /
TLweKey.engine, the exact product and the scalar mul-adds and norms of
ops.poly, and ``torus`` at the package's top level), against tfhe_tpu's on
the CPU, on the inputs tests/test_torus.py, test_lwe.py, test_tlwe_tgsw.py
and test_poly.py give them.  Exact functions bit for bit; the float64
results of the conversions and norms equal JAX's exactly too, but for
t64tod, whose JAX version raises (it divides by the Python int 2^64) and
which is held to its formula."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tfhe_tpu
import tfhe_tpu_torch
from tfhe_tpu import lwe as jlwe, tlwe as jtlwe, torus as jT
from tfhe_tpu.ops import poly as jpoly
from tfhe_tpu.params import LweParams as JLweParams, TLweParams as JTLwe
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import lwe, tlwe, torus as T
from tfhe_tpu_torch.ops import poly
from tfhe_tpu_torch.params import LweParams, TLweParams
from tfhe_tpu_torch.rng import TfheRng


def _eq(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_torus_at_top_level():
    assert tfhe_tpu_torch.torus is T
    assert tfhe_tpu.torus is jT


def test_t32_t64_conversions_match_jax():
    xs = np.array([0, 1, -1, 2**31 - 1, -2**31, 12345678], np.int32)
    x64 = T.t32tot64(torch.from_numpy(xs))
    _eq(x64, jT.t32tot64(xs))
    _eq(T.t64tot32(x64), jT.t64tot32(np.asarray(jT.t32tot64(xs))))
    _eq(T.t64tot32(x64), xs)
    r = np.random.default_rng(0)
    y = r.integers(-2**63, 2**63, 64, dtype=np.int64)
    _eq(T.t64tot32(torch.from_numpy(y)), jT.t64tot32(y))
    _eq(T.t32tod(torch.from_numpy(xs)), jT.t32tod(xs))
    # the JAX package's t64tod divides by the int 2^64, which JAX cannot
    # take as an argument (OverflowError); its formula, in float64:
    with pytest.raises(OverflowError):
        jT.t64tod(y)
    _eq(T.t64tod(torch.from_numpy(y)), y.astype(np.float64) / 2.0**64)


def test_dtot32_matches_jax():
    ds = np.array([0.0, 0.25, -0.25, 0.5 - 2**-32, 1.75, -3.125, 7.9999,
                   -0.75])
    got = T.dtot32(torch.from_numpy(ds))
    _eq(got, jT.dtot32(ds))
    for d, g in zip(ds, got.numpy()):
        assert g == np.int32(np.int64((d - np.int64(d)) * 2**32)), d
    for d in (0.0, 0.125, -0.125, 0.7, -3.3, 5.5):
        assert T.double_to_t32(d) == jT.double_to_t32(d)


@pytest.mark.parametrize("msize", [2, 8, 1000, 2048])
def test_mod_switch_to_torus32_matches_jax(msize):
    r = np.random.default_rng(msize)
    phases = r.integers(-2**31, 2**31, 1000).astype(np.int32)
    m = np.asarray(jT.mod_switch_from_torus32(phases, msize))
    _eq(T.mod_switch_from_torus32(torch.from_numpy(phases), msize),
        m.astype(np.int32))
    back = T.mod_switch_to_torus32(torch.from_numpy(m.astype(np.int32)),
                                   msize)
    _eq(back, jT.mod_switch_to_torus32(m, msize))
    err = np.abs((back.numpy().astype(np.int64) - phases) % 2**32)
    assert np.minimum(err, 2**32 - err).max() <= 2**32 / (2 * msize) + 1


def test_lwe_decrypt_matches_jax():
    msgs = np.array([3 << 29, 1 << 30, -(1 << 29), 0], np.int32)
    jrng = JRng(0)
    jkey = jlwe.LweKey.generate(JLweParams(n=64, stdev=2.0**-20), jrng)
    jct = jlwe.encrypt(jkey, msgs, jrng)
    rng = TfheRng(0)
    key = lwe.LweKey.generate(LweParams(n=64, stdev=2.0**-20), rng)
    ct = lwe.encrypt(key, msgs, rng, device="cpu")
    _eq(ct, jct)
    for msize in (8, 6):
        _eq(lwe.decrypt(ct, key, msize), jlwe.decrypt(jct, jkey, msize))
    _eq(lwe.decrypt(ct, key, 8), msgs)


@pytest.mark.parametrize("bits,N,k", [(32, 64, 1), (64, 32, 1), (32, 32, 2)])
def test_tlwe_encrypt_poly_and_scalar_match_jax(bits, N, k):
    stdev = 2.0**-20 if bits == 32 else 2.0**-40
    dt = np.int32 if bits == 32 else np.int64
    msg = np.zeros((3, N), dt)
    msg[:, 0] = [1 << (bits - 3), -(1 << (bits - 2)), 1 << (bits - 4)]
    mu = 1 << (bits - 4)
    jrng, rng = JRng(bits + N), TfheRng(bits + N)
    jkey = jtlwe.TLweKey.generate(JTLwe(N=N, k=k, stdev=stdev, bits=bits),
                                  jrng)
    key = tlwe.TLweKey.generate(TLweParams(N=N, k=k, stdev=stdev, bits=bits),
                                rng)
    jct = jtlwe.encrypt_poly(jkey, jnp.asarray(msg), jrng)
    ct = tlwe.encrypt_poly(key, torch.from_numpy(msg), rng, device="cpu")
    _eq(ct, jct)
    _eq(tlwe.tlwe_phase(ct, key), jtlwe.tlwe_phase(jct, jkey))
    jcs = jtlwe.encrypt_scalar(jkey, dt(mu), jrng, (2,))
    cs = tlwe.encrypt_scalar(key, dt(mu), rng, (2,), device="cpu")
    _eq(cs, jcs)
    ph = tlwe.tlwe_phase(cs, key).numpy().astype(np.float64)
    assert np.abs(ph - np.array([[mu] + [0] * (N - 1)] * 2)).max() < \
        2.0**(bits - 18)


@pytest.mark.parametrize("bits,N,k", [(32, 32, 2), (64, 64, 1)])
def test_tlwe_key_engine_matches_jax(bits, N, k):
    """TLweKey.engine's product equals the JAX key engine's, prepared once
    per backend and device; a key outside {0, 1} routes key_times
    through it."""
    p = TLweParams(N=N, k=k, stdev=0.0, bits=bits)
    key = tlwe.TLweKey.generate(p, TfheRng(1))
    jkey = jtlwe.TLweKey.generate(JTLwe(N=N, k=k, stdev=0.0, bits=bits),
                                  JRng(1))
    dt = np.int32 if bits == 32 else np.int64
    x = np.random.default_rng(0).integers(
        -2**(bits - 1), 2**(bits - 1), (5, k, N)).astype(dt)
    eng, prep = key.engine(device="cpu")
    assert key.engine(device="cpu")[1] is prep
    jeng, jprep = jkey.engine()
    want = np.asarray(jeng.accumulate(jnp.asarray(x), jprep))
    _eq(eng.accumulate(torch.from_numpy(x), prep), want)
    if bits == 32:
        eng, prep = key.engine("onthefly", device="cpu")
        _eq(eng.accumulate(torch.from_numpy(x), prep), want)
    ternary = np.random.default_rng(2).integers(-1, 2, (k, N)).astype(
        np.int32)
    tk = tlwe.TLweKey.from_bits(p, ternary)
    jtk = jtlwe.TLweKey.from_bits(JTLwe(N=N, k=k, stdev=0.0, bits=bits),
                                  ternary)
    _eq(tk.key_times(torch.from_numpy(x)), jtk.key_times(jnp.asarray(x)))


@pytest.mark.parametrize("bits,N", [(32, 64), (64, 32)])
def test_negacyclic_mul_exact_matches_jax(bits, N):
    r = np.random.default_rng(bits)
    a = r.integers(-256, 256, (3, N)).astype(np.int32)
    if bits == 32:
        b = r.integers(-2**31, 2**31, (3, N)).astype(np.int32)
    else:
        b = r.integers(0, 2**64, (3, N), dtype=np.uint64).astype(np.int64)
    _eq(poly.negacyclic_mul_exact(torch.from_numpy(a), torch.from_numpy(b)),
        jpoly.negacyclic_mul_exact(jnp.asarray(a), jnp.asarray(b)))
    _eq(poly.negacyclic_mul_exact(torch.from_numpy(a[0]),
                                  torch.from_numpy(b)),
        jpoly.negacyclic_mul_exact(jnp.asarray(a[0]), jnp.asarray(b)))


@pytest.mark.parametrize("dt", [np.int32, np.int64])
def test_add_sub_mul_z_match_jax(dt):
    r = np.random.default_rng(3)
    info = np.iinfo(dt)
    acc = r.integers(info.min, info.max, (4, 16), dtype=np.int64).astype(dt)
    x = r.integers(-2**20, 2**20, (4, 16)).astype(np.int32)
    acc[0, 0], x[0, 0] = info.max, 1                 # wraps
    for p in (3, -7, np.arange(1, 5, dtype=np.int32)[:, None]):
        tp = torch.from_numpy(p) if isinstance(p, np.ndarray) else p
        got = poly.add_mul_z(torch.from_numpy(acc), tp, torch.from_numpy(x))
        _eq(got, jpoly.add_mul_z(jnp.asarray(acc), p, jnp.asarray(x)))
        back = poly.sub_mul_z(got, tp, torch.from_numpy(x))
        _eq(back, jpoly.sub_mul_z(jpoly.add_mul_z(jnp.asarray(acc), p,
                                                  jnp.asarray(x)),
                                  p, jnp.asarray(x)))
        _eq(back, acc)


def test_norms_match_jax():
    r = np.random.default_rng(0)
    a = r.integers(-100, 100, (3, 16)).astype(np.int32)
    b = r.integers(-100, 100, (3, 16)).astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _eq(poly.int_norm_sq2(ta), jpoly.int_norm_sq2(a))
    _eq(poly.int_norm_infty_dist(ta, tb), jpoly.int_norm_infty_dist(a, b))
    for dt, bits in ((np.int32, 32), (np.int64, 64)):
        info = np.iinfo(dt)
        t1 = r.integers(info.min, info.max, (2, 16), dtype=np.int64)
        t1 = t1.astype(dt)
        t2 = (t1.astype(np.int64) + 7).astype(dt)       # one wraps
        t1[0, 0], t2[0, 0] = info.max, info.min
        got = poly.torus_norm_infty_dist(torch.from_numpy(t1),
                                         torch.from_numpy(t2))
        _eq(got, jpoly.torus_norm_infty_dist(jnp.asarray(t1),
                                             jnp.asarray(t2)))
        np.testing.assert_allclose(got.numpy(), 7 / 2.0**bits)
