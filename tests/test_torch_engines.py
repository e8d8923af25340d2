"""The port's conv, Nussbaumer and FFT engines against tfhe_tpu's, on the CPU.

  * ``conv``, ``conv_bf16`` (inside the JAX package's exact bf16 domain) and
    ``nussbaumer`` equal the JAX engines bit for bit, prepared key and
    product, at 32 and 64 bits on the grids of tests/test_engine.py, plus
    one N=1024 gate shape; conv also equals the port's exact onthefly and
    chunked engines;
  * ``fft_f64`` and ``fft_dd`` stay within 2^4 and 2^8 of the exact engine
    and of the JAX engine at the shapes of tests/test_fft_engine.py;
  * the dd transform round-trips integers exactly, ``fft_dd`` refuses
    64-bit outputs, and ``make_engine`` builds every JAX backend name.

The same seeded numpy inputs go through both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu.ops import engine as jeng
from tfhe_tpu.ops.nussbaumer import split_mr as jsplit_mr
from tfhe_tpu_torch.ops import engine, fft, nussbaumer

JAX_BACKENDS = ("naive", "matmul", "onthefly", "chunked", "conv", "conv_bf16",
                "nussbaumer", "fft", "fft_dd", "fft_f64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_case(seed, N, bits, digit_bits, B, J, U):
    """tests/test_engine.py's _rand_case."""
    rng = np.random.default_rng(seed)
    half = 1 << (digit_bits - 1)
    x = rng.integers(-half, half, (B, J, N)).astype(np.int32)
    if bits == 32:
        key = rng.integers(-2**31, 2**31, (J, U, N)).astype(np.int32)
    else:
        key = rng.integers(0, 2**64, (J, U, N),
                           dtype=np.uint64).astype(np.int64)
    return x, key


def _both(backend, cfg_kw, key, jit=False):
    """The JAX engine and its prepared key, the port's and its prepared key.
    ``jit``: the JAX engine's prepare and accumulate jitted (its eager
    Nussbaumer and dd paths dispatch hundreds of small operations)."""
    je = jeng.make_engine(jeng.EngineConfig(**cfg_kw), backend)
    te = engine.make_engine(engine.EngineConfig(**cfg_kw), backend)
    prepare = jax.jit(je.prepare) if jit else je.prepare
    if jit:
        je.accumulate = jax.jit(je.accumulate)
    return je, prepare(jnp.asarray(key)), te, te.prepare(
        torch.from_numpy(key))


def _same_key(tprep, jprep):
    assert set(tprep) == set(jprep)
    for name, jv in jprep.items():
        jv = np.asarray(jv)
        tv = tprep[name]
        assert tuple(tv.shape) == jv.shape
        np.testing.assert_array_equal(tv.to(torch.float32).numpy(),
                                      jv.astype(np.float32))


@pytest.mark.parametrize("backend", ["conv", "conv_bf16"])
@pytest.mark.parametrize("bits,digit_bits", [(32, 8), (32, 7), (64, 9)])
def test_conv_matches_jax(backend, bits, digit_bits):
    """conv_bf16 at these shapes lies inside the JAX package's exact bf16
    domain (per-j sums below 2^24), so both backends must equal JAX's."""
    N, B, J, U = 64, 3, 4, 2
    cfg = dict(N=N, out_bits=bits, digit_bits=digit_bits)
    x, key = _rand_case(42, N, bits, digit_bits, B, J, U)
    je, jprep, te, tprep = _both(backend, cfg, key)
    _same_key(tprep, jprep)
    assert tprep["k"].dtype == (torch.int8 if backend == "conv"
                                else torch.bfloat16)
    want = np.asarray(je.accumulate(jnp.asarray(x), jprep))
    got = te.accumulate(torch.from_numpy(x), tprep)
    assert got.dtype == (torch.int32 if bits == 32 else torch.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = torch.from_numpy(_rand_case(7, N, bits, digit_bits, B, 1, U)[1]
                           .reshape(1, U, N).repeat(B, 0))
    np.testing.assert_array_equal(
        te.accumulate_into(acc, torch.from_numpy(x), tprep).numpy(),
        np.asarray(jnp.asarray(acc.numpy()) + want))


@pytest.mark.parametrize("bits,digit_bits,key_limbs", [(32, 7, 0), (32, 7, 3),
                                                       (64, 8, 6)])
def test_conv_gate_and_lvl2_shapes(bits, digit_bits, key_limbs):
    """N=1024 at the gate gadget (J=6, U=2: GATE_DEFAULT's engine shape,
    with 4 and with 3 key limbs) and a 64-bit lvl2 shape (Bg=2^8, 6 limbs):
    conv equals JAX's conv and the port's exact engines (onthefly at 32
    bits, chunked at 64)."""
    N, B, J, U = (1024, 4, 6, 2) if bits == 32 else (256, 3, 4, 2)
    cfg = dict(N=N, out_bits=bits, digit_bits=digit_bits,
               key_limbs=key_limbs)
    x, key = _rand_case(3, N, bits, digit_bits, B, J, U)
    je, jprep, te, tprep = _both("conv", cfg, key)
    _same_key(tprep, jprep)
    got = te.accumulate(torch.from_numpy(x), tprep)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(je.accumulate(jnp.asarray(x), jprep)))
    exact = engine.make_engine(engine.EngineConfig(**cfg),
                               "onthefly" if bits == 32 else "chunked")
    assert torch.equal(got, exact.accumulate(
        torch.from_numpy(x), exact.prepare(torch.from_numpy(key))))


def test_conv_key_is_the_onthefly_vector():
    """The gather of ConvEngine._v gives onthefly's doubled-limb vector
    back, with the one entry the conv key lacks (m = N) written 0."""
    N, J, U = 64, 3, 2
    cfg = engine.EngineConfig(N=N, out_bits=32, digit_bits=7)
    _, key = _rand_case(1, N, 32, 7, 1, J, U)
    key = torch.from_numpy(key)
    v = engine.make_engine(cfg, "onthefly").prepare(key)["v"]
    conv = engine.make_engine(cfg, "conv")
    got = conv._v(conv.prepare(key)["k"], J)
    assert not got[..., N].any()
    keep = torch.arange(2 * N) != N
    assert torch.equal(got[..., keep], v[..., keep])


@pytest.mark.parametrize("N,bits,digit_bits",
                         [(N, b, d) for N in (64, 128, 256)
                          for b, d in ((32, 7), (32, 8), (64, 9))]
                         + [(1024, 32, 7)])
def test_nussbaumer_matches_jax(N, bits, digit_bits):
    """Bit for bit with the JAX engine on any key (deterministic integer
    arithmetic), and with the exact product on keys divisible by 2m
    (tests/test_engine.py:76-98), plus the N=1024 gate gadget."""
    B, J, U = 3, 4, 2
    assert nussbaumer.split_mr(N) == jsplit_mr(N)
    m, _ = nussbaumer.split_mr(N)
    cfg = dict(N=N, out_bits=bits, digit_bits=digit_bits)
    x, key = _rand_case(5, N, bits, digit_bits, B, J, U)
    je, jprep, te, tprep = _both("nussbaumer", cfg, key, jit=True)
    _same_key(tprep, jprep)
    got = te.accumulate(torch.from_numpy(x), tprep)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(je.accumulate(jnp.asarray(x), jprep)))
    key2m = (key >> np.uint8(m.bit_length())) << np.uint8(m.bit_length())
    ex = engine.make_engine(engine.EngineConfig(**cfg), "naive")
    want = ex.accumulate(torch.from_numpy(x),
                         ex.prepare(torch.from_numpy(key2m)))
    assert torch.equal(te.accumulate(
        torch.from_numpy(x), te.prepare(torch.from_numpy(key2m))), want)


@pytest.fixture(scope="module")
def fft_cases():
    """tests/test_fft_engine.py's shapes and inputs, their exact products,
    and the JAX engines' results (jitted: its eager dd engine takes ~40 s
    a shape on the CPU)."""
    out = {}
    for N, J, U in [(1024, 6, 2), (512, 9, 3)]:
        r = np.random.default_rng(0)
        key = r.integers(-2**31, 2**31, (J, U, N)).astype(np.int32)
        x = r.integers(-64, 65, (4, J, N)).astype(np.int32)
        cfg = dict(N=N, out_bits=32, digit_bits=7)
        ex = engine.make_engine(engine.EngineConfig(**cfg), "naive")
        exact = ex.accumulate(torch.from_numpy(x),
                              ex.prepare(torch.from_numpy(key))).numpy()
        jax_out = {}
        for b in ("fft_f64", "fft_dd"):
            je = jeng.make_engine(jeng.EngineConfig(**cfg), b)
            jax_out[b] = np.asarray(jax.jit(
                lambda k, x: je.accumulate(x, je.prepare(k)))(key, x))
        out[(N, J, U)] = (cfg, key, x, exact, jax_out)
    return out


def _dist32(a, b):
    return int(np.abs((np.asarray(a).astype(np.int64)
                       - np.asarray(b).astype(np.int64)).astype(np.int32))
               .max())


@pytest.mark.parametrize("shape", [(1024, 6, 2), (512, 9, 3)])
@pytest.mark.parametrize("backend,bound", [("fft_f64", 2**4),
                                           ("fft_dd", 2**8)])
def test_fft_engine_envelope(fft_cases, shape, backend, bound):
    cfg, key, x, exact, jax_out = fft_cases[shape]
    te = engine.make_engine(engine.EngineConfig(**cfg), backend)
    prep = te.prepare(torch.from_numpy(key))
    if backend == "fft_dd":
        assert isinstance(prep["hat"], tuple) and len(prep["hat"]) == 4
    got = te.accumulate(torch.from_numpy(x), prep)
    assert got.dtype == torch.int32 and got.shape == exact.shape
    assert _dist32(got, exact) <= bound
    assert _dist32(got, jax_out[backend]) <= bound
    acc = torch.from_numpy(exact)
    into = te.accumulate_into(acc, torch.from_numpy(x), prep)
    assert torch.equal(into, (acc.to(torch.int64) + got).to(torch.int32))


def test_fft_prepared_key_matches_jax():
    """The f64 key to f64 roundoff, the dd key's four parts to f32's."""
    N, J, U = 256, 2, 2
    r = np.random.default_rng(4)
    key = r.integers(-2**31, 2**31, (J, U, N)).astype(np.int32)
    cfg = dict(N=N, out_bits=32, digit_bits=7)
    _, jprep, _, tprep = _both("fft_f64", cfg, key)
    want = np.asarray(jprep["hat"])
    assert tprep["hat"].dtype == torch.complex128
    np.testing.assert_allclose(tprep["hat"].numpy(), want,
                               atol=1e-12 * np.abs(want).max())
    _, jprep, _, tprep = _both("fft_dd", cfg, key, jit=True)
    for got, want in zip(tprep["hat"], jprep["hat"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=2**-20 * np.abs(want).max())


def test_dd_roundtrip_exact():
    """tests/test_fft_engine.py:45-51: dd forward/inverse gives the
    integers back exactly at torus32 scale."""
    a = np.random.default_rng(1).integers(-2**31, 2**31,
                                          (3, 512)).astype(np.int32)
    hat = fft.negacyclic_fft_dd_dev(torch.from_numpy(a))
    back = fft.negacyclic_ifft_dd_dev(hat, 512, 32)
    np.testing.assert_array_equal(back.numpy(), a)


def test_fft_dd_refuses_64_bits():
    with pytest.raises(ValueError):
        engine.make_engine(engine.EngineConfig(N=256, out_bits=64,
                                               digit_bits=9), "fft_dd")


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_make_engine_builds_every_jax_name(backend):
    """Every backend name of the JAX package's make_engine builds in the
    port, at 32 bits and (all but fft_dd, matmul and onthefly, which the
    JAX package also limits to 32 bits) at 64."""
    cfg = engine.EngineConfig(N=64, out_bits=32, digit_bits=7)
    eng = engine.make_engine(cfg, backend)
    assert eng.cfg == cfg
    assert jeng.make_engine(jeng.EngineConfig(N=64, out_bits=32,
                                              digit_bits=7), backend)
    if backend not in ("fft_dd", "matmul", "onthefly"):
        engine.make_engine(engine.EngineConfig(N=64, out_bits=64,
                                               digit_bits=9), backend)


def test_make_engine_unknown_name():
    with pytest.raises(ValueError, match="unknown backend"):
        engine.make_engine(engine.EngineConfig(N=64, out_bits=32,
                                               digit_bits=7), "no-such")
