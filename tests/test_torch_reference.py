"""The compiled-reference anchors through the port (CPU; imports no JAX).

Fixtures under tests/fixtures/{ref_exact,ref_fft,ref_e2e_exact,ref_e2e_fft}
are dumps of the reference PoC under FALSE_RANDOM (every key bit 1, every
uniform 0xcccc..., every Gaussian at its centre), as tests/
test_reference_vectors.py and tests/test_reference_e2e.py read them:

  * every ``ref_exact`` anchor equals the port's output bit for bit: the
    FALSE_RANDOM keys, ``input_lvl1`` (lwe.encrypt), the preKS table rows
    and output, the mod switch, both Karatsuba products (through the naive
    and conv engines), the PoC's rotation bug pinned, the privKS table rows
    and ``privks_out`` (``decomp64_out``, ``cmux_decomp``, ``bk0`` and
    ``cmux_extprod`` are held in tests/test_torch_chunked64.py);
  * ``ref_e2e_exact``: the preKS + mod-switch chain, and ``cb_out`` from the
    fixture's own ``boot_w*.i64`` through ``circuit.priv_keyswitch``;
  * the ``ref_fft`` spqlios parity fixtures through ``ops.fft``, at
    tests/test_reference_vectors.py's tolerances;
  * the two 500-step CB_ACTIVE rotations in the patched PoC's composition,
    bit for bit against ``boot_w*.i64``, and their phases within 2^45 of the
    asm-FFT build's (``ref_e2e_fft``): ``e2e_rotations_check``, run on the
    card by tests/test_torch_cuda.py and on the CPU only under ``slow``
    (~150 s).
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import lwe, tgsw, tlwe
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import blind_rotate, circuit
from tfhe_tpu_torch.ops import engine, fft, poly
from tfhe_tpu_torch.params import CB_ACTIVE, LweParams
from tfhe_tpu_torch.rng import TfheRng

FIX = pathlib.Path(__file__).parent / "fixtures"
EXACT = FIX / "ref_exact"
FFTD = FIX / "ref_fft"
E2E = FIX / "ref_e2e_exact"
E2E_FFT = FIX / "ref_e2e_fft"

P = CB_ACTIVE
N1, N2, n0, n2 = P.n_lvl1, P.n_lvl2, P.n_lvl0, P.n_lvl2
ELL1, BG1 = P.tgsw_lvl1.l, P.tgsw_lvl1.bgbit
CC32 = np.int32(np.uint32(0xCCCCCCCC).astype(np.int32))


def i32(d, name):
    return np.fromfile(d / name, np.int32)


def i64(d, name):
    return np.fromfile(d / name, np.int64)


def f64(d, name):
    return np.fromfile(d / name, np.float64)


# deterministic input patterns, as native/ref_dump.cpp:51-56 makes them

def pat32(i):
    return (((np.asarray(i, np.int64) + 1) * 0x9E3779B9)
            & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)


def pat64(i):
    return ((np.asarray(i, np.uint64) + np.uint64(1))
            * np.uint64(0x9E3779B97F4A7C15)).astype(np.int64)


def patdigit(i, bound):
    return (((pat64(i).astype(np.uint64) >> np.uint64(17))
             % np.uint64(2 * bound)).astype(np.int64) - bound).astype(np.int32)


def frng():
    return TfheRng(false_random=True)


def _ones_key(n):
    return lwe.LweKey(LweParams(n), np.ones(n, np.int32))


def _bk0(device="cpu"):
    """The port's TRGSW64 of key_lvl0[0] = 1 (tGsw64Encrypt_lvl2)."""
    ring2 = tlwe.TLweKey(P.lvl2, np.ones((1, N2), np.int32))
    return tgsw.encrypt(ring2, np.array([1]), P.tgsw_lvl2, frng(),
                        stdev=P.bk_stdev, device=device)[0]


# ---------------------------------------------------------------------------
# ref_exact
# ---------------------------------------------------------------------------

def test_false_random_keys_match():
    np.testing.assert_array_equal(i32(EXACT, "key_lvl0.i32"),
                                  np.ones(n0, np.int32))
    np.testing.assert_array_equal(i32(EXACT, "key_lvl1.i32"),
                                  np.ones(N1, np.int32))
    k2 = np.ones(n2 + 1, np.int32)
    k2[n2] = -1                                 # the extended coef
    np.testing.assert_array_equal(i32(EXACT, "key_lvl2.i32"), k2)
    np.testing.assert_array_equal(
        lwe.LweKey.generate(LweParams(n0), frng()).key, np.ones(n0, np.int32))
    np.testing.assert_array_equal(
        tlwe.TLweKey.generate(P.lvl2, frng()).key, np.ones((1, N2)))


def test_input_lvl1_encrypt():
    """lwe32Encrypt_lvl1(3<<29, 0.01) under FALSE_RANDOM."""
    key = lwe.LweKey(LweParams(N1, 0.01), np.ones(N1, np.int32))
    ours = lwe.encrypt(key, np.int32(3 << 29), frng(), device="cpu")
    np.testing.assert_array_equal(ours.numpy(), i32(EXACT, "input_lvl1.i32"))


@pytest.fixture(scope="module")
def preks():
    return lwe.KeySwitchKey.generate(_ones_key(N1), _ones_key(n0), P.ks10,
                                     frng(), keep_raw=True, device="cpu")


def test_preks_table_samples(preks):
    ref = i32(EXACT, "preKS_samples.i32").reshape(3, n0 + 1)
    for s, (i, j, u) in enumerate([(0, 0, 1), (0, 5, 3), (1023, 0, 2)]):
        np.testing.assert_array_equal(preks.raw[i, j, u], ref[s])


def test_preks_output_bit_exact(preks):
    x1 = torch.from_numpy(i32(EXACT, "input_lvl1.i32"))
    ours = lwe.keyswitch(x1[None], preks)[0]
    np.testing.assert_array_equal(ours.numpy(), i32(EXACT, "preks_out.i32"))


def test_premodswitch_bit_exact():
    u0 = torch.from_numpy(i32(EXACT, "preks_out.i32"))
    ours = T.mod_switch_from_torus32(u0, 2 * N2)
    np.testing.assert_array_equal(ours.numpy(),
                                  i32(EXACT, "premodswitch_out.i32"))


def _product(backend, digits, key, bits):
    """digits (N,) (*) key (N,) mod X^N+1 through an engine (J = U = 1)."""
    cfg = engine.EngineConfig(N=len(key), out_bits=bits, digit_bits=9)
    eng = engine.make_engine(cfg, backend)
    prep = eng.prepare(torch.from_numpy(key).reshape(1, 1, -1))
    return eng.accumulate(torch.from_numpy(digits).reshape(1, 1, -1),
                          prep).reshape(-1).numpy()


@pytest.mark.parametrize("backend", ["naive", "conv"])
def test_karatsuba32_bit_exact(backend):
    """torus32PolynomialMult[Add]Karatsuba_lvl1 (poc_karatsuba.cpp:60-94)."""
    ours = _product(backend, patdigit(np.arange(N1), 256),
                    pat32(np.arange(N1)), 32)
    np.testing.assert_array_equal(ours, i32(EXACT, "karatsuba32_out.i32"))
    np.testing.assert_array_equal((ours.astype(np.int64) * 2).astype(np.int32),
                                  i32(EXACT, "karatsuba32_addout.i32"))


@pytest.mark.parametrize("backend", ["naive", "conv"])
def test_karatsuba64_bit_exact(backend):
    """torus64PolynomialMultKaratsuba_lvl2 (poc_karatsuba.cpp:168-187); the
    FFT build's Karatsuba is the same exact code."""
    ours = _product(backend, patdigit(np.arange(N2), 256),
                    pat64(np.arange(N2)), 64)
    ref = i64(EXACT, "karatsuba64_out.i64")
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(i64(FFTD, "karatsuba64_out.i64"), ref)


def test_poc_rotation_bug_pinned():
    """The PoC's aibar<N rotation branch drops the negacyclic sign on the
    wrapped coefficients (PARITY.md bug 2): the port's rotation matches it
    except for exactly that sign."""
    aibar = 37
    a1 = pat64(np.arange(N2) + 5)
    ref = i64(EXACT, "poc_rotate37_out.i64")
    ours = poly.mul_by_xai_minus_one(torch.tensor([aibar], dtype=torch.int32),
                                     torch.from_numpy(a1)[None])[0].numpy()
    np.testing.assert_array_equal(ours[aibar:], ref[aibar:])
    wrapped = a1[N2 - aibar:]
    np.testing.assert_array_equal(ref[:aibar], wrapped - a1[:aibar])
    np.testing.assert_array_equal(ours[:aibar], -wrapped - a1[:aibar])


def _sk_stub():
    """The FALSE_RANDOM circuit keys: every bit 1."""
    return circuit.CircuitSecretKey(
        P, _ones_key(n0), tlwe.TLweKey(P.lvl1, np.ones((1, N1), np.int32)),
        tlwe.TLweKey(P.lvl2, np.ones((1, N2), np.int32)), _ones_key(N1))


def test_privks_table_samples():
    """privKS[z][i][j][u] rows (poc:406-419): the port's encrypt_zero plus
    its message table (PrivKeySwitchKey.generate's row recipe)."""
    ref = i32(EXACT, "privKS_samples.i32").reshape(3, 2, N1)
    mess = circuit._privks_message_table(_sk_stub())
    ring1 = tlwe.TLweKey(P.lvl1, np.ones((1, N1), np.int32))
    for s, (z, i, j, u) in enumerate([(0, 0, 0, 1), (1, 2048, 9, 7),
                                      (0, 777, 5, 3)]):
        c = tlwe.encrypt_zero(ring1, frng(), (), P.ks21.stdev,
                              device="cpu").to(torch.int64)
        c[z, 0] += int(mess[i, j, u])
        np.testing.assert_array_equal(T.wrap32(c).numpy(), ref[s])


@pytest.fixture(scope="module")
def pksk():
    """The FALSE_RANDOM privKS key, from its one distinct sample: every
    encrypt_zero row is the same (all randomness constant), so the table is
    that row's limbs with K_z * message added at (bloc z, coef 0) and the
    digit-0 rows zeroed, as PrivKeySwitchKey.generate builds it (2.7 GB of
    int8 at CB_ACTIVE, without generate's 2 x 1.3 GB of rows)."""
    ks = P.ks21
    mess = torch.from_numpy(
        circuit._privks_message_table(_sk_stub())).reshape(-1)
    row = tlwe.encrypt_zero(tlwe.TLweKey(P.lvl1, np.ones((1, N1), np.int32)),
                            frng(), (), ks.stdev, device="cpu").reshape(-1)
    base = T.balanced_limbs(row, 4, 8)                       # (4, 2*N1)
    rows = (n2 + 1) * ks.t * ks.base
    digit0 = torch.arange(rows) % ks.base == 0          # v = 0 rows
    w = torch.empty((2, 4, rows, 2 * N1), dtype=torch.int8)
    for z in range(2):
        w[z] = base[:, None, :]
        col = T.wrap32(row[z * N1].to(torch.int64) + mess)
        w[z, :, :, z * N1] = T.balanced_limbs(col, 4, 8)
        w[z, :, digit0] = 0
    return circuit.PrivKeySwitchKey(ks, n2, 1, N1, w)


def test_privks_key_rows_are_the_samples(pksk):
    """Three rows of the key's table recombine to privKS_samples.i32."""
    ref = i32(EXACT, "privKS_samples.i32").reshape(3, 2, N1)
    ks = P.ks21
    for s, (z, i, j, u) in enumerate([(0, 0, 0, 1), (1, 2048, 9, 7),
                                      (0, 777, 5, 3)]):
        r = (i * ks.t + j) * ks.base + u
        got = T.recombine_limbs(pksk.w_limbs[z, :, r], 8)
        np.testing.assert_array_equal(got.reshape(2, N1).numpy(), ref[s])


def test_privks_output_bit_exact(pksk):
    """circuitPrivKS(u, xs) (poc:667-698) on the synthetic lvl2 LWE."""
    xs = torch.from_numpy(pat64(np.arange(n2 + 1) + 11))
    ref = i32(EXACT, "privks_out.i32").reshape(2, 2, N1)
    for z in range(2):
        np.testing.assert_array_equal(
            circuit.priv_keyswitch(xs, pksk, z).numpy(), ref[z])


# ---------------------------------------------------------------------------
# ref_e2e_exact: the composed pipeline around the rotations
# ---------------------------------------------------------------------------

def e2e_abar():
    """preKS + preModSwitch on the dumped input: (n0 + 1,) int32, bbar
    last."""
    x1 = torch.from_numpy(i32(E2E, "input_lvl1.i32"))
    preks = lwe.KeySwitchKey.generate(_ones_key(N1), _ones_key(n0), P.ks10,
                                      frng(), keep_raw=False, device="cpu")
    u0 = lwe.keyswitch(x1[None], preks)[0]
    return T.mod_switch_from_torus32(u0, 2 * N2)


def test_e2e_premodswitch_matches():
    np.testing.assert_array_equal(e2e_abar().numpy(),
                                  i32(E2E, "premodswitch_out.i32"))


def test_e2e_cb_out_from_the_fixture_rotations(pksk):
    """extract + privKS rows of the fixture's own boot_w*.i64 == the patched
    reference's TGSW32 (cb_out.i32)."""
    ref = i32(E2E, "cb_out.i32").reshape(2, ELL1, 2, N1)
    for w in range(ELL1):
        x64 = torch.from_numpy(i64(E2E, f"boot_w{w}.i64"))
        for z in range(2):
            np.testing.assert_array_equal(
                circuit.priv_keyswitch(x64, pksk, z).numpy(), ref[z, w])


def poc_rotation(bk_rows, abar, mu1: int, device):
    """The patched PoC's circuitBootstrapWoKS (poc:530-659) through the
    port's CMux step on the chunked engine: test vector * X^{+bbar}, the
    +abar[i] steps (a zero exponent skipped, as the PoC does), extract
    coefficient 0, + mu2.  bk_rows: (n0, kpl, 2, N2) int64 on ``device``,
    prepared one step at a time."""
    p = P.tgsw_lvl2
    eng = engine.make_engine(tgsw.engine_config(p), "chunked")
    mu2 = mu1 >> 1
    tv = torch.full((N2,), mu2, dtype=torch.int64, device=device)
    tv[:N2 // 2] = -mu2
    acc = torch.zeros((1, 2, N2), dtype=torch.int64, device=device)
    acc[0, 1] = poly.mul_by_xai(torch.tensor(int(abar[n0]), device=device),
                                tv)
    for i in range(n0):
        if abar[i] == 0:
            continue
        a = torch.tensor([int(abar[i])], dtype=torch.int32, device=device)
        acc = blind_rotate.cmux_step(eng, a, acc, eng.prepare(bk_rows[i]), p)
    res = poly.sample_extract(acc, 0)[0]
    res[-1] += mu2
    return res.cpu().numpy()


def e2e_rotations_check(device):
    """Both levels' rotations bit for bit against boot_w*.i64 (the exact
    Karatsuba build), and their phases within 2^45 of the asm-FFT build's
    (tests/test_reference_e2e.py:198-214: 2x the measured envelope)."""
    abar = e2e_abar().numpy()
    ring2 = tlwe.TLweKey(P.lvl2, np.ones((1, N2), np.int32))
    gsw = tgsw.encrypt(ring2, np.ones(n0, np.int32), P.tgsw_lvl2, frng(),
                       stdev=P.bk_stdev, device=device)
    rows = tgsw.rows(gsw)                            # (n0, kpl, 2, N2)
    key = np.ones(N2, np.int64)
    for w in range(ELL1):
        ours = poc_rotation(rows, abar, 1 << (64 - (w + 1) * BG1), device)
        np.testing.assert_array_equal(ours, i64(E2E, f"boot_w{w}.i64"))
        ref = i64(E2E_FFT, f"boot_w{w}.i64")
        ph_ours = np.int64(ours[-1] - (ours[:-1] * key).sum())
        ph_ref = np.int64(ref[-1] - (ref[:-1] * key).sum())
        assert abs(int(np.int64(ph_ours - ph_ref))) < 1 << 45


@pytest.mark.slow
def test_e2e_rotations_on_the_cpu():
    e2e_rotations_check(torch.device("cpu"))


# ---------------------------------------------------------------------------
# ref_fft: spqlios parity
# ---------------------------------------------------------------------------

def test_ifft_int_matches_spqlios():
    """execute_reverse_int (fft_processor_spqlios.cpp:40-50) == the port's
    negacyclic_fft in the spqlios buffer layout, to f64 roundoff."""
    p2 = torch.from_numpy(patdigit(np.arange(N2), 256))
    ref = f64(FFTD, "ifft_int_out.f64")
    ours = fft.to_spqlios(fft.negacyclic_fft(p2, precision="highest"))
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-9 * np.abs(ref).max())


def test_ifft_torus64_matches_spqlios():
    """execute_reverse_torus64 (fft_processor_spqlios.cpp:162-170): int64
    loaded lossily into f64, then the same transform."""
    q2 = torch.from_numpy(pat64(np.arange(N2)).astype(np.float64))
    ref = f64(FFTD, "ifft_t64_out.f64")
    ours = fft.to_spqlios(fft.negacyclic_fft(q2, precision="highest"))
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-11 * np.abs(ref).max())


def test_fft_roundtrip_envelope():
    """The reference's torus64 round trip is within 2^14 of its input, and
    so is the port's transform pair on the same data."""
    q2 = pat64(np.arange(N2))
    err = np.abs((i64(FFTD, "fft_roundtrip_out.i64") - q2)
                 .astype(np.float64)).max()
    assert 0 < err < 2.0**14
    hat = fft.negacyclic_fft(torch.from_numpy(q2), precision="highest")
    back = fft.negacyclic_ifft(hat).numpy()
    assert np.abs(back - q2.astype(np.float64)).max() < 2.0**14


def test_bkfft_row_matches_spqlios():
    """bkFFT[0] row 0 (keygen iFFT, poc:395-402) == the port's transform of
    its own bk0 row (itself bit-exact to bk0.i64), in spqlios layout."""
    bk0 = tgsw.rows(_bk0())
    np.testing.assert_array_equal(
        bk0.numpy(), i64(EXACT, "bk0.i64").reshape(2 * P.tgsw_lvl2.l, 2, N2))
    ref = f64(FFTD, "bkfft0_row0.f64").reshape(2, N2)
    for q in range(2):
        ours = fft.to_spqlios(fft.negacyclic_fft(bk0[0, q].to(torch.float64),
                                                 precision="highest"))
        np.testing.assert_allclose(ours.numpy(), ref[q],
                                   atol=1e-11 * np.abs(ref[q]).max())
