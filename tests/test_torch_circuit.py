"""The port's circuit bootstrap (tfhe_tpu_torch.boot.circuit), its LUT
evaluator and its noise worksheets against tfhe_tpu's, bit for bit, on the
CPU.

  * the same TfheRng seed gives byte-identical keys in both packages (preKS
    limbs, the chunked bk, K-packed, the privKS limbs), at CB_TOY and at the
    CB_MXU-gadget toy (Bg=2^8/l=5, 6-limb bk: CB_MXU's lvl2 geometry);
  * circuit_bootstrap, make_circuit_bootstrap_fn and _staged give identical
    TRGSWs, with one shared rotation and with one rotation per level;
  * keys carried across by tfhe_tpu_torch.convert give the same TRGSWs, and
    lut.eval_lut_batch on them selects the same TRLWEs;
  * importing the port's circuit modules loads neither jax nor tfhe_tpu.

Tolerance 0: every path is exact integer arithmetic.
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import lwe as jlwe, noise as jnoise, tgsw as jtgsw
from tfhe_tpu.boot import circuit as jcircuit
from tfhe_tpu.models import lut as jlut
from tfhe_tpu.params import (CB_ACTIVE, CB_MXU, CB_TOY, GATE_FAST2,
                             make_circuit_params)
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import convert, noise, tgsw, tlwe
from tfhe_tpu_torch import params as tparams
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import circuit
from tfhe_tpu_torch.models import lut
from tfhe_tpu_torch.ops import kernels as K
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import observability as obs

REPO = Path(__file__).resolve().parent.parent
_MXU_TOY = dict(n_lvl0=12, n_lvl1=64, n_lvl2=128, bgbit_lvl1=8, ell_lvl1=2,
                bgbit_lvl2=8, ell_lvl2=5, bk_stdev=2.0**-50,
                ks_stdev_10=2.0**-25, ks_len_10=6, ks_basebit_10=2,
                ks_stdev_21=2.0**-31, ks_len_21=10, ks_basebit_21=3,
                bk_limbs=6)
CASES = {"cb_toy": (CB_TOY, tparams.CB_TOY),
         "mxu_toy": (make_circuit_params(**_MXU_TOY),
                     tparams.make_circuit_params(**_MXU_TOY))}


@functools.lru_cache(maxsize=None)
def _keys(case, seed=42):
    """JAX keys and the port's keys from the same seed (chunked backend)."""
    jp, tp = CASES[case]
    jrng, rng = JRng(seed), TfheRng(seed)
    jsk = jcircuit.CircuitSecretKey.generate(jp, jrng)
    jck = jcircuit.CircuitCloudKey.generate(jsk, jrng, backend="chunked")
    sk = circuit.CircuitSecretKey.generate(tp, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked",
                                          device="cpu")
    return jsk, jck, sk, ck, jrng, rng


def _encrypt_bits(jsk, bits, seed):
    msgs = np.where(np.asarray(bits).astype(bool), -(1 << 31), 0)
    return np.array(jlwe.encrypt(jsk.lwe_lvl1, msgs.astype(np.int32),
                                 JRng(seed), 2.0**-20))


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_seed_same_keys(case):
    jsk, jck, sk, ck, jrng, rng = _keys(case)
    for mine, theirs in ((sk.key_lvl0, jsk.key_lvl0),
                         (sk.ring_lvl1, jsk.ring_lvl1),
                         (sk.ring_lvl2, jsk.ring_lvl2)):
        np.testing.assert_array_equal(mine.key, theirs.key)
    jpre = np.asarray(jck.data["preks"])
    pre = ck.data["preks"].numpy()
    np.testing.assert_array_equal(pre[..., :jpre.shape[-1]], jpre)
    assert not pre[..., jpre.shape[-1]:].any()
    # the 64-bit chunked key holds wmt alone: ck_wmt of JAX's wm
    assert set(ck.data["bk"]) == {"wmt"}
    np.testing.assert_array_equal(
        ck.data["bk"]["wmt"].numpy(),
        K.ck_wmt(torch.from_numpy(np.asarray(jck.data["bk"]["wm"]))).numpy())
    np.testing.assert_array_equal(ck.data["privks"].numpy(),
                                  np.asarray(jck.data["privks"]))
    # both streams are in the same place after keygen
    np.testing.assert_array_equal(rng.uniform32((4,)), jrng.uniform32((4,)))


@pytest.mark.parametrize("case,shared", [("cb_toy", True), ("cb_toy", False),
                                         ("mxu_toy", None)])
def test_circuit_bootstrap_bit_exact(case, shared):
    jp, tp = CASES[case]
    jsk, jck, sk, ck, _, _ = _keys(case)
    bits = np.array([0, 1, 1, 0])
    ct = _encrypt_bits(jsk, bits, 5)
    want = np.asarray(jcircuit.circuit_bootstrap(
        jnp.asarray(ct), jck.data, jp, backend="chunked",
        shared_rotation=shared))
    got = circuit.circuit_bootstrap(torch.from_numpy(ct), ck.data, tp,
                                    shared_rotation=shared)
    np.testing.assert_array_equal(got.numpy(), want)
    # the TRGSW rows (z=1, w) carry bit * h_w (tests/test_circuit_bootstrap)
    # within h_w/4, which a row of the wrong bit would not meet
    ph = tgsw.tgsw_phase(got, sk.ring_lvl1).to(torch.int64)
    for w in range(tp.tgsw_lvl1.l):
        h = 1 << (32 - (w + 1) * tp.tgsw_lvl1.bgbit)
        err = (ph[:, 1, w, 0] - torch.from_numpy(bits) * h).abs()
        assert int(err.max()) < h // 4
        assert int(ph[:, 1, w, 1:].abs().max()) < h // 4


def test_fn_and_staged_match_and_count():
    jp, tp = CASES["cb_toy"]
    jsk, jck, sk, ck, _, _ = _keys("cb_toy")
    ct = torch.from_numpy(_encrypt_bits(jsk, [1, 0, 1], 23))
    for sr in (True, False):
        want = circuit.circuit_bootstrap(ct, ck.data, tp, shared_rotation=sr)
        got = circuit.make_circuit_bootstrap_fn(tp, shared_rotation=sr)(
            ct, ck.data)
        assert torch.equal(got, want)
        before = obs.report()["counters"].get("bootstrap.circuit_launches", 0)
        got = circuit.make_circuit_bootstrap_staged(tp, shared_rotation=sr)(
            ct, ck.data)
        assert torch.equal(got, want)
        assert (obs.report()["counters"]["bootstrap.circuit_launches"]
                == before + 1)
    spans = obs.report()["spans"]
    for stage in ("preks", "bk_encrypt", "privks", "bk_prepare"):
        assert spans[f"keygen.circuit.{stage}"]["count"] >= 1


def test_priv_keyswitch_matches_jax():
    jp, tp = CASES["cb_toy"]
    jsk, jck, sk, ck, _, _ = _keys("cb_toy")
    x = np.random.default_rng(3).integers(-2**63, 2**63, (3, tp.n_lvl2 + 1),
                                          dtype=np.int64)
    x[0, :2] = [-2**63, 2**63 - 1]
    jpk = jcircuit.PrivKeySwitchKey(jp.ks21, jp.n_lvl2, 1, jp.n_lvl1,
                                    jck.data["privks"])
    np.testing.assert_array_equal(
        circuit.priv_keyswitch_digits(torch.from_numpy(x), tp.ks21).numpy(),
        np.asarray(jcircuit.priv_keyswitch_digits(jnp.asarray(x), jp.ks21)))
    for z in (0, 1):
        np.testing.assert_array_equal(
            circuit.priv_keyswitch(torch.from_numpy(x), ck.privks, z).numpy(),
            np.asarray(jcircuit.priv_keyswitch(jnp.asarray(x), jpk, z)))


@functools.lru_cache(maxsize=None)
def _converted():
    """JAX keys carried into the port, and a TRGSW batch of 4-bit selectors
    for two LUT instances, bootstrapped by the port on its own keys from the
    same seed (equal to JAX's: test_same_seed_same_keys)."""
    jp, tp = CASES["cb_toy"]
    jsk, jck, _, native, _, _ = _keys("cb_toy")
    sk = convert.circuit_secret_key_from_numpy(
        tp, jsk.key_lvl0.key, jsk.ring_lvl1.key, jsk.ring_lvl2.key)
    data = {"preks": np.asarray(jck.data["preks"]),
            "bk": {"wm": np.asarray(jck.data["bk"]["wm"])},
            "privks": np.asarray(jck.data["privks"])}
    ck = convert.circuit_cloud_key_from_numpy(data, tp, "chunked",
                                              device="cpu")
    idx = np.array([11, 6])
    bits = ((idx[:, None] >> np.arange(4)) & 1).reshape(-1)
    ct = _encrypt_bits(jsk, bits, 31)
    gsw = circuit.circuit_bootstrap(torch.from_numpy(ct), native.data,
                                    tp).numpy()
    return sk, ck, ct, gsw, idx


def test_convert_round_trip():
    jp, tp = CASES["cb_toy"]
    sk, ck, ct, gsw, _ = _converted()
    _, _, native_sk, native, _, _ = _keys("cb_toy")
    for mine, theirs in ((sk.key_lvl0, native_sk.key_lvl0),
                         (sk.ring_lvl1, native_sk.ring_lvl1),
                         (sk.ring_lvl2, native_sk.ring_lvl2)):
        np.testing.assert_array_equal(mine.key, theirs.key)
    for name in ("preks", "privks"):
        assert torch.equal(ck.data[name], native.data[name])
    assert set(ck.data["bk"]) == set(native.data["bk"]) == {"wmt"}
    assert torch.equal(ck.data["bk"]["wmt"], native.data["bk"]["wmt"])
    got = circuit.circuit_bootstrap(torch.from_numpy(ct), ck.data, tp)
    np.testing.assert_array_equal(got.numpy(), gsw)
    with pytest.raises(ValueError, match="expects bk key"):
        convert.circuit_cloud_key_from_numpy(
            {"preks": ck.data["preks"].numpy(), "bk": {"v": 0},
             "privks": ck.data["privks"].numpy()}, tp, "chunked",
            device="cpu")


@pytest.mark.parametrize("backend", ["matmul", "onthefly"])
def test_eval_lut_batch_matches_jax(backend):
    jp, tp = CASES["cb_toy"]
    sk, ck, ct, gsw, idx = _converted()
    perm = np.random.default_rng(4).permutation(16)
    table = (perm.astype(np.int64) << 28).astype(np.uint32).astype(np.int32)
    sel = gsw.reshape(2, 4, *gsw.shape[1:])
    want = np.asarray(jax.jit(jlut.eval_lut_batch, static_argnums=(2, 3))(
        jnp.asarray(sel), jnp.asarray(table), jp.tgsw_lvl1, "matmul"))
    got = lut.eval_lut_batch(torch.from_numpy(sel), torch.from_numpy(table),
                             tp.tgsw_lvl1, backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)
    # the single-instance entry point on instance 1's selectors
    sels = [tgsw.prepare(torch.from_numpy(sel[1, j]), tp.tgsw_lvl1,
                         backend)[1] for j in range(4)]
    assert torch.equal(lut.eval_lut(sels, torch.from_numpy(table),
                                    tp.tgsw_lvl1, backend), got[1])
    ph = tlwe.tlwe_phase(got, sk.ring_lvl1)[:, 0]
    dec = ((ph.to(torch.int64) + (1 << 27)) >> 28) & 15
    np.testing.assert_array_equal(dec.numpy(), perm[idx])


def test_tgsw32_external_product_and_cmux_match_jax():
    """The 32-bit TRGSW layer the LUT and the checks run on, with a
    circuit-bootstrapped selector."""
    jp, tp = CASES["cb_toy"]
    _, _, _, gsw, _ = _converted()
    r = np.random.default_rng(7)
    d0 = r.integers(-2**31, 2**31, (3, 2, tp.n_lvl1)).astype(np.int32)
    d1 = r.integers(-2**31, 2**31, (3, 2, tp.n_lvl1)).astype(np.int32)
    _, jprep = jtgsw.prepare(jnp.asarray(gsw[0]), jp.tgsw_lvl1, "matmul")
    for backend in ("matmul", "onthefly"):
        _, prep = tgsw.prepare(torch.from_numpy(gsw[0]), tp.tgsw_lvl1,
                               backend)
        np.testing.assert_array_equal(
            tgsw.external_product(torch.from_numpy(d0), prep, tp.tgsw_lvl1,
                                  backend).numpy(),
            np.asarray(jtgsw.external_product(jnp.asarray(d0), jprep,
                                              jp.tgsw_lvl1)))
        np.testing.assert_array_equal(
            tgsw.cmux(prep, torch.from_numpy(d1), torch.from_numpy(d0),
                      tp.tgsw_lvl1, backend).numpy(),
            np.asarray(jtgsw.cmux(jprep, jnp.asarray(d1), jnp.asarray(d0),
                                  jp.tgsw_lvl1)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flip", [None, 1, 0])
def test_smoke_checks_catch_a_level1_flip(flip):
    """chip_smoke's TRGSW row and CMux checks (phase 5) at CB_MXU's lvl1
    gadget (Bg=2^8, l=2): they pass a true TRGSW batch and fail one whose
    level-1 row of an instance encodes the other bit (flip = that bit)."""
    cs = _chip_smoke()
    _, tp = CASES["mxu_toy"]
    jsk, _, sk, ck, _, _ = _keys("mxu_toy")
    bits = np.array([0, 1, 1, 0])
    gsw = circuit.circuit_bootstrap(
        torch.from_numpy(_encrypt_bits(jsk, bits, 11)), ck.data, tp)
    if flip is None:
        cs.check_trgsw_rows(gsw, bits, sk, tp)
        cs.check_cmux(gsw, bits, sk, tp)
        return
    i = int(np.flatnonzero(bits == flip)[0])
    h1 = 1 << (32 - 2 * tp.tgsw_lvl1.bgbit)
    b = gsw[i, 1, 1, 1, 0].to(torch.int64) + (h1 if flip == 0 else -h1)
    gsw[i, 1, 1, 1, 0] = T.wrap32(b)
    for check in (cs.check_trgsw_rows, cs.check_cmux):
        with pytest.raises(cs.SmokeFailure):
            check(gsw, bits, sk, tp)


@pytest.mark.parametrize("name", ["CB_TOY", "CB_MXU", "CB_ACTIVE"])
def test_noise_worksheets_match_jax(name):
    jp = {"CB_TOY": CB_TOY, "CB_MXU": CB_MXU, "CB_ACTIVE": CB_ACTIVE}[name]
    tp = getattr(tparams, name)
    assert (noise.circuit_bootstrap_variances(tp).__dict__
            == jnoise.circuit_bootstrap_variances(jp).__dict__)
    assert noise.shared_rotation_penalty(tp) == jnoise.shared_rotation_penalty(jp)
    g, tg = GATE_FAST2, tparams.GATE_FAST2
    assert (noise.gate_bootstrap_variances(tg).__dict__
            == jnoise.gate_bootstrap_variances(g).__dict__)
    assert noise.key_truncation_variance(tg) == jnoise.key_truncation_variance(g)
    assert (noise.nussbaumer_fold_variance(tg)
            == jnoise.nussbaumer_fold_variance(g))
    if name == "CB_MXU":        # the slice runs two separate rotations
        assert noise.shared_rotation_penalty(tp) > \
            noise.SHARED_ROTATION_MAX_PENALTY


# ---------------------------------------------------------------------------
# device and import rules
# ---------------------------------------------------------------------------

def test_circuit_keygen_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    sk = circuit.CircuitSecretKey.generate(tparams.CB_TOY, TfheRng(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        circuit.CircuitCloudKey.generate(sk, TfheRng(1))


def test_circuit_modules_load_no_jax():
    code = ("import sys; import tfhe_tpu_torch.boot.circuit, "
            "tfhe_tpu_torch.models.lut, tfhe_tpu_torch.convert, "
            "tfhe_tpu_torch.noise; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tfhe_tpu')); assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
