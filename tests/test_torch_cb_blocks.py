"""The reference's circuit-bootstrapping blocks in the port (CB_PAPER,
CB_ALT_180MS, CB_ALT_155MS, CB_ACTIVE; poc_CircuitBootstrapping.cpp:18-85)
against tfhe_tpu, bit for bit, on the CPU.

  * the four presets equal JAX's field for field, and so do their noise
    worksheets and the shared-rotation decision (refused for all four);
  * at toy widths (n0=12, N1=64, N2=128) with each block's gadgets,
    key-switch geometry and the whole 8-limb lvl2 key: same-seed keys are
    equal, convert carries JAX's circuit key across, and circuit_bootstrap
    and the staged form equal JAX's on the chunked backend with one
    rotation per level; CB_PAPER's toy also under each TFHE_CK64_* step;
  * chip_smoke.py's phase-12 checks pass true TRGSWs and fail a planted
    level-1 flip (the probe rule: a row off by 2^-7).

Tolerance 0: every path is exact integer arithmetic.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tfhe_tpu import lwe as jlwe, noise as jnoise, params as jparams
from tfhe_tpu.boot import circuit as jcircuit
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import convert, noise, tgsw
from tfhe_tpu_torch import params as tparams
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import circuit
from tfhe_tpu_torch.ops import engine, kernels as K
from tfhe_tpu_torch.rng import TfheRng

REPO = Path(__file__).resolve().parent.parent
BLOCKS = ("CB_PAPER", "CB_ALT_180MS", "CB_ALT_155MS", "CB_ACTIVE")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Toy shapes run faster on one thread than on a shared pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(name: str) -> dict:
    """Toy widths with ``name``'s gadgets and key-switch geometry, the whole
    8-limb lvl2 key (bk_limbs = 0) and small noise."""
    P = getattr(tparams, name)
    return dict(n_lvl0=12, n_lvl1=64, n_lvl2=128,
                bgbit_lvl1=P.tgsw_lvl1.bgbit, ell_lvl1=P.tgsw_lvl1.l,
                bgbit_lvl2=P.tgsw_lvl2.bgbit, ell_lvl2=P.tgsw_lvl2.l,
                bk_stdev=2.0**-50, ks_stdev_10=2.0**-25, ks_len_10=P.ks10.t,
                ks_basebit_10=P.ks10.basebit, ks_stdev_21=2.0**-31,
                ks_len_21=P.ks21.t, ks_basebit_21=P.ks21.basebit)


@functools.lru_cache(maxsize=None)
def _params(name):
    return (jparams.make_circuit_params(**_toy(name)),
            tparams.make_circuit_params(**_toy(name)))


@functools.lru_cache(maxsize=None)
def _keys(name, seed=42):
    """JAX keys and the port's keys from the same seed (chunked backend)."""
    jp, tp = _params(name)
    jrng, rng = JRng(seed), TfheRng(seed)
    jsk = jcircuit.CircuitSecretKey.generate(jp, jrng)
    jck = jcircuit.CircuitCloudKey.generate(jsk, jrng, backend="chunked")
    sk = circuit.CircuitSecretKey.generate(tp, rng)
    ck = circuit.CircuitCloudKey.generate(sk, rng, backend="chunked",
                                          device="cpu")
    return jsk, jck, sk, ck, jrng, rng


BITS = np.array([0, 1, 1, 0])


@functools.lru_cache(maxsize=None)
def _jax_trgsw(name):
    """JAX's staged circuit bootstrap (jitted programs), one rotation per
    level, of BITS: (ciphertexts, TRGSWs)."""
    jp, _ = _params(name)
    jsk, jck = _keys(name)[:2]
    msgs = np.where(BITS.astype(bool), -(1 << 31), 0).astype(np.int32)
    ct = np.array(jlwe.encrypt(jsk.lwe_lvl1, msgs, JRng(5), 2.0**-20))
    fn = jcircuit.make_circuit_bootstrap_staged(jp, backend="chunked",
                                                shared_rotation=False)
    return ct, np.asarray(fn(jnp.asarray(ct), jck.data))


# ---------------------------------------------------------------------------
# the presets and their worksheets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", BLOCKS)
def test_block_params_match_jax(name):
    mine, theirs = getattr(tparams, name), getattr(jparams, name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    # the reference's blocks: lvl2 at Bg = 2^9 (two int8 digit planes) and
    # the whole 8-limb key
    assert mine.tgsw_lvl2.bgbit == 9 and mine.tgsw_lvl2.key_limbs == 0
    cfg = tgsw.engine_config(mine.tgsw_lvl2)
    assert cfg.plane_split[1] == 2 and cfg.num_limbs == 8


@pytest.mark.parametrize("name", BLOCKS)
def test_block_noise_matches_jax(name):
    mine, theirs = getattr(tparams, name), getattr(jparams, name)
    assert (noise.circuit_bootstrap_variances(mine).__dict__
            == jnoise.circuit_bootstrap_variances(theirs).__dict__)
    pen = noise.shared_rotation_penalty(mine)
    assert pen == jnoise.shared_rotation_penalty(theirs)
    # the shared rotation is refused at every block (CB_PAPER: the
    # decomposition tail amplified by 2^(2*8*3))
    assert pen > noise.SHARED_ROTATION_MAX_PENALTY
    assert (jnoise.shared_rotation_penalty(theirs)
            > jnoise.SHARED_ROTATION_MAX_PENALTY)


# ---------------------------------------------------------------------------
# toy widths at each block's geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", BLOCKS)
def test_same_seed_same_keys(name):
    jsk, jck, sk, ck, jrng, rng = _keys(name)
    for mine, theirs in ((sk.key_lvl0, jsk.key_lvl0),
                         (sk.ring_lvl1, jsk.ring_lvl1),
                         (sk.ring_lvl2, jsk.ring_lvl2)):
        np.testing.assert_array_equal(mine.key, theirs.key)
    jpre = np.asarray(jck.data["preks"])
    pre = ck.data["preks"].numpy()
    np.testing.assert_array_equal(pre[..., :jpre.shape[-1]], jpre)
    assert not pre[..., jpre.shape[-1]:].any()
    tp = _params(name)[1]
    wmt = ck.data["bk"]["wmt"]
    assert set(ck.data["bk"]) == {"wmt"}
    assert tuple(wmt.shape) == (tp.n_lvl0, 2 * 8, tp.n_lvl2 + 64,
                                2 * tp.tgsw_lvl2.l * 64)
    np.testing.assert_array_equal(
        wmt.numpy(),
        K.ck_wmt(torch.from_numpy(np.asarray(jck.data["bk"]["wm"]))).numpy())
    # privKS rows: (N2 + 1) * t * base at the block's key-switch geometry
    ks = tp.ks21
    assert ck.data["privks"].shape[2] == (tp.n_lvl2 + 1) * ks.t * ks.base
    np.testing.assert_array_equal(ck.data["privks"].numpy(),
                                  np.asarray(jck.data["privks"]))
    np.testing.assert_array_equal(rng.uniform32((4,)), jrng.uniform32((4,)))


@pytest.mark.parametrize("name", BLOCKS)
def test_circuit_bootstrap_bit_exact(name):
    """circuit_bootstrap and the staged form against JAX's staged programs,
    one rotation per level (what the shared-rotation rule decides at the
    blocks)."""
    _, tp = _params(name)
    ct, want = _jax_trgsw(name)
    ck = _keys(name)[3]
    got = circuit.circuit_bootstrap(torch.from_numpy(ct), ck.data, tp,
                                    shared_rotation=False)
    np.testing.assert_array_equal(got.numpy(), want)
    staged = circuit.make_circuit_bootstrap_staged(tp, shared_rotation=False)
    np.testing.assert_array_equal(staged(torch.from_numpy(ct),
                                         ck.data).numpy(), want)


@pytest.mark.parametrize("name", BLOCKS)
def test_convert_carries_jax_key(name):
    """JAX's circuit key (its chunked wm) carried into the port equals the
    port's own key from the same seed, and bootstraps to JAX's TRGSWs."""
    _, tp = _params(name)
    jsk, jck, _, native, _, _ = _keys(name)
    data = {"preks": np.asarray(jck.data["preks"]),
            "bk": {"wm": np.asarray(jck.data["bk"]["wm"])},
            "privks": np.asarray(jck.data["privks"])}
    ck = convert.circuit_cloud_key_from_numpy(data, tp, "chunked",
                                              device="cpu")
    for key in ("preks", "privks"):
        assert torch.equal(ck.data[key], native.data[key])
    assert torch.equal(ck.data["bk"]["wmt"], native.data["bk"]["wmt"])
    ct, want = _jax_trgsw(name)
    got = circuit.circuit_bootstrap(torch.from_numpy(ct), ck.data, tp,
                                    shared_rotation=False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("env,method", [
    (("TFHE_CK64_PATH", "acc"), "cmux_step_acc"),
    (("TFHE_CK64_PATH", "sacc"), "cmux_step_sacc"),
    (("TFHE_CK64_FUSED", "1"), "cmux_step_flat")])
def test_paper_toy_each_ck64_step(monkeypatch, env, method):
    """CB_PAPER's toy under each opt-in 64-bit step equals JAX's TRGSWs (the
    default step's), and every lvl2 step went through the selected engine
    method: n0 steps for each of the l1 = 4 rotations."""
    _, tp = _params("CB_PAPER")
    ct, want = _jax_trgsw("CB_PAPER")
    ck = _keys("CB_PAPER")[3]
    calls = []
    real = getattr(engine.ChunkedEngine, method)

    def spy(self, *a, **kw):
        calls.append(method)
        return real(self, *a, **kw)

    monkeypatch.setattr(engine.ChunkedEngine, method, spy)
    monkeypatch.setenv(*env)
    got = circuit.circuit_bootstrap(torch.from_numpy(ct), ck.data, tp,
                                    shared_rotation=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(calls) == tp.n_lvl0 * tp.tgsw_lvl1.l


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-12 checks
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cleared_levels():
    """The levels whose h_w/4 clears 6 sigma of the worksheet: both of
    CB_MXU's and CB_ACTIVE's, the top two of CB_PAPER's four."""
    cs = _chip_smoke()
    assert cs.cleared_levels(tparams.CB_MXU) == [0, 1]
    assert cs.cleared_levels(tparams.CB_ACTIVE) == [0, 1]
    assert cs.cleared_levels(tparams.CB_PAPER) == [0, 1]


@pytest.mark.parametrize("flip", [None, 1, 0])
def test_phase12_checks_catch_a_level1_flip(flip):
    """At CB_PAPER's lvl1 gadget (l1 = 4): the probe rule, h_w/4 at the
    cleared levels and the CMux on level 1 pass true TRGSWs; the last two
    fail a batch whose level-1 (z=1) row of an instance encodes the other
    bit, the probe rule one whose level-0 row is off by 2^-7."""
    cs = _chip_smoke()
    _, tp = _params("CB_PAPER")
    sk = _keys("CB_PAPER")[2]
    _, gsw = _jax_trgsw("CB_PAPER")
    gsw = torch.from_numpy(gsw.copy())
    levels = cs.cleared_levels(tparams.CB_PAPER)
    checks = (lambda g: cs.check_trgsw_probe(g, BITS, sk, tp),
              lambda g: cs.check_trgsw_rows(g, BITS, sk, tp, levels),
              lambda g: cs.check_cmux(g, BITS, sk, tp, level=levels[-1]))
    if flip is None:
        for check in checks:
            check(gsw)
        return
    i = int(np.flatnonzero(BITS == flip)[0])
    h1 = 1 << (32 - 2 * tp.tgsw_lvl1.bgbit)
    # the probe's limit, 2^-8 of the torus, is h_0 itself: a level-0 flip
    # lies on it, give or take the noise, so that rule gets a level-0 row
    # off by 2^-7 instead
    for check, w, h in zip(checks, (0, 1, 1), (1 << 25, h1, h1)):
        bad = gsw.clone()
        b = bad[i, 1, w, 1, 0].to(torch.int64) + (h if flip == 0 else -h)
        bad[i, 1, w, 1, 0] = T.wrap32(b)
        with pytest.raises(cs.SmokeFailure):
            check(bad)
