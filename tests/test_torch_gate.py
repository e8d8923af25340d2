"""The port's gate bootstrap (tfhe_tpu_torch.boot.gate) against tfhe_tpu's
on the CPU, bit for bit, plus the port's package rules.

  * the same TfheRng seed gives byte-identical keys in both packages;
  * on keys carried across by tfhe_tpu_torch.convert, bootstraps and gates
    give identical ciphertexts, and they decrypt to the truth tables;
  * with no GPU, an entry point left at its default device raises and
    chip_smoke.py exits non-zero without a result;
  * no module of the port, and not chip_smoke.py, imports jax or tfhe_tpu.

Parameter sets: GATE_TOY, and GATE_FAST2's ring and gadget (k=2, N=512,
l=3, Bg=2^7, 3 key limbs) cut to n=8 blind-rotation steps.
"""

import ast
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tfhe_tpu.boot import gate as jgate
from tfhe_tpu.params import GATE_FAST2, GATE_TOY, GateParams, LweParams
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.boot import gate
from tfhe_tpu_torch.params import (GATE_FAST2 as T_FAST2,
                                   GATE_TOY as T_TOY, GateParams as TGate,
                                   LweParams as TLwe)
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.utils import observability as obs

REPO = Path(__file__).resolve().parent.parent
SHALLOW = GateParams(lwe=LweParams(n=8, stdev=2.0**-14), tgsw=GATE_FAST2.tgsw,
                     ks=GATE_FAST2.ks)
T_SHALLOW = TGate(lwe=TLwe(n=8, stdev=2.0**-14), tgsw=T_FAST2.tgsw,
                  ks=T_FAST2.ks)
CASES = {"toy": (GATE_TOY, T_TOY), "fast2_shallow": (SHALLOW, T_SHALLOW)}


def _jax_keys(jparams, backend, seed=0):
    rng = JRng(seed)
    sk = jgate.SecretKey.generate(jparams, rng)
    ck = jgate.CloudKey.generate(sk, rng, backend=backend)
    return rng, sk, ck


@pytest.mark.parametrize("case,backend", [("toy", "onthefly"),
                                          ("toy", "matmul"),
                                          ("fast2_shallow", "onthefly")])
def test_same_seed_same_keys(case, backend):
    jparams, tparams = CASES[case]
    jrng, jsk, jck = _jax_keys(jparams, backend, seed=3)
    rng = TfheRng(3)
    sk = gate.SecretKey.generate(tparams, rng)
    ck = gate.CloudKey.generate(sk, rng, backend=backend, device="cpu")
    np.testing.assert_array_equal(sk.lwe_key.key, jsk.lwe_key.key)
    np.testing.assert_array_equal(sk.ring_key.key, jsk.ring_key.key)
    (name, jbk), = jck.data["bk"].items()
    np.testing.assert_array_equal(ck.data["bk"][name].numpy(), np.asarray(jbk))
    jksw = np.asarray(jck.data["ksw"])
    ksw = ck.data["ksw"].numpy()
    np.testing.assert_array_equal(ksw[..., :jksw.shape[-1]], jksw)
    assert ksw.shape[-1] % 8 == 0 and not ksw[..., jksw.shape[-1]:].any()
    # both streams are in the same place after keygen
    np.testing.assert_array_equal(rng.uniform32((4,)), jrng.uniform32((4,)))


@functools.lru_cache(maxsize=None)
def _pair(case):
    """JAX keys + the same keys carried into the port, and shared inputs."""
    jparams, tparams = CASES[case]
    jrng, jsk, jck = _jax_keys(jparams, "onthefly", seed=1)
    sk = convert.secret_key_from_numpy(tparams, np.asarray(jsk.lwe_key.key),
                                       np.asarray(jsk.ring_key.key))
    jdata = {"bk": {k: np.asarray(v) for k, v in jck.data["bk"].items()},
             "ksw": np.asarray(jck.data["ksw"])}
    ck = convert.cloud_key_from_numpy(jdata, tparams, "onthefly",
                                      device="cpu")
    bits = {k: np.array(v) for k, v in
            dict(x=[0, 0, 1, 1, 0, 0, 1, 1], y=[0, 1, 0, 1, 0, 1, 0, 1],
                 c=[0, 0, 0, 0, 1, 1, 1, 1]).items()}
    cts = {k: np.asarray(jgate.encrypt_bool(jsk, v, jrng))
           for k, v in bits.items()}
    return jparams, tparams, jck, sk, ck, bits, cts


def _run_both(case, jfn, tfn, *names):
    jparams, tparams, jck, sk, ck, bits, cts = _pair(case)
    want = np.asarray(jfn(jck.data, *(cts[n] for n in names), jparams,
                          "onthefly"))
    got = tfn(ck.data, *(torch.from_numpy(cts[n]) for n in names), tparams,
              "onthefly")
    np.testing.assert_array_equal(got.numpy(), want)
    return gate.decrypt_bool(sk, got), bits


@pytest.mark.parametrize("case", sorted(CASES))
def test_bootstrap_bit_exact(case):
    jparams, tparams, jck, sk, ck, bits, cts = _pair(case)
    want = np.asarray(jgate.bootstrap(cts["x"], jck.data, jparams,
                                      backend="onthefly"))
    fn = gate.make_bootstrap_fn(tparams, backend="onthefly")
    before = obs.report()["counters"].get("bootstrap.ciphertexts", 0)
    got = fn(ck.data, torch.from_numpy(cts["x"]))
    assert obs.report()["counters"]["bootstrap.ciphertexts"] == before + 8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (gate.decrypt_bool(sk, got) == bits["x"].astype(bool)).all()


TRUTH = {"nand": lambda x, y: ~(x & y), "and": lambda x, y: x & y,
         "or": lambda x, y: x | y, "nor": lambda x, y: ~(x | y),
         "xor": lambda x, y: x ^ y, "xnor": lambda x, y: ~(x ^ y),
         "andny": lambda x, y: ~x & y, "andyn": lambda x, y: x & ~y,
         "orny": lambda x, y: ~x | y, "oryn": lambda x, y: x | ~y}


@pytest.mark.parametrize("case,name", [("toy", g) for g in TRUTH]
                         + [("fast2_shallow", "nand"),
                            ("fast2_shallow", "xor")])
def test_binary_gate_bit_exact(case, name):
    got, bits = _run_both(case, getattr(jgate, f"gate_{name}"),
                          getattr(gate, f"gate_{name}"), "x", "y")
    x, y = bits["x"].astype(bool), bits["y"].astype(bool)
    np.testing.assert_array_equal(got, TRUTH[name](x, y))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate_mux_bit_exact(case):
    got, bits = _run_both(case, jgate.gate_mux, gate.gate_mux, "c", "x", "y")
    np.testing.assert_array_equal(
        got, np.where(bits["c"], bits["x"], bits["y"]).astype(bool))


# ---------------------------------------------------------------------------
# device rules
# ---------------------------------------------------------------------------

@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_default_device_raises_without_gpu(no_gpu):
    rng = TfheRng(0)
    sk = gate.SecretKey.generate(T_TOY, rng)
    with pytest.raises(RuntimeError, match="CUDA"):
        gate.encrypt_bool(sk, [1, 0], rng)
    with pytest.raises(RuntimeError, match="CUDA"):
        gate.CloudKey.generate(sk, rng, backend="onthefly")


def test_chip_smoke_fails_without_gpu(no_gpu, tmp_path):
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:                  # a directory with nothing else
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# ---------------------------------------------------------------------------
# import rule
# ---------------------------------------------------------------------------

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_tfhe_tpu():
    files = sorted((REPO / "tfhe_tpu_torch").rglob("*.py"))
    assert len(files) >= 15
    for path in files + [REPO / "chip_smoke.py"]:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tfhe_tpu"), (path, mod)
