"""The port's sharded circuit bootstrap (tfhe_tpu_torch.parallel.shard's
make_sharded_circuit_bootstrap_fn) against tfhe_tpu's, bit for bit, on the
CPU, on the chunked and conv backends.

As in tests/test_torch_parallel.py, this file run as a script is the
worker, started four times by ``multihost.launch`` (gloo on the CPU, a file
store, no JAX); it draws CB_TOY keys from the JAX package's seed, reads
the ciphertexts the JAX package encrypted and writes each rank's TRGSW rows
with np.save.  Every case of tests/test_shard_circuit.py that fits four
ranks has its counterpart: dp x ep = 2 x 2 (the JAX test's 4 x 2), 1 x 4
(ep=4 divides kpl2=8) and a dp-only 4 x 1, both shared-rotation modes, and
the kpl2 error; plus the preKS- and privKS-row errors, and the rank's bk
slice built from the raw TRGSW rows against its slice of the whole
prepared key (the 2 x 2 and 1 x 4 cases run on the former).  References:
``tfhe_tpu.boot.circuit.circuit_bootstrap`` (jitted) and, at 2 x 2 on the
chunked backend, ``tfhe_tpu.parallel.shard`` on conftest's virtual mesh.

Tolerance 0: every path is exact integer arithmetic.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
BACKENDS = ("chunked", "conv")
MESHES = ((2, 2), (1, 4), (4, 1))
# CB_TOY with a privKS of (n2+1)*5*2 rows (1,290: ep=4 does not divide it)
# and a preKS of n1*5*4 rows (1,280: ep=3 does not), kpl2 = 2*l2 = 4 and 6
_ROW_ERRORS = {
    4: dict(n_lvl0=12, n_lvl1=64, n_lvl2=128, bgbit_lvl1=8, ell_lvl1=2,
            bgbit_lvl2=9, ell_lvl2=2, bk_stdev=2.0**-50,
            ks_stdev_10=2.0**-25, ks_len_10=6, ks_basebit_10=2,
            ks_stdev_21=2.0**-31, ks_len_21=5, ks_basebit_21=1),
    3: dict(n_lvl0=12, n_lvl1=64, n_lvl2=128, bgbit_lvl1=8, ell_lvl1=2,
            bgbit_lvl2=9, ell_lvl2=3, bk_stdev=2.0**-50,
            ks_stdev_10=2.0**-25, ks_len_10=5, ks_basebit_10=2,
            ks_stdev_21=2.0**-31, ks_len_21=10, ks_basebit_21=3)}


def _worker(out: Path):
    import torch
    torch.set_num_threads(1)
    from tfhe_tpu_torch.boot import circuit
    from tfhe_tpu_torch.params import CB_TOY, make_circuit_params
    from tfhe_tpu_torch.parallel import multihost, shard
    from tfhe_tpu_torch.rng import TfheRng

    multihost.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    inputs = np.load(out / "inputs.npz")
    ct, ct4 = (torch.from_numpy(inputs[k]) for k in ("ct", "ct4"))
    record = {}

    def save(name, rows):
        np.save(out / f"{name}-r{rank}.npy", rows.numpy())

    for backend in BACKENDS:
        rng = TfheRng(42)
        sk = circuit.CircuitSecretKey.generate(CB_TOY, rng)
        ck = circuit.CircuitCloudKey.generate(sk, rng, backend=backend,
                                              keep_raw_bk=True, device="cpu")
        raw = dict(ck.data, bk=None)
        for dp, ep in MESHES:
            m = shard.make_mesh(dp * ep, dp=dp, ep=ep, device="cpu")
            fn, place = shard.make_sharded_circuit_bootstrap_fn(
                CB_TOY, m, backend=backend)
            whole, _ = place(ck.data, ct)
            kd, rows = place(raw, ct, bk_raw=ck.bk_raw)
            (name, leaf), = kd["bk"].items()
            record[f"{backend}-{dp}x{ep}"] = {
                "bk_shape": list(leaf.shape),
                "raw_equals_whole": all(torch.equal(kd[n], whole[n])
                                        for n in ("preks", "privks"))
                and torch.equal(leaf, whole["bk"][name])}
            save(f"{backend}-{dp}x{ep}", fn(kd, rows))
            if backend == "chunked" and (dp, ep) == (2, 2):
                for sr in (True, False):
                    fn, place = shard.make_sharded_circuit_bootstrap_fn(
                        CB_TOY, m, backend=backend, shared_rotation=sr)
                    save(f"shared{int(sr)}", fn(*place(raw, ct4,
                                                       bk_raw=ck.bk_raw)))
        del ck, raw

    errors = {}
    for ep in (3, 4):
        m = shard.make_mesh(ep, dp=1, ep=ep, device="cpu")
        for name, p in (("CB_TOY", CB_TOY),
                        ("rows", make_circuit_params(**_ROW_ERRORS[ep]))):
            try:
                shard.make_sharded_circuit_bootstrap_fn(p, m, "chunked")
                errors[f"{name}-{ep}"] = None
            except ValueError as e:
                errors[f"{name}-{ep}"] = str(e)
    record["errors"] = errors
    (out / f"record-r{rank}.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from tfhe_tpu import lwe as jlwe
    from tfhe_tpu.boot import circuit as jcircuit
    from tfhe_tpu.params import CB_TOY
    from tfhe_tpu.rng import TfheRng as JRng

    def enc(sk, bits, seed):
        msgs = np.where(np.asarray(bits).astype(bool), np.int32(-(1 << 31)),
                        0).astype(np.int32)
        return np.asarray(jlwe.encrypt(sk.lwe_lvl1, msgs, JRng(seed),
                                       2.0**-20))

    bits = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    out = {"bits": bits}
    for backend in BACKENDS:
        rng = JRng(42)
        sk = jcircuit.CircuitSecretKey.generate(CB_TOY, rng)
        ck = jcircuit.CircuitCloudKey.generate(sk, rng, backend=backend)
        ct = enc(sk, bits, 5)
        ct4 = np.concatenate([enc(sk, [1, 0], 9)] * 2)
        out[backend] = {"sk": sk, "ck": ck}
        for sr in ((None, True, False) if backend == "chunked" else (None,)):
            f = jax.jit(lambda c, k, sr=sr, b=backend: jcircuit.circuit_bootstrap(
                c, k, CB_TOY, backend=b, shared_rotation=sr))
            out[backend][sr] = np.asarray(f(jnp.asarray(
                ct if sr is None else ct4), ck.data))
    out["ct"], out["ct4"] = ct, ct4
    return out


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    from tfhe_tpu_torch.parallel import multihost
    out = tmp_path_factory.mktemp("shard_circuit")
    np.savez(out / "inputs.npz", ct=jx["ct"], ct4=jx["ct4"])
    multihost.launch([sys.executable, __file__, str(out)], WORLD,
                     coordinator_address=f"file://{out}/store",
                     env={"PYTHONPATH": str(REPO)}, timeout=300)
    return out


def _rows(out: Path, name: str, dp: int, ep: int) -> np.ndarray:
    """The global batch of a (dp, ep) mesh's per-rank files; every ep rank
    of a dp block must hold the same rows."""
    blocks = []
    for d in range(dp):
        parts = [np.load(out / f"{name}-r{d * ep + e}.npy")
                 for e in range(ep)]
        for e in range(1, ep):
            np.testing.assert_array_equal(parts[e], parts[0])
        blocks.append(parts[0])
    return np.concatenate(blocks)


def _record(out: Path, rank: int) -> dict:
    return json.loads((out / f"record-r{rank}.json").read_text())


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_cb_matches_unsharded(jx, ranks, backend):
    """dp=2 x ep=2: bit-identical to the single-device pipeline, and every
    TRGSW row (z=1, w) decrypts to bit * h_w."""
    import jax.numpy as jnp
    from tfhe_tpu import tgsw as jtgsw
    from tfhe_tpu.params import CB_TOY
    got = _rows(ranks, f"{backend}-2x2", 2, 2)
    np.testing.assert_array_equal(got, jx[backend][None])
    ph = np.asarray(jtgsw.tgsw_phase(jnp.asarray(got),
                                     jx[backend]["sk"].ring_lvl1))
    for b, bit in enumerate(jx["bits"]):
        for w in range(CB_TOY.tgsw_lvl1.l):
            h = 1 << (32 - (w + 1) * CB_TOY.tgsw_lvl1.bgbit)
            assert abs(int(ph[b, 1, w, 0]) - bit * h) < 2**22, (b, w)
            assert np.abs(ph[b, 1, w, 1:]).max() < 2**22


def test_sharded_cb_matches_jax_shard_map(jx, ranks):
    """dp=2 x ep=2 on the chunked backend: equal to tfhe_tpu.parallel.
    shard's shard_map circuit bootstrap on the virtual mesh."""
    import jax.numpy as jnp
    from tfhe_tpu.params import CB_TOY
    from tfhe_tpu.parallel import shard as jshard
    m = jshard.make_mesh(4, dp=2, ep=2)
    fn, place = jshard.make_sharded_circuit_bootstrap_fn(CB_TOY, m,
                                                         backend="chunked")
    kd, cts = place(jx["chunked"]["ck"].data, jnp.asarray(jx["ct"]))
    np.testing.assert_array_equal(_rows(ranks, "chunked-2x2", 2, 2),
                                  np.asarray(fn(kd, cts)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_cb_ep4_and_dp_only(jx, ranks, backend):
    """Other mesh shapes: ep=4 (kpl2=8 divides) and a dp-only mesh."""
    for dp, ep in ((1, 4), (4, 1)):
        np.testing.assert_array_equal(
            _rows(ranks, f"{backend}-{dp}x{ep}", dp, ep), jx[backend][None],
            err_msg=f"dp={dp} ep={ep}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_circuit_key_division(ranks, backend):
    """Each rank holds J/ep of the lvl2 bk (chunked wmt (n, U*L, N+m, J*m)
    on its last axis, conv (n, J*U*L, 1, 2N-1) on axis 1), and the slice
    built from the raw TRGSW rows equals the slice of the whole key."""
    from tfhe_tpu.params import CB_TOY
    J, m = CB_TOY.tgsw_lvl2.kpl, 64
    for dp, ep in MESHES:
        for rank in range(dp * ep):
            rec = _record(ranks, rank)[f"{backend}-{dp}x{ep}"]
            assert rec["raw_equals_whole"], (dp, ep, rank)
            if backend == "chunked":
                assert rec["bk_shape"][-1] == J // ep * m
            else:
                assert rec["bk_shape"][1] * ep == J * 2 * 8


def test_sharded_cb_bad_ep_raises(ranks):
    """ep not dividing kpl2 (CB_TOY kpl2=8, ep=3) is a clear ValueError, and
    so are preKS or privKS rows that ep does not divide."""
    for rank in range(4):
        errors = _record(ranks, rank)["errors"]
        assert "kpl" in errors["CB_TOY-3"]
        assert errors["CB_TOY-4"] is None
        assert "preKS" in errors["rows-3"]
        assert "privKS" in errors["rows-4"]


def test_sharded_cb_shared_rotation_modes(jx, ranks):
    """Both rotation modes run sharded and agree with their unsharded
    counterparts."""
    for sr in (True, False):
        np.testing.assert_array_equal(_rows(ranks, f"shared{int(sr)}", 2, 2),
                                      jx["chunked"][sr])


def test_circuit_unknown_backend_raises():
    from tfhe_tpu_torch.parallel import shard
    with pytest.raises(ValueError, match="not defined"):
        shard._cb_bk_ep_spec("onthefly")


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
