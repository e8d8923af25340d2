"""The port's dp x ep and dp x tp gate bootstraps (tfhe_tpu_torch.parallel
shard and mesh) against tfhe_tpu's, bit for bit, on the CPU.

The ranks are real processes: this file run as a script is the worker
(``python tests/test_torch_parallel.py OUTDIR``), started four times by
``multihost.launch`` with gloo on the CPU from a file store under the
test's temporary directory (no ports).  The workers import no JAX: they
draw the keys from the same TfheRng seed as the JAX package, read the
ciphertexts the JAX package encrypted (``inputs.npz``), run every case of
tests/test_shard_map.py that fits four ranks and write each rank's rows
with np.save; the pytest process compares them with
``tfhe_tpu.boot.gate.bootstrap`` and, at (dp, ep) = (2, 2) and (dp, tp) =
(2, 2), with ``tfhe_tpu.parallel`` on conftest's 8-device virtual mesh.
Also: the exact all-reduce at INT32/INT64 extremes over 2, 3 and 4 ranks,
the error cases, ``pad_batch``, and that the parallel modules import
neither jax nor tfhe_tpu.

Tolerance 0: every path is exact integer arithmetic.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
# tests/test_shard_map.py's (dp, ep) meshes that fit four ranks, and ep=3
GATE_MESHES = ((4, 1), (2, 2), (1, 2), (1, 3))
I32 = (-2**31, 2**31 - 1)
I64 = (-2**63, 2**63 - 1)


def _extremes(ep: int, rank: int):
    """Rank ``rank``'s partial sums of the all-reduce check: every extreme
    on every rank, plus a rank-dependent small value."""
    v32 = np.array([I32[0], I32[1], I32[0], I32[1], rank, -rank - 1],
                   np.int32)
    v64 = np.array([I64[0], I64[1], I64[0], I64[1], rank, -rank - 1,
                    (rank + 1) << 40], np.int64)
    if rank % 2:
        v32[2:4] = v32[3:1:-1]
        v64[2:4] = v64[3:1:-1]
    return v32, v64


# ---------------------------------------------------------------------------
# the worker (no JAX)
# ---------------------------------------------------------------------------

def _worker(out: Path):
    import torch
    torch.set_num_threads(1)
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.params import GATE_TOY
    from tfhe_tpu_torch.parallel import mesh as gmesh, multihost, shard
    from tfhe_tpu_torch.rng import TfheRng

    multihost.initialize(backend="gloo", device="cpu")
    rank = torch.distributed.get_rank()
    p = GATE_TOY
    rng = TfheRng(3)
    sk = gate.SecretKey.generate(p, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device="cpu")
    inputs = np.load(out / "inputs.npz")
    ct, nand = (torch.from_numpy(inputs[k]) for k in ("ct", "nand"))
    record = {}

    def save(name, rows):
        np.save(out / f"{name}-r{rank}.npy", rows.numpy())

    for dp, ep in GATE_MESHES:
        m = shard.make_mesh(dp * ep, dp=dp, ep=ep, device="cpu")
        fn, place = shard.make_sharded_bootstrap_fn(p, m, "onthefly")
        if m.active:
            kd, rows = place(ck.data, ct[:2 * dp])
            save(f"shard-{dp}x{ep}", fn(kd, rows))
            if (dp, ep) == (2, 2):
                record["bk_shape"] = list(kd["bk"]["v"].shape)
                record["ksw_shape"] = list(kd["ksw"].shape)
                save("nand-2x2", fn(*place(ck.data, nand)))

    m = gmesh.make_mesh(4, device="cpu")             # dp=2, tp=2
    record["tp_mesh"] = m.shape
    fn, place = gmesh.make_sharded_bootstrap_fn(p, m, "onthefly")
    save("tp-2x2", fn(*place(ck.data, ct[:8])))

    m = shard.make_mesh(4, dp=4, ep=1, device="cpu")
    fn, place = shard.make_sharded_bootstrap_fn(p, m, "onthefly")
    try:
        place(ck.data, ct[:6])
    except ValueError as e:
        record["batch_error"] = str(e)
    padded, orig = shard.pad_batch(ct[:6], m)
    record["pad"] = [padded.shape[0], orig]
    save("padded-4x1", fn(*place(ck.data, padded)))
    try:
        shard.make_sharded_bootstrap_fn(p, shard.make_mesh(4, dp=1, ep=4,
                                                           device="cpu"),
                                        "onthefly")
    except ValueError as e:
        record["kpl_error"] = str(e)

    for ep in (2, 3, 4):
        m = shard.make_mesh(ep, dp=1, ep=ep, device="cpu")
        if m.active:
            v32, v64 = _extremes(ep, rank)
            for name, v in (("i32", v32), ("i64", v64)):
                got = m.all_reduce(torch.from_numpy(v), "ep")
                assert got.dtype == torch.from_numpy(v).dtype
                save(f"reduce{ep}-{name}", got)
    (out / f"record-r{rank}.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests (pytest process: JAX references)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from tfhe_tpu.boot import gate as jgate
    from tfhe_tpu.params import GATE_TOY
    from tfhe_tpu.rng import TfheRng as JRng
    p = GATE_TOY
    rng = JRng(3)
    sk = jgate.SecretKey.generate(p, rng)
    ck = jgate.CloudKey.generate(sk, rng, backend="onthefly")
    bits = np.random.default_rng(5).integers(0, 2, 16).astype(bool)
    ct = np.asarray(jgate.encrypt_bool(sk, bits, JRng(7)))
    r = np.random.default_rng(6)
    xa = r.integers(0, 2, 16).astype(bool)
    xb = r.integers(0, 2, 16).astype(bool)
    erng = JRng(11)
    ca = jgate.encrypt_bool(sk, xa, erng)
    cb = jgate.encrypt_bool(sk, xb, erng)
    nand = np.asarray(jnp.broadcast_to(jgate._trivial(jgate.MU_BOOL, p.lwe.n),
                                       ca.shape) - ca - cb)
    boot = jax.jit(lambda c, k: jgate.bootstrap(c, k, p, backend="onthefly"))
    want = np.asarray(boot(jnp.asarray(ct), ck.data))
    return {"p": p, "sk": sk, "ck": ck, "ct": ct, "want": want,
            "nand": nand, "nand_want": ~(xa & xb), "gate": jgate}


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    """Run the four workers once; returns their output directory."""
    from tfhe_tpu_torch.parallel import multihost
    out = tmp_path_factory.mktemp("parallel")
    np.savez(out / "inputs.npz", ct=jx["ct"], nand=jx["nand"])
    multihost.launch([sys.executable, __file__, str(out)], WORLD,
                     coordinator_address=f"file://{out}/store",
                     env={"PYTHONPATH": str(REPO)}, timeout=300)
    return out


def _rows(out: Path, name: str, dp: int, ep: int) -> np.ndarray:
    """The global batch from the per-rank files of a (dp, ep) mesh over
    ranks 0..dp*ep-1 (rank d*ep + e holds dp block d): every ep rank of a
    block must hold the same rows."""
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


@pytest.mark.parametrize("dp,ep", GATE_MESHES)
def test_shard_map_bootstrap_matches_single_device(jx, ranks, dp, ep):
    """Every rank's rows equal tfhe_tpu's single-device bootstrap of the
    same ciphertexts (2 per dp block, as the JAX test)."""
    got = _rows(ranks, f"shard-{dp}x{ep}", dp, ep)
    np.testing.assert_array_equal(got, jx["want"][:2 * dp])


def test_shard_matches_jax_shard_map(jx, ranks):
    """(dp, ep) = (2, 2): equal to tfhe_tpu.parallel.shard's shard_map
    bootstrap on the virtual mesh."""
    import jax.numpy as jnp
    from tfhe_tpu.parallel import shard as jshard
    m = jshard.make_mesh(4, dp=2, ep=2)
    fn, place = jshard.make_sharded_bootstrap_fn(jx["p"], m, "onthefly")
    kd, cts = place(jx["ck"].data, jnp.asarray(jx["ct"][:4]))
    np.testing.assert_array_equal(_rows(ranks, "shard-2x2", 2, 2),
                                  np.asarray(fn(kd, cts)))


def test_shard_map_bootstrap_decrypts(jx, ranks):
    """NAND of encrypted bits on the (2, 2) mesh decrypts right."""
    import jax.numpy as jnp
    got = _rows(ranks, "nand-2x2", 2, 2)
    dec = np.asarray(jx["gate"].decrypt_bool(jx["sk"], jnp.asarray(got)))
    np.testing.assert_array_equal(dec, jx["nand_want"])


def test_per_device_key_division(jx, ranks):
    """ep=2 divides the key: each rank holds J/ep of the bk rows and half
    of the key-switch rows."""
    p = jx["p"]
    full_ksw = jx["ck"].data["ksw"].shape[1]
    for rank in range(4):
        rec = _record(ranks, rank)
        assert rec["bk_shape"][2] == p.tgsw.kpl // 2    # (n, L, J/ep, U, 2N)
        assert rec["ksw_shape"][1] == full_ksw // 2


def test_gspmd_mesh_still_matches(jx, ranks):
    """The tp formulation (mesh.make_mesh(4): dp=2, tp=2) equals the JAX
    single-device bootstrap and tfhe_tpu.parallel.mesh's GSPMD one."""
    import jax.numpy as jnp
    from tfhe_tpu.parallel import mesh as jmesh
    assert _record(ranks, 0)["tp_mesh"] == {"dp": 2, "tp": 2}
    got = _rows(ranks, "tp-2x2", 2, 2)
    np.testing.assert_array_equal(got, jx["want"][:8])
    m = jmesh.make_mesh(4)
    fn, place = jmesh.make_sharded_bootstrap_fn(jx["p"], m, "onthefly")
    np.testing.assert_array_equal(
        got, np.asarray(fn(*place(jx["ck"].data, jnp.asarray(jx["ct"][:8])))))


def test_ep_must_divide_kpl(ranks):
    """kpl % ep != 0 (GATE_TOY kpl=6, ep=4) is a ValueError, as JAX's."""
    for rank in range(4):
        assert "does not divide" in _record(ranks, rank)["kpl_error"]


def test_batch_not_divisible_by_dp_errors_clearly(ranks):
    """6 rows on dp=4: the placement raises, never truncates."""
    for rank in range(4):
        msg = _record(ranks, rank)["batch_error"]
        assert "not divisible" in msg and "dp=4" in msg


def test_uneven_batch_padding_helper(jx, ranks):
    """pad_batch rounds 6 rows up to dp=4's 8 and the first 6 output rows
    equal the unpadded bootstrap."""
    assert _record(ranks, 0)["pad"] == [8, 6]
    got = _rows(ranks, "padded-4x1", 4, 1)
    np.testing.assert_array_equal(got[:6], jx["want"][:6])


@pytest.mark.parametrize("ep", (2, 3, 4))
def test_all_reduce_exact_extremes(ranks, ep):
    """Partial sums at INT32/INT64_MIN/MAX add to the wrapped sums, on
    every rank of the group."""
    for name, bits, col in (("i32", 32, 0), ("i64", 64, 1)):
        parts = [_extremes(ep, r)[col] for r in range(ep)]
        total = [sum(int(v[i]) for v in parts) for i in range(len(parts[0]))]
        half = 1 << (bits - 1)
        want = [((t + half) % (1 << bits)) - half for t in total]
        for r in range(ep):
            got = np.load(ranks / f"reduce{ep}-{name}-r{r}.npy")
            assert got.tolist() == want, (name, r)


def test_single_process_mesh(jx):
    """Without process groups (a world of one rank) the sharded function
    runs whole, on a (1, 1) mesh, and equals the JAX bootstrap; a mesh
    larger than the world raises."""
    import torch
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.parallel import shard
    from tfhe_tpu_torch.rng import TfheRng
    p = jx["p"]
    rng = TfheRng(3)
    sk = gate.SecretKey.generate(p, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device="cpu")
    m = shard.make_mesh(device="cpu")
    assert m.shape == {"dp": 1, "ep": 1} and m.group("ep") is None
    fn, place = shard.make_sharded_bootstrap_fn(p, m, "onthefly")
    got = fn(*place(ck.data, torch.tensor(jx["ct"][:4])))
    np.testing.assert_array_equal(got.numpy(), jx["want"][:4])
    with pytest.raises(ValueError, match="needs as many processes"):
        shard.make_mesh(2, device="cpu")


def test_unknown_backend_raises():
    """Only onthefly and matmul keys have an ep spec, as in JAX."""
    from tfhe_tpu_torch.parallel import shard
    assert shard._bk_ep_spec("onthefly") == (None, None, "ep", None, None)
    with pytest.raises(ValueError, match="ep sharding not defined"):
        shard._bk_ep_spec("chunked")


def test_parallel_imports_no_jax_and_no_tfhe_tpu():
    code = ("import sys; import tfhe_tpu_torch.parallel.mesh, "
            "tfhe_tpu_torch.parallel.shard, tfhe_tpu_torch.parallel.multihost;"
            " bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'tfhe_tpu.')) or m == 'tfhe_tpu']; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
