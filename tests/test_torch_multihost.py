"""The port's multi-host layer (tfhe_tpu_torch.parallel.multihost) on the
CPU: four gloo ranks laid out as 2 "hosts" x 2 ranks (``launch`` with
per_host=2 sets LOCAL_RANK and LOCAL_WORLD_SIZE as torchrun would), the
mesh (dp=2, ep=2) of ``make_multihost_mesh(ep=2)``, and the gate and CB_TOY
chunked circuit bootstraps placed and gathered host by host, as
tests/multihost_worker.py runs them in the JAX package: each host passes
its 8 rows of the 16, each rank slices its own regenerated keys (the
circuit bk from its raw TRGSW rows), and ``gather_batch`` returns each
host's rows, which must equal tfhe_tpu's single-device bootstrap of those
rows bit for bit and decrypt (NAND truth table).

This file run as a script is the worker (no JAX).  Also: ``initialize``'s
no-op for one process and its refusal of NCCL without a card, the per-host
ep assertion, ``launch`` killing its ranks when one fails or the time runs
out, and ranks that start a kernel build together running the compiler
once (the build directory's lock).

Tolerance 0: every path is exact integer arithmetic.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
B = 16                    # global batch; 8 rows per host


def _worker(out: Path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from tfhe_tpu_torch.boot import circuit, gate
    from tfhe_tpu_torch.params import CB_TOY, GATE_TOY
    from tfhe_tpu_torch.parallel import multihost, shard
    from tfhe_tpu_torch.rng import TfheRng

    dev = multihost.initialize(backend="gloo", device="cpu")
    rank = dist.get_rank()
    host, half = rank // 2, B // 2
    record = {"device": str(dev), "world": dist.get_world_size(),
              "local_rank": int(os.environ["LOCAL_RANK"]),
              "local_world": multihost.local_world_size()}
    mesh = multihost.make_multihost_mesh(ep=2)
    record["mesh"] = mesh.shape
    record["ep_groups_in_one_host"] = all(
        len({int(r) // mesh.per_host for r in row}) == 1
        for row in mesh.devices)
    inputs = np.load(out / "inputs.npz")

    p = GATE_TOY
    rng = TfheRng(0)                        # identical keys on every rank
    sk = gate.SecretKey.generate(p, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device="cpu")
    fn, _ = shard.make_sharded_bootstrap_fn(p, mesh, "onthefly")
    key = multihost.place_keys(ck.data, mesh, "onthefly", params=p)
    x = multihost.place_batch(inputs["lin"][host * half:(host + 1) * half],
                              mesh)
    np.save(out / f"gate-r{rank}.npy", multihost.gather_batch(fn(key, x),
                                                              mesh))

    crng = TfheRng(2)
    csk = circuit.CircuitSecretKey.generate(CB_TOY, crng)
    cck = circuit.CircuitCloudKey.generate(csk, crng, backend="chunked",
                                           prepare_bk=False, device="cpu")
    cfn, _ = shard.make_sharded_circuit_bootstrap_fn(CB_TOY, mesh,
                                                     backend="chunked")
    ckey = multihost.place_circuit_keys(cck.data, mesh, "chunked",
                                        bk_raw=cck.bk_raw, params=CB_TOY)
    record["wmt_cols"] = ckey["bk"]["wmt"].shape[-1]
    cx = multihost.place_batch(inputs["cct"][host * half:(host + 1) * half],
                               mesh)
    np.save(out / f"circuit-r{rank}.npy",
            multihost.gather_batch(cfn(ckey, cx), mesh))
    (out / f"record-r{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from tfhe_tpu import lwe as jlwe
    from tfhe_tpu.boot import circuit as jcircuit, gate as jgate
    from tfhe_tpu.params import CB_TOY, GATE_TOY
    from tfhe_tpu.rng import TfheRng as JRng
    p = GATE_TOY
    rng = JRng(0)
    sk = jgate.SecretKey.generate(p, rng)
    ck = jgate.CloudKey.generate(sk, rng, backend="onthefly")
    r = np.random.default_rng(7)
    xa, xb = r.integers(0, 2, B), r.integers(0, 2, B)
    erng = JRng(1)
    ca = jgate.encrypt_bool(sk, xa, erng)
    cb = jgate.encrypt_bool(sk, xb, erng)
    lin = np.asarray(jgate._trivial(jgate.MU_BOOL, p.lwe.n) - ca - cb)
    ref = np.asarray(jax.jit(lambda c, k: jgate.bootstrap(
        c, k, p, backend="onthefly"))(jnp.asarray(lin), ck.data))

    crng = JRng(2)
    csk = jcircuit.CircuitSecretKey.generate(CB_TOY, crng)
    cck = jcircuit.CircuitCloudKey.generate(csk, crng, backend="chunked")
    cbits = np.random.default_rng(11).integers(0, 2, B)
    msgs = np.where(cbits.astype(bool), np.int32(-(1 << 31)), 0)
    cct = np.asarray(jlwe.encrypt(csk.lwe_lvl1, msgs.astype(np.int32),
                                  JRng(3), 2.0**-20))
    cref = np.asarray(jax.jit(lambda c, k: jcircuit.circuit_bootstrap(
        c, k, CB_TOY, backend="chunked"))(jnp.asarray(cct), cck.data))
    return {"sk": sk, "lin": lin, "ref": ref, "nand": ~(xa.astype(bool)
                                                       & xb.astype(bool)),
            "cct": cct, "cref": cref, "gate": jgate}


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    from tfhe_tpu_torch.parallel import multihost
    out = tmp_path_factory.mktemp("multihost")
    np.savez(out / "inputs.npz", lin=jx["lin"], cct=jx["cct"])
    multihost.launch([sys.executable, __file__, str(out)], 4, per_host=2,
                     coordinator_address=f"file://{out}/store",
                     env={"PYTHONPATH": str(REPO)}, timeout=300)
    return out


def _record(out: Path, rank: int) -> dict:
    return json.loads((out / f"record-r{rank}.json").read_text())


def test_start_up_and_mesh(ranks):
    """Every rank started from the launcher's environment on gloo; the
    mesh is (dp=2, ep=2) with each ep pair inside one host."""
    for rank in range(4):
        rec = _record(ranks, rank)
        assert rec["device"] == "cpu" and rec["world"] == 4
        assert rec["local_rank"] == rank % 2 and rec["local_world"] == 2
        assert rec["mesh"] == {"dp": 2, "ep": 2}
        assert rec["ep_groups_in_one_host"]


@pytest.mark.parametrize("path", ("gate", "circuit"))
def test_two_host_bootstrap(jx, ranks, path):
    """Each rank's gathered host rows equal the single-process bootstrap's
    rows of that host; the gate rows decrypt to the NAND truth table."""
    import jax.numpy as jnp
    ref = jx["ref" if path == "gate" else "cref"]
    half = B // 2
    for rank in range(4):
        host = rank // 2
        got = np.load(ranks / f"{path}-r{rank}.npy")
        np.testing.assert_array_equal(got, ref[host * half:(host + 1) * half],
                                      err_msg=f"rank {rank}")
        if path == "gate":
            dec = np.asarray(jx["gate"].decrypt_bool(jx["sk"],
                                                     jnp.asarray(got)))
            np.testing.assert_array_equal(
                dec, jx["nand"][host * half:(host + 1) * half])


def test_circuit_key_built_per_rank(ranks):
    """Each rank built half of the K-packed lvl2 key (J*m / 2 columns)
    from the raw rows."""
    from tfhe_tpu.params import CB_TOY
    for rank in range(4):
        assert _record(ranks, rank)["wmt_cols"] == CB_TOY.tgsw_lvl2.kpl * 32


def test_initialize_single_process_and_nccl_without_card(monkeypatch):
    from tfhe_tpu_torch.parallel import multihost
    for var in ("TFHE_COORDINATOR", "TFHE_NUM_PROCESSES", "TFHE_PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_DEVICE", None)
    assert multihost.initialize() is None                # a no-op
    assert str(multihost.initialize(device="cpu")) == "cpu"
    assert not multihost.dist.is_initialized()
    with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA"):
        multihost.initialize("127.0.0.1:1", 2, 0)


def test_ep_must_stay_inside_a_host():
    from tfhe_tpu_torch.parallel import multihost
    with pytest.raises(AssertionError, match="must divide"):
        multihost.make_multihost_mesh(ep=2, per_host=1, device="cpu")
    m = multihost.make_multihost_mesh(device="cpu")
    assert m.shape == {"dp": 1, "ep": 1}


@pytest.mark.parametrize("code,match", (
    ("import sys, os; sys.exit(3 if os.environ['TFHE_PROCESS_ID'] == '1' "
     "else 0)", "rank 1 exited 3"),
    ("import time; time.sleep(60)", "timed out")))
def test_launch_fails_fast_and_kills_ranks(code, match):
    from tfhe_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=match):
        multihost.launch([sys.executable, "-c", code], 2, timeout=5)
    assert time.perf_counter() - t0 < 30


def test_ranks_build_once(tmp_path):
    """Two processes that build the same library together run the compiler
    once: the second waits on the build directory's lock and finds the
    library built (a stand-in nvcc that counts its runs)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo run >> {tmp_path}/runs
        sleep 1
        while [ "$1" != "-o" ]; do shift; done
        touch "$2"
        """))
    nvcc.chmod(0o755)
    (tmp_path / "k.cu").write_text("// empty\n")
    code = textwrap.dedent(f"""\
        from pathlib import Path
        from tfhe_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        _build._compile([(Path({str(tmp_path / 'k.cu')!r}), ())])
        """)
    env = {"PYTHONPATH": str(REPO),
           "PATH": f"{bindir}:/usr/bin:/bin"}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env)
             for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert (tmp_path / "runs").read_text().splitlines() == ["run"]
    assert len(list((tmp_path / "build").glob("k-*.so"))) == 1


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
