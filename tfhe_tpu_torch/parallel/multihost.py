"""Multi-host orchestration: ``torch.distributed`` start-up, a host-aware
mesh, host-local placement and gather (the counterpart of
``tfhe_tpu.parallel.multihost``).

Design (the JAX package's key-placement policy):

  * dp (ciphertext batch) is the only axis that crosses hosts.  It needs no
    collectives (the rotation, key switches and extraction are batch-local),
    so nothing crosses between hosts during a bootstrap but the final
    gather.
  * ep (key/digit-row sharding) stays INSIDE a host: ranks are numbered
    host-major (torchrun's order), and ``make_multihost_mesh`` builds
    (hosts, local dp, ep) with ep innermost, so every per-step all-reduce
    stays among the ranks of one host.
  * Keys are regenerated from one seed (``TfheRng``) on every rank, or
    loaded there, and each rank slices its own copy (``place_keys``,
    ``place_circuit_keys``): no key bytes cross processes.

Start-up: ``initialize`` reads its arguments or the environment
(``TFHE_COORDINATOR``, ``TFHE_NUM_PROCESSES``, ``TFHE_PROCESS_ID``, else
torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and
starts the default process group: NCCL with one card a rank,
``cuda:{LOCAL_RANK}``, unless the caller asks for ``backend="gloo"`` (gloo
all-reduces CUDA tensors too, so several ranks may share one card, which
NCCL refuses) or for ``device="cpu"``.  A single process that names no
coordinator may skip it: it is then a no-op, and every helper works on a
world of one rank.  ``launch`` starts the ranks of one host as
subprocesses, as torchrun does.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from tfhe_tpu_torch import device as _device
from tfhe_tpu_torch.parallel.mesh import Mesh

_DEVICE: torch.device | None = None


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def local_world_size(default: int | None = None) -> int:
    """The ranks of one host (``LOCAL_WORLD_SIZE``), else ``default``, else
    the whole world."""
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    if default is not None:
        return default
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device() -> torch.device:
    """The device ``initialize`` chose for this rank, else the default
    device (``cuda``; raises without one)."""
    return _DEVICE if _DEVICE is not None else _device.resolve(None)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device=None) -> torch.device | None:
    """Start the default process group and return this rank's device.

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0) or
    any ``torch.distributed`` init URL (``file:///path`` for a file store);
    unset arguments come from ``TFHE_COORDINATOR``, ``TFHE_NUM_PROCESSES``
    and ``TFHE_PROCESS_ID``, else from torchrun's variables.  A no-op for
    one process with no coordinator.  ``backend`` defaults to "nccl" on
    ``cuda:{local_rank}``, which needs a card; "gloo" and ``device``
    ("cpu", or one card that several ranks share) are explicit."""
    global _DEVICE
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("TFHE_COORDINATOR")
        if coordinator_address is None and env.get("MASTER_ADDR"):
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("TFHE_NUM_PROCESSES", "WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("TFHE_PROCESS_ID", "RANK") or 0
    if num_processes <= 1 and coordinator_address is None:
        if device is not None:
            _DEVICE = torch.device(device)
        return _DEVICE
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device; pass "
                           "backend='gloo' (and device='cpu') to run on the "
                           "host")
    if device is None:
        lr = _env_int("LOCAL_RANK")
        if lr is None:
            lr = process_id % local_world_size(num_processes)
        device = f"cuda:{lr}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {dev}; pass device='cpu'")
        torch.cuda.set_device(dev)
    _DEVICE = dev
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"address (TFHE_COORDINATOR)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd: list, num_processes: int, *,
           coordinator_address: str | None = None,
           per_host: int | None = None, env: dict | None = None,
           timeout: float = 900.0) -> list:
    """Start ``num_processes`` ranks of ``cmd`` on this host, as torchrun
    does: each gets ``TFHE_COORDINATOR`` (default: a TCP store on a free
    localhost port), ``TFHE_NUM_PROCESSES``, ``TFHE_PROCESS_ID``,
    ``LOCAL_RANK`` (its id mod ``per_host``) and ``LOCAL_WORLD_SIZE``
    (``per_host``, default all); ``per_host`` below the count pretends the
    ranks are spread over hosts of that many.  Waits for all of them and
    returns their outputs (stdout and stderr, one string a rank).  If a
    rank fails or the ``timeout`` (seconds) passes, kills every rank and
    raises with the outputs."""
    per_host = per_host or num_processes
    if coordinator_address is None:
        coordinator_address = f"127.0.0.1:{_free_port()}"
    logs, procs = [], []
    try:
        for r in range(num_processes):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            renv = {**os.environ, **(env or {}),
                    "TFHE_COORDINATOR": coordinator_address,
                    "TFHE_NUM_PROCESSES": str(num_processes),
                    "TFHE_PROCESS_ID": str(r),
                    "LOCAL_RANK": str(r % per_host),
                    "LOCAL_WORLD_SIZE": str(per_host)}
            procs.append(subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          env=renv))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {codes[bad[0]]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed:
        text = "\n".join(f"--- rank {r} (exit {p.returncode})\n{o[-6000:]}"
                         for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"launch {' '.join(map(str, cmd))}: {failed}\n"
                           f"{text}")
    return outs


def make_multihost_mesh(ep: int = 1, per_host: int | None = None, *,
                        device=None) -> Mesh:
    """(dp, ep) mesh with hosts on the OUTER dp blocks and every ep group
    inside one host.  ``per_host`` (default ``LOCAL_WORLD_SIZE``, else the
    world) ranks of consecutive global rank share a host.  Works with one
    process too."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = per_host or local_world_size()
    assert world % per_host == 0, (world, per_host)
    assert per_host % ep == 0, (
        f"ep={ep} must divide the {per_host} ranks of each host so the "
        "per-step all-reduce stays inside a host")
    grid = np.arange(world).reshape(world // per_host, per_host // ep, ep)
    return Mesh(grid.reshape(world // ep, ep), ("dp", "ep"), device,
                per_host=per_host)


def _host_dp(mesh: Mesh) -> tuple:
    """(this rank's dp index within its host, dp indices a host holds)."""
    local_dp = mesh.per_host // mesh.shape["ep"]
    return mesh.index("dp") % local_dp, local_dp


def place_batch(samples_local, mesh: Mesh):
    """This host's rows -> this rank's rows: each process passes ITS
    host's rows (globally the batch is the host-order concatenation) and
    keeps its dp block of them, on the mesh's device."""
    i, local_dp = _host_dp(mesh)
    rows = torch.as_tensor(samples_local)
    B = rows.shape[0]
    if B % local_dp:
        raise ValueError(f"a host's batch of {B} rows is not divisible by "
                         f"its {local_dp} dp blocks")
    return rows[i * (B // local_dp):(i + 1) * (B // local_dp)].contiguous() \
        .to(mesh.device)


def place_keys(key_data, mesh: Mesh, backend: str = "onthefly",
               params=None):
    """A deterministically regenerated gate key -> this rank's slices: bk
    leaves split over ep, key-switch rows likewise; each rank slices its own
    copy, so nothing crosses processes.  ``params`` (the GateParams) is
    needed only where ep does not divide the key-switch rows (ranks then
    take whole input coefficients)."""
    from tfhe_tpu_torch.parallel.shard import _gate_key_local
    return _gate_key_local(key_data, mesh, backend,
                           params.ks if params else None)


def place_circuit_keys(key_data, mesh: Mesh, backend: str = "chunked",
                       bk_raw=None, params=None):
    """CircuitCloudKey.data -> this rank's slices (the key policy of
    ``shard.circuit_key_shardings``): every rank regenerates or loads the
    raw keys and, where ``key_data["bk"]`` is None, builds its own bk slice
    from the raw TRGSW rows ``bk_raw`` (``shard.local_circuit_bk``, which
    needs the CircuitParams ``params``), so neither the 8.1 GB ``wmt`` nor
    the 2.7 GB privKS of CB_MXU crosses processes."""
    from tfhe_tpu_torch.parallel.shard import _circuit_key_local
    return _circuit_key_local(key_data, mesh, backend, params, bk_raw)


def gather_batch(out_local, mesh: Mesh) -> np.ndarray:
    """This rank's output rows -> its host's rows (numpy), for an output of
    any rank (LWE batches are rank 2, TRGSW batches rank 5): the host's
    ranks all-gather on gloo (on the host: gloo gathers CPU tensors), and
    the rows of each dp block come from its ep rank 0."""
    rows = out_local.detach().cpu().contiguous()
    g = mesh.host_group
    if g is None:
        return rows.numpy()
    parts = [torch.empty_like(rows) for _ in mesh.host_ranks]
    dist.all_gather(parts, rows, group=g)
    keep = [part for part, r in zip(parts, mesh.host_ranks)
            if np.argwhere(mesh.devices == r)[0][1] == 0]
    return torch.cat(keep).numpy()
