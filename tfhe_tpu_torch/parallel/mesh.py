"""Ranks on a device grid, their process groups, the exact all-reduce, and
the dp x tp formulation of the gate bootstrap (the counterpart of
``tfhe_tpu.parallel.mesh``).

A ``Mesh`` is the JAX mesh of this port's SPMD world: a 2-D grid of global
ranks with named axes, ("dp", "tp") here and ("dp", "ep") in ``shard``.
Every rank builds the same ``Mesh`` (its process groups are made by
``dist.new_group``, a collective over the world, so every rank must build
every mesh in the same order) and learns its own coordinates; ranks outside
the grid (a mesh over the first n of a larger world) are inactive.  Axis
groups of one rank need no collective and are None.  Placement specs are
the ``PartitionSpec`` of the JAX package written as tuples: one entry per
dimension, the mesh axis that dimension is split over or None, and
``Mesh.place`` takes this rank's contiguous block of each split dimension.

tp: the blind-rotation key is replicated and each rank runs the ordinary
gate rotation (``gate.bootstrap_woks``, its whole loop one CUDA graph on the
card) on its dp rows; only the key switch's contracted one-hot rows are
split over tp, each rank multiplying its row block, one all-reduce adding
the partial sums.

``all_reduce_exact`` is the one collective of the package.  Partial sums
must add mod 2^32 (gate) or mod 2^64 (circuit) whatever the backend does on
signed overflow (gloo and NCCL add int64 in C++, where overflow is
undefined), so no backend sum ever overflows: 32-bit parts reduce as int64
and wrap after; 64-bit parts reduce as two int64 halves, the low 32 bits
unsigned and the high 32 bits signed, recombined with the carry mod 2^64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.utils import observability as obs

# When set, all_reduce_exact synchronises the tensor's card before it opens
# its "parallel.all_reduce" span, so that the span holds the reduction
# alone, not the wait for the kernels that made the partial sum.
SYNC_BEFORE_REDUCE = False


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _new_group(ranks, backend=None):
    """One process group per list of global ranks (a collective over the
    world); None for a single rank or a world without process groups."""
    if len(ranks) < 2 or not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.new_group([int(r) for r in ranks], backend=backend)


class Mesh:
    """A 2-D grid of global ranks with named axes (``devices`` is the grid,
    as JAX's ``mesh.devices``), this rank's coordinates on it and its
    process group along each axis.  ``per_host`` ranks of consecutive
    global rank share a host (default: the whole grid); ``host_group``
    joins this rank's host for gathers, on gloo."""

    def __init__(self, devices, axis_names: tuple, device=None,
                 per_host: int | None = None):
        from tfhe_tpu_torch.parallel import multihost
        self.devices = np.asarray(devices)
        assert self.devices.ndim == 2 == len(axis_names)
        self.axis_names = tuple(axis_names)
        self.rank = _world()[0]
        self.device = (multihost.local_device() if device is None
                       else torch.device(device))
        pos = np.argwhere(self.devices == self.rank)
        self.coords = tuple(int(c) for c in pos[0]) if len(pos) else None
        n = self.devices.size
        self.per_host = per_host or n
        # every group is made on every rank, in the same order
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(
                -1, self.devices.shape[ax])
            for line in lines:
                g = _new_group(line)
                if self.rank in line:
                    self._groups[name] = g
        flat = self.devices.reshape(-1)
        self.host_group, self.host_ranks = None, [self.rank]
        for h in range(0, n, self.per_host):
            ranks = flat[h:h + self.per_host]
            g = _new_group(ranks, backend="gloo")
            if self.rank in ranks:
                self.host_group, self.host_ranks = g, [int(r) for r in ranks]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def active(self) -> bool:
        """Whether this rank is on the grid."""
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (jax.lax.axis_index)."""
        self._require_active()
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """This rank's process group along ``axis``; None when the axis has
        one rank."""
        self._require_active()
        return self._groups.get(axis)

    def _require_active(self):
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not on this mesh of "
                             f"{self.size} ranks")

    def span(self, axis: str, size: int, granule: int = 1) -> tuple:
        """(lo, hi) of this rank's contiguous block of ``size`` entries split
        over ``axis``: equal blocks when the axis size divides ``size``, else
        blocks of whole ``granule``-entry units, as even as they go."""
        n, i = self.shape[axis], self.index(axis)
        if size % n == 0:
            return i * (size // n), (i + 1) * (size // n)
        units = size // granule
        assert units * granule == size, (size, granule)
        return (i * units // n) * granule, ((i + 1) * units // n) * granule

    def place(self, t, spec: tuple | None, granules: dict | None = None):
        """This rank's block of tensor ``t`` under ``spec`` (None or a
        tuple naming the mesh axis of each split dimension), contiguous and
        on the mesh's device.  ``granules`` maps a dimension to its split
        unit (``span``)."""
        t = torch.as_tensor(t)
        for dim, axis in enumerate(spec or ()):
            if axis is not None:
                lo, hi = self.span(axis, t.shape[dim],
                                   (granules or {}).get(dim, 1))
                t = t.narrow(dim, lo, hi - lo)
        return t.contiguous().to(self.device)

    def all_reduce(self, t, axis: str):
        """``all_reduce_exact`` over this rank's group along ``axis``."""
        return all_reduce_exact(t, self.group(axis))


def _grid_mesh(n_devices, dp, other, names, default_other, device):
    world = _world()[1]
    n = n_devices or world
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs as many processes; the "
                         f"world has {world}")
    if other is None:
        other = default_other if n % default_other == 0 and n > 1 else 1
    if dp is None:
        dp = n // other
    assert dp * other == n, (dp, other, n)
    return Mesh(np.arange(n).reshape(dp, other), names, device)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, *, device=None) -> Mesh:
    """(dp, tp) mesh over the first ``n_devices`` ranks (default: the
    world); tp defaults to 2 on an even world larger than 1, as JAX's.
    ``device`` defaults to this rank's (``multihost.local_device``)."""
    return _grid_mesh(n_devices, dp, tp, ("dp", "tp"), 2, device)


def all_reduce_exact(t, group):
    """Sum of ``t`` over the ranks of ``group``, exact mod 2^32 for int32
    and mod 2^64 for int64 tensors (module docstring); ``t`` itself for a
    group of one rank (None).  One collective a call, on t's device."""
    if group is None:
        return t
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"all_reduce_exact takes int32 or int64 parts, got "
                         f"{t.dtype}")
    if SYNC_BEFORE_REDUCE and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    with obs.span("parallel.all_reduce"):
        if t.dtype == torch.int32:
            w = t.to(torch.int64)
            dist.all_reduce(w, group=group)
            out = T.wrap32(w)
        else:
            halves = torch.stack([t & 0xFFFFFFFF, t >> 32])
            dist.all_reduce(halves, group=group)
            out = (halves[1] << 32) + halves[0]
        if SYNC_BEFORE_REDUCE and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    return out


def gate_key_shardings(mesh: Mesh, key_data):
    """Placement specs of a gate CloudKey.data: bk replicated, the
    key-switch limb matrices (4, rows, cols) split along their contracted
    one-hot rows over tp."""
    return {"bk": {name: None for name in key_data["bk"]},
            "ksw": (None, "tp", None)}


def batch_sharding(mesh: Mesh) -> tuple:
    """The batch's spec: rows over dp."""
    return ("dp", None)


def place_batch_rows(samples, mesh: Mesh):
    """This rank's B/dp rows of a (B, ...) batch, on the mesh's device;
    raises when dp does not divide B (pad with ``shard.pad_batch``)."""
    B, dp = samples.shape[0], mesh.shape["dp"]
    if B % dp:
        raise ValueError(f"a batch of {B} rows is not divisible by dp={dp}: "
                         f"pad it (shard.pad_batch) first")
    return mesh.place(samples, batch_sharding(mesh))


def place_tree(tree, specs, mesh: Mesh, granules=None):
    """``Mesh.place`` over a key dict and its dict of specs (tuple leaves
    of a prepared key are placed part by part)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh, (granules or {}).get(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(mesh.place(t, specs, granules) for t in tree)
    return mesh.place(tree, specs, granules)


def make_sharded_bootstrap_fn(params, mesh: Mesh, backend: str = "onthefly",
                              mu: int | None = None, unroll: int = 1):
    """(fn(local_key, local_rows) -> local rows, place(key_data, samples)
    -> (local_key, local_rows)) for the dp x tp gate bootstrap.

    Each rank bootstraps its B/dp rows with the whole bootstrapping key
    (``gate.bootstrap_woks``) and key-switches with its tp block of the
    key-switch rows, one all-reduce over tp adding the partial sums.
    ``unroll`` is the JAX scan's and changes nothing here.  Bit-identical
    to ``gate.bootstrap``."""
    from tfhe_tpu_torch.boot import gate
    from tfhe_tpu_torch.parallel.shard import _ksw_granules, _local_keyswitch

    mu = gate.MU_BOOL if mu is None else mu

    def fn(key_data, samples):
        u = gate.bootstrap_woks(samples, key_data["bk"], params, mu, backend)
        return _local_keyswitch(u, key_data["ksw"], params.ks, params.lwe.n,
                                mesh, "tp")

    def shard(key_data, samples):
        key = place_tree(key_data, gate_key_shardings(mesh, key_data), mesh,
                         {"ksw": _ksw_granules(params.ks)})
        return key, place_batch_rows(samples, mesh)

    return fn, shard
