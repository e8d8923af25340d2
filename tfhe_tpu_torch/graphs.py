"""One program per launch: captured CUDA graphs, the port's counterpart of
``jax.jit``.

The JAX package runs each of its launches as one compiled XLA program: the
blind rotation's ``lax.scan``, the jitted ``make_bootstrap_fn``, the three
staged programs of ``make_circuit_bootstrap_staged``, and the scheduler's
per-wave and per-chain ``jit`` caches.  Eager PyTorch pays 20-50 us of host
time per kernel wrapper call instead, which a loop of hundreds of small
steps cannot hide.  This module is the one place where the port captures a
launch into a CUDA graph and replays it.

``run(site, structure, fn, inputs, keys)`` on CUDA tensors:

  * looks the program up in a cache keyed by the site and its structure,
    the inputs' shapes, dtypes and device, the environment knobs the
    programs read (``KNOBS``) and the identity (address, shape, dtype,
    strides) of every key tensor the program reads; the cached graph holds
    a reference to each key tensor, so a key cannot be freed under it;
  * on a miss, runs ``fn`` once eagerly on a side stream (the warm-up: it
    builds the nvcc kernels, cuBLAS handles, cuFFT plans and every memoized
    plan, and gives this call's result), then captures ``fn`` on static
    copies of the inputs with ``torch.cuda.graph`` (its own memory pool);
  * on a hit, copies the inputs into the static buffers, replays, and
    returns fresh tensors (clones of the static outputs), so a result a
    caller keeps is never overwritten by the next replay.

Counters stay honest: the capture runs the wrappers' Python once without
running a kernel, so ``run`` takes back what the capture added to every
``utils.observability`` counter (the kernel wrappers' ``kernel.<name>``
launch counts among them) and adds that delta again on each replay.
It counts ``graph.captures`` and ``graph.replays``, and a site may name a
counter for its cache misses (the scheduler counts ``circuit.wave_compiles``
and ``circuit.chain_compiles``, as the JAX package counts its compiles).
A replay (or an eager run) is the span ``graph.<site>``, which times the
card's stream while a profiler records; a capture is ``graph.capture``, and
spans inside a warm-up or capture keep no records, so no event is ever
recorded into a graph.

Eager, always: CPU tensors (every tier-1 test; cache misses still count
the site's counter, as the JAX package compiles on its CPU too); calls
under ``disable()`` (``jax.disable_jit``'s counterpart); calls made inside
another program's warm-up or capture, or inside a capture the caller
began (the outer graph records them); and the backends of
``EAGER_BACKENDS``, a static list decided before any capture.  A capture
that fails raises: nothing falls back to the eager path.

The cache holds at most ``MAX_PROGRAMS`` programs, and the captured ones'
pools at most ``MAX_POOL_BYTES`` together (least recently used first out,
the newest always kept); ``clear()`` drops them all, with their memory
pools and key references (after the card finishes what they launched).  ``stats()`` gives each cached program's capture and
instantiation milliseconds, node count and pool bytes.  A capture uses
CUDA's global capture mode: while one runs, no other thread may issue CUDA
work (captures themselves take a lock).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time

import torch

from tfhe_tpu_torch.utils import observability as obs

# Backends that stay eager on the card, a static rule decided before any
# capture.  fft_dd's product is one eager f32 kernel per double-float
# operation: one captured GATE_DEFAULT B=256 step is 6,466 graph nodes, a
# 630-step rotation 4.07 M (chip_smoke.py phase 10 counts them, NVIDIA H100
# 80GB HBM3), past what a graph instantiates in useful time.  The Nussbaumer
# engine's step is 271 nodes (170,730 a rotation), so it is captured.
EAGER_BACKENDS = ("fft_dd",)

# environment variables a program reads while it is captured
KNOBS = ("TFHE_CK64_PATH", "TFHE_CK64_FUSED")

MAX_PROGRAMS = 32
MAX_POOL_BYTES = 16 << 30

_lock = threading.RLock()
_local = threading.local()
_programs: collections.OrderedDict = collections.OrderedDict()
_streams: dict = {}
_disabled = 0


class _Eager:
    """A cache entry for a program that runs eagerly (CPU tensors or an
    eager backend): it only records that the site's counter counted it."""


_EAGER = _Eager()


@contextlib.contextmanager
def disable():
    """Run every site eagerly while inside (nestable): the counterpart of
    ``jax.disable_jit()``.  Nothing is captured or counted as compiled."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def enabled() -> bool:
    return _disabled == 0


def clear():
    """Drop every cached program, its graph, memory pool and key
    references."""
    with _lock:
        _drop(list(_programs))


def _drop(keys):
    """Remove these cache entries; a captured program's graph and pool go
    only after the card has finished its replays."""
    if any(isinstance(_programs[k], _Program) for k in keys):
        torch.cuda.synchronize()
    for k in keys:
        del _programs[k]


def leaves(tree) -> tuple:
    """The tensors of a key: a tensor, or a dict / tuple / list of them (a
    prepared key's tuple leaves included), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return (tree,)
    if isinstance(tree, dict):
        return tuple(t for k in sorted(tree) for t in leaves(tree[k]))
    if isinstance(tree, (tuple, list)):
        return tuple(t for v in tree for t in leaves(v))
    return ()


# ---------------------------------------------------------------------------
# counter bookkeeping
# ---------------------------------------------------------------------------

def counters() -> dict:
    """Every counter a replay must account for: the observability
    counters."""
    return obs.report()["counters"]


def delta(before: dict, after: dict) -> dict:
    """What ``after`` added to ``before``, non-zero entries only."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add(d: dict, sign: int = 1):
    """Add ``sign`` times the counter delta ``d``."""
    for name, v in d.items():
        obs.count(name, sign * v)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

def _nested() -> bool:
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def _inside():
    """A warm-up or capture: nested programs run inline, and spans keep no
    records (a capture must never record an event into the graph)."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        with obs.muted():
            yield
    finally:
        _local.depth -= 1


def _side_stream(device) -> torch.cuda.Stream:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _streams:
        _streams[idx] = torch.cuda.Stream(device=idx)
    return _streams[idx]


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _shaped(out, flat):
    return tuple(flat) if isinstance(out, (tuple, list)) else flat[0]


_CU_GRAPH_GET_NODES = None


def nodes(graph) -> int:
    """Nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True`` (``new_graph``): the driver's cuGraphGetNodes on its
    cudaGraph_t."""
    global _CU_GRAPH_GET_NODES
    if _CU_GRAPH_GET_NODES is None:
        fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_size_t)]
        fn.restype = ctypes.c_int
        _CU_GRAPH_GET_NODES = fn
    n = ctypes.c_size_t(0)
    rc = _CU_GRAPH_GET_NODES(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(n.value)


def new_graph() -> tuple:
    """(a CUDA graph, whether it keeps its cudaGraph_t for ``nodes``): it
    does where this PyTorch supports ``keep_graph``."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


class _Program:
    """One captured launch: the graph, its static inputs and outputs, the
    key tensors it reads and the counter delta one replay stands for."""

    def __init__(self, site, fn, inputs, keys):
        self.site, self.keys, self.replays = site, keys, 0
        dev = inputs[0].device
        stream = _side_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _inside(), torch.cuda.stream(stream):
            warm = fn(*inputs)                 # builds, plans, handles
            self.static_in = tuple(torch.empty_like(
                x, memory_format=torch.contiguous_format) for x in inputs)
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for t in _as_tuple(warm):
            t.record_stream(torch.cuda.current_stream(dev))
        self.first = warm

        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph, kept = new_graph()
        before = counters()
        t0 = time.perf_counter()
        with _inside(), torch.cuda.graph(self.graph, stream=stream):
            out = fn(*self.static_in)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.delta = delta(before, counters())
        add(self.delta, -1)                    # the capture ran no kernel
        self.shape = out
        self.static_out = _as_tuple(out)
        t0 = time.perf_counter()
        if hasattr(self.graph, "instantiate"):
            self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.nodes = nodes(self.graph) if kept else None

    def replay(self, inputs):
        with torch.cuda.device(inputs[0].device):
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            self.graph.replay()
        self.replays += 1
        add(self.delta)
        obs.count("graph.replays")
        return _shaped(self.shape, [t.clone() for t in self.static_out])

    def stats(self) -> dict:
        return {"site": self.site, "capture_ms": self.capture_ms,
                "instantiate_ms": self.instantiate_ms, "nodes": self.nodes,
                "pool_bytes": self.pool_bytes, "replays": self.replays}


def _key(site, structure, inputs, keys):
    return (site, structure,
            tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
            tuple(os.environ.get(k, "") for k in KNOBS),
            tuple((k.data_ptr(), tuple(k.shape), k.dtype, k.stride())
                  for k in keys))


def run(site: str, structure, fn, inputs: tuple, keys: tuple = (), *,
        backend: str | None = None, compiles: str | None = None):
    """``fn(*inputs)`` (a tensor or a tuple of tensors) as one program.

    ``structure`` is everything static that ``fn`` closes over apart from
    its key tensors (parameters, backend, gate kinds); ``keys`` are the
    tensors ``fn`` reads without taking them as inputs; ``backend`` is the
    engine the program runs (checked against ``EAGER_BACKENDS``);
    ``compiles`` names the counter of this site's cache misses.

    A capture runs under the span ``graph.capture``; every other call (a
    replay, or an eager run) under ``graph.<site>``, which times the
    card's stream while traced (``utils.observability``)."""
    if _nested():
        return fn(*inputs)
    dev = inputs[0].device
    if dev.type != "cpu" and torch.cuda.is_current_stream_capturing():
        return fn(*inputs)                     # an outer capture records it
    key, prog = _lookup(site, structure, inputs, keys, backend, compiles) \
        if enabled() else (None, _EAGER)
    if prog is None:
        with obs.span("graph.capture"), _lock:
            prog = _Program(site, fn, inputs, keys)
            _programs[key] = prog
            _evict()
        obs.count("graph.captures")
        out, prog.first = prog.first, None
        return out
    with obs.span(f"graph.{site}", stream=dev):
        if prog is _EAGER:
            return fn(*inputs)
        return prog.replay(inputs)


def _lookup(site, structure, inputs, keys, backend, compiles):
    """(cache key, what runs): ``_EAGER``, a captured ``_Program``, or None
    where the program is to be captured; counts ``compiles`` on a miss."""
    eager = inputs[0].device.type == "cpu" or backend in EAGER_BACKENDS
    if eager and not compiles:
        return None, _EAGER
    key = _key(site, structure, inputs, keys)
    with _lock:
        prog = _programs.get(key)
        if prog is not None:
            _programs.move_to_end(key)
        else:
            if compiles:
                obs.count(compiles)
            if eager:
                prog = _programs[key] = _EAGER
                _evict()
    return key, prog


def _evict():
    """Drop the least recently used entries past MAX_PROGRAMS, and captured
    programs past MAX_POOL_BYTES of pools, keeping the newest."""
    keys = list(_programs)
    pools = sum(p.pool_bytes for p in _programs.values()
                if isinstance(p, _Program))
    n = 0
    while len(keys) - n > 1 and (len(keys) - n > MAX_PROGRAMS
                                 or pools > MAX_POOL_BYTES):
        p = _programs[keys[n]]
        if isinstance(p, _Program):
            pools -= p.pool_bytes
        n += 1
    if n:
        _drop(keys[:n])


def stats() -> list:
    """One dict per cached captured program, oldest first."""
    with _lock:
        return [p.stats() for p in _programs.values()
                if isinstance(p, _Program)]
