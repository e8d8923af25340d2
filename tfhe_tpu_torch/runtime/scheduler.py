"""Homomorphic boolean-circuit runtime: native scheduler + batched executor
(the counterpart of ``tfhe_tpu.runtime.scheduler``).

The graph side (construction, Kahn levelization, wave extraction,
criticality ordering) lives in C++ (``native/circuit_sched.cpp``, ctypes
ABI), shared with the JAX package and built for this port with g++ at first
use (``ops._build.host_library``).  This module is the executor: each wave,
a set of independent gates, becomes ONE batched gate call (``boot.gate``),
so a circuit with W waves costs W blind-rotation launches whatever its gate
count.  NOT and constants are folded into wire references by the scheduler
and cost nothing (gate_not is sample negation; constants are noiseless
trivial samples).

Each launch is one program, as the JAX package jits each one: on the card
a captured CUDA graph (``graphs.run``), keyed as the JAX package's
``_WAVE_JIT`` is (kind, shape, parameters, backend; plus the key tensors),
whose cache misses count ``circuit.wave_compiles``.  ``TFHE_WAVE_CHAIN=K``
makes K consecutive launches one program (the JAX package's
``_run_chained`` / ``_make_chain_fn``): its key is the chain's structure,
external wires numbered by first use, gate kinds, negations and constant
inputs folded into per-gate affine and sign arrays that are the program's
inputs, so repeated slices of a circuit (every full-adder bit of a ripple
adder) replay one program; its misses count ``circuit.chain_compiles``.
On the CPU the same functions run eagerly and the misses count the same,
so both packages count the same compiles on the same circuit.  The launch
list, its ``TFHE_MAX_WAVE_ROWS`` cap and the ``TFHE_WAVE_SPLIT`` per-kind
split are the JAX package's, so both packages launch the same widths in
the same order.  ``bootstrap.launches`` and ``bootstrap.ciphertexts`` are
counted by ``gate.bootstrap`` itself (once per launch, a replay adding what
its capture counted; in the JAX package the scheduler counts them, since
its bootstrap runs under jit); ``circuit.gates``, ``circuit.waves``,
``circuit.mux_gates``, ``circuit.mux_launches`` (the port's alone), the
``circuit.wave_width`` observation and the spans are counted here: an
evaluation is the span ``circuit.evaluate``, each launch (chain) a
``circuit.wave.<kind>`` (``circuit.chain``) with the children
``sched.operands`` (the host's fetch, stacks and per-gate array uploads)
and then ``graph.wave`` (``graph.chain``), the program.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np
import torch

from tfhe_tpu_torch import graphs
from tfhe_tpu_torch import torus as T
from tfhe_tpu_torch.boot import gate
from tfhe_tpu_torch.ops import _build
from tfhe_tpu_torch.utils import observability as obs

SCHED_SOURCE = Path(__file__).resolve().parents[2] / "native" \
    / "circuit_sched.cpp"

_KINDS = {"and": 1, "or": 2, "xor": 3, "nand": 4, "nor": 5, "xnor": 6,
          "not": 7, "const0": 8, "const1": 9, "mux": 10, "binary": 11}
_KIND_NAMES = {v: k for k, v in _KINDS.items()}

# every 2-input boolean gate is bootstrap(wx*x + wy*y + (0,...,0,c0)):
# kind -> (c0, wx, wy) (the affine encodings of boot/gate.py's gate_*)
_MU = 1 << 29
_AFFINE = {1: (-_MU, 1, 1),            # and
           2: (_MU, 1, 1),             # or
           3: (1 << 30, 2, 2),         # xor
           4: (_MU, -1, -1),           # nand
           5: (-_MU, -1, -1),          # nor
           6: (-(1 << 30), -2, -2)}    # xnor

_I32, _PI32 = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
# the C ABI of native/circuit_sched.cpp: name -> (restype, argtypes)
_ABI = {"circ_new": (_I32, [_I32]),
        "circ_free": (None, [_I32]),
        "circ_gate": (_I32, [_I32, _I32, _I32, _I32]),
        "circ_mux": (_I32, [_I32, _I32, _I32, _I32]),
        "circ_schedule": (_I32, [_I32]),
        "circ_wave": (_I32, [_I32, _I32, _PI32, _PI32, _I32]),
        "circ_gate_info": (None, [_I32, _I32, _PI32]),
        "circ_wire_ref": (None, [_I32, _I32, _PI32]),
        "circ_n_gates": (_I32, [_I32]),
        "circ_n_wires": (_I32, [_I32])}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.host_library(SCHED_SOURCE)
        for name, (res, args) in _ABI.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _LIB = lib
    return _LIB


class Circuit:
    """Boolean circuit builder over wire ids (inputs are wires 0..n-1)."""

    def __init__(self, n_inputs: int):
        self._lib = _lib()
        self._h = self._lib.circ_new(n_inputs)
        self.n_inputs = n_inputs

    def __del__(self):
        try:
            self._lib.circ_free(self._h)
        except Exception:
            pass

    def gate(self, kind: str, a: int, b: int = -1) -> int:
        return int(self._lib.circ_gate(self._h, _KINDS[kind], a, b))

    def __getattr__(self, name):
        if name in ("and_", "or_", "xor", "nand", "nor", "xnor"):
            k = name.rstrip("_")
            return lambda a, b: self.gate(k, a, b)
        raise AttributeError(name)

    def not_(self, a: int) -> int:
        return self.gate("not", a)

    def const(self, v: bool) -> int:
        return self.gate("const1" if v else "const0", 0)

    def mux(self, c: int, x: int, y: int) -> int:
        """c ? x : y."""
        return int(self._lib.circ_mux(self._h, c, x, y))

    def schedule(self):
        """-> [(kind_name, [(gate_kind, a_ref, b_ref, c_ref, out_wire),
        ...]), ...] where each ref is (base_wire|-1, negated, const_val).
        Wave kinds are "binary" (all 2-input boolean gates of a level,
        mixed kinds; gate_kind carries the per-gate affine encoding) and
        "mux"."""
        n_waves = int(self._lib.circ_schedule(self._h))
        waves = []
        cap = max(1, int(self._lib.circ_n_gates(self._h)))
        buf = (ctypes.c_int32 * cap)()
        kind = ctypes.c_int32()
        info = (ctypes.c_int32 * 5)()
        for i in range(n_waves):
            cnt = int(self._lib.circ_wave(self._h, i, ctypes.byref(kind),
                                          buf, cap))
            assert cnt >= 0, cnt
            gates = []
            for g in buf[:cnt]:
                self._lib.circ_gate_info(self._h, g, info)
                gates.append((int(info[0]),
                              self._wire_ref(info[1]),
                              self._wire_ref(info[2]),
                              self._wire_ref(info[3]), int(info[4])))
            waves.append((_KIND_NAMES[kind.value], gates))
        return waves

    def _wire_ref(self, wire: int):
        if wire < 0:
            return None
        out = (ctypes.c_int32 * 3)()
        self._lib.circ_wire_ref(self._h, wire, out)
        return (int(out[0]), bool(out[1]), bool(out[2]))

    def resolve(self, wire: int):
        """Public wire reference for reading outputs."""
        return self._wire_ref(wire)


def launch_list(circ: Circuit, inst: int):
    """The circuit's waves as a flat list of ("binary"|"mux", [gate
    tuples]) launches, each one gate-call-sized unit, in dependency order;
    counts circuit.gates / circuit.waves / circuit.wave_width, and
    circuit.mux_gates (MUX gates x ``inst``) / circuit.mux_launches (each
    MUX launch is two bootstrap launches, so these split MUX from binary
    work).

    A launch carries at most TFHE_MAX_WAVE_ROWS (default 8192) bootstrap
    rows across ``inst`` circuit instances; a MUX costs 3 rows.
    TFHE_WAVE_SPLIT=1 launches each gate kind of a binary wave on its own
    (a measurement knob)."""
    launches = []
    max_rows = int(os.environ.get("TFHE_MAX_WAVE_ROWS", 8192))
    split = os.environ.get("TFHE_WAVE_SPLIT", "") not in ("", "0")
    for kind, gates in circ.schedule():
        obs.count("circuit.gates", len(gates))
        obs.count("circuit.waves")
        obs.observe("circuit.wave_width", len(gates) * inst)
        if kind == "mux":
            per = max(1, max_rows // (3 * inst))
            obs.count("circuit.mux_gates", len(gates) * inst)
            for s in range(0, len(gates), per):
                launches.append(("mux", gates[s:s + per]))
                obs.count("circuit.mux_launches")
            continue
        if split:
            groups: dict = {}
            for g in gates:
                groups.setdefault(g[0], []).append(g)
            groups = list(groups.values())
        else:
            groups = [gates]
        per = max(1, max_rows // inst)
        for grp in groups:
            for i in range(0, len(grp), per):
                launches.append(("binary", grp[i:i + per]))
    return launches


def evaluate(circ: Circuit, inputs, ck_data, params, outputs,
             backend: str = "matmul"):
    """Run the circuit homomorphically.

    inputs:  (n_inputs, n+1) int32 LWE batch, or (n_inputs, B, n+1) for B
             parallel instances of the circuit (the serving shape: the
             instance axis multiplies every wave's bootstrap width); moved
             to the device of ``ck_data``.
    outputs: list of wire ids to return.
    Returns (len(outputs)[, B], n+1) int32 on that device.

    Each launch of ``launch_list`` is ONE batched gate call: a whole
    level's mixed binary gates go through one bootstrap of
    wx*x + wy*y + (0,..,0,c0) with per-gate constants; a MUX launch is
    gate.gate_mux (two bootstraps)."""
    with obs.span("circuit.evaluate"):
        return _evaluate(circ, inputs, ck_data, params, outputs, backend)


def _evaluate(circ, inputs, ck_data, params, outputs, backend):
    n = params.lwe.n
    dev = ck_data["ksw"].device
    inputs = torch.as_tensor(inputs).to(dev)
    lead = tuple(inputs.shape[1:-1])
    inst = int(np.prod(lead)) if lead else 1
    store = {i: inputs[i] for i in range(circ.n_inputs)}

    def fetch(ref):
        base, neg, cval = ref
        if base < 0:
            ct = gate._trivial(gate.MU_BOOL if cval else -gate.MU_BOOL, n,
                               dev).expand(*lead, n + 1)
        else:
            ct = store[base]
        return -ct if neg else ct

    keys = graphs.leaves(ck_data)

    def run(kind, grp):
        with obs.span("sched.operands"):
            if kind == "mux":
                c, x, y = (torch.stack([fetch(g[o]) for g in grp])
                           for o in (1, 2, 3))
                shape = c.shape
                args = tuple(t.reshape(-1, n + 1) for t in (c, x, y))
                program = (lambda *xs: gate.gate_mux(ck_data, *xs, params,
                                                     backend))
            else:
                a = torch.stack([fetch(g[1]) for g in grp])
                b = torch.stack([fetch(g[2]) for g in grp])
                shape = a.shape
                args = (a, b, *(torch.tensor([_AFFINE[g[0]][i] for g in grp],
                                             dtype=torch.int64, device=dev)
                                for i in range(3)))
                program = (lambda *xs: _binary(ck_data, *xs, params,
                                               backend))
        res = graphs.run("wave", (kind, args[0].shape, params, backend),
                         program, args, keys, backend=backend,
                         compiles="circuit.wave_compiles").reshape(shape)
        for i, g in enumerate(grp):
            store[g[4]] = res[i]

    launches = launch_list(circ, inst)
    chain_k = int(os.environ.get("TFHE_WAVE_CHAIN", "1"))
    if chain_k > 1:
        _run_chained(launches, chain_k, store, lead, n, ck_data, params,
                     backend)
    else:
        for kind, grp in launches:
            with obs.span(f"circuit.wave.{kind}"):
                run(kind, grp)
    return torch.stack([fetch(circ.resolve(w)) for w in outputs])


def _binary(ck_data, a, b, c0, wx, wy, params, backend):
    """One launch of a level's mixed binary gates: bootstrap of
    wx*a + wy*b + (0,..,0,c0), per-gate constants (int64 device tensors)
    broadcast over the instance axes."""
    n = params.lwe.n
    sh = (-1,) + (1,) * (a.ndim - 1)
    t = wx.reshape(sh) * a.to(torch.int64) + wy.reshape(sh) * b.to(torch.int64)
    t[..., -1] += c0.reshape(sh[:-1])
    t = T.wrap32(t)
    return gate.bootstrap(t.reshape(-1, n + 1), ck_data, params,
                          gate.MU_BOOL, backend).reshape(t.shape)


def _run_chained(launches, K, store, lead, n, ck_data, params, backend):
    """Execute the launch list in chains of K consecutive launches, each
    chain ONE program (the JAX package's ``_run_chained``), on the
    operands of ``_chain_operands``."""
    dev = ck_data["ksw"].device
    keys = graphs.leaves(ck_data)
    for s in range(0, len(launches), K):
        chain = launches[s:s + K]
        with obs.span("circuit.chain"):
            with obs.span("sched.operands"):
                sig, ext, arrays = _chain_operands(chain, store, lead, n,
                                                   dev)
            results = graphs.run(
                "chain", (sig, lead, n, params, backend),
                _make_chain_fn(ck_data, sig, lead, n, params, backend),
                (ext, *arrays), keys, backend=backend,
                compiles="circuit.chain_compiles")
            for (kind, grp), res in zip(chain, results):
                for i, g in enumerate(grp):
                    store[g[4]] = res[i]


def _chain_operands(chain, store, lead, n, dev):
    """The host pass of one chain: (signature, stacked external wires,
    per-gate arrays on ``dev``).

    The signature is the chain's structure (operand topology with external
    wires numbered by first use); gate kinds, input negations and constant
    inputs fold into the affine (c0, wx, wy) arrays of binary launches and
    the sign / constant arrays of MUX launches, so every full-adder bit
    slice of a ripple adder has the same signature.  The arrays and the
    stacked external wires are the program's inputs."""
    mu = int(gate.MU_BOOL)
    ext_pos: dict = {}              # base wire -> ext stack index
    ext_wires: list = []
    internal: dict = {}             # base wire -> (launch idx, gate idx)
    sig = []
    tr = []

    def tag_of(ref):
        base, neg, cval = ref
        if base < 0:
            return ("c",), neg, cval
        if base in internal:
            return ("i",) + internal[base], neg, None
        if base not in ext_pos:
            ext_pos[base] = len(ext_wires)
            ext_wires.append(base)
        return ("e", ext_pos[base]), neg, None

    for d, (kind, grp) in enumerate(chain):
        gsig = []
        if kind == "binary":
            c0, wx, wy = ([0] * len(grp) for _ in range(3))
            for i, g in enumerate(grp):
                gc0, gwx, gwy = _AFFINE[g[0]]
                c0[i] = gc0
                tags = []
                for ref, w, arr in ((g[1], gwx, wx), (g[2], gwy, wy)):
                    t, neg, cval = tag_of(ref)
                    ws = -w if neg else w
                    if t[0] == "c":
                        # trivial (0,..,0,+-mu) input: only the body
                        # contributes; fold it into c0
                        c0[i] += ws * (mu if cval else -mu)
                        arr[i] = 0
                    else:
                        arr[i] = ws
                    tags.append(t)
                gsig.append(tuple(tags))
            tr.extend((c0, wx, wy))
        else:                       # mux: c ? x : y
            sgn = [[1] * len(grp) for _ in range(3)]
            cv = [[0] * len(grp) for _ in range(3)]
            for i, g in enumerate(grp):
                tags = []
                for o, ref in enumerate((g[1], g[2], g[3])):
                    t, neg, cval = tag_of(ref)
                    if t[0] == "c":
                        cv[o][i] = (-1 if neg else 1) * (
                            mu if cval else -mu)
                    else:
                        sgn[o][i] = -1 if neg else 1
                    tags.append(t)
                gsig.append(tuple(tags))
            tr.extend((*sgn, *cv))
        sig.append((kind, tuple(gsig)))
        for i, g in enumerate(grp):
            internal[g[4]] = (d, i)

    if ext_wires:
        ext = torch.stack([store[w] for w in ext_wires])
    else:
        ext = torch.zeros((0, *lead, n + 1), dtype=torch.int32,
                          device=dev)
    arrays = tuple(torch.tensor(v, dtype=torch.int64, device=dev)
                   for v in tr)
    return tuple(sig), ext, arrays


def _make_chain_fn(ck_data, sig, lead, n, params, backend):
    """The program of one chain signature (the JAX package's
    ``_make_chain_fn``): fn(ext, *arrays) -> one result per launch."""
    def chain_fn(ext, *tr):
        results = []

        def row(t, cv):
            if t[0] == "e":
                return ext[t[1]]
            if t[0] == "i":
                return results[t[1]][t[2]]
            z = torch.zeros((*lead, n + 1), dtype=torch.int32,
                            device=ext.device)
            z[..., -1] = cv
            return z

        ti = 0
        for kind, gsig in sig:
            if kind == "binary":
                c0, wx, wy = tr[ti:ti + 3]
                ti += 3
                a = torch.stack([row(t[0], 0) for t in gsig])
                b = torch.stack([row(t[1], 0) for t in gsig])
                results.append(_binary(ck_data, a, b, c0, wx, wy, params,
                                       backend))
            else:
                sc, sx, sy, cc, cx, cy = tr[ti:ti + 6]
                ti += 6
                ops = []
                for o, (s_o, c_o) in enumerate(((sc, cc), (sx, cx),
                                                (sy, cy))):
                    v = torch.stack([row(t[o], c_o[i])
                                     for i, t in enumerate(gsig)])
                    sh = (-1,) + (1,) * (v.ndim - 1)
                    ops.append(T.wrap32(s_o.reshape(sh) * v.to(torch.int64)))
                flat = [o.reshape(-1, n + 1) for o in ops]
                res = gate.gate_mux(ck_data, *flat, params, backend)
                results.append(res.reshape(ops[0].shape))
        return tuple(results)

    return chain_fn


def comparator(nbits: int):
    """nbits-bit unsigned comparator over wires x[0..n) ++ y[0..n):
    returns (Circuit, [lt, eq, gt]) with lt = (x < y).

    A log-depth merge tree.  Level 0 computes per-bit e_i = XNOR(x_i, y_i)
    and l_i = AND(NOT x_i, y_i) as one mixed binary wave; each merge level
    then combines adjacent segments (hi, lo) with

        eq = AND(eq_hi, eq_lo)
        lt = MUX(eq_hi, lt_lo, lt_hi)      # if hi bits equal, low decides

    so the schedule alternates binary and MUX waves of halving width (16,
    8, 4, 2, 1 for nbits=32).  gt = NOR(lt, eq)."""
    assert nbits & (nbits - 1) == 0, "power-of-two widths only"
    circ = Circuit(2 * nbits)
    eqs = []
    lts = []
    for i in reversed(range(nbits)):        # MSB-first segment lists
        eqs.append(circ.gate("xnor", i, nbits + i))
        lts.append(circ.gate("and", circ.not_(i), nbits + i))
    while len(eqs) > 1:
        eqs2, lts2 = [], []
        for s in range(0, len(eqs), 2):
            hi_eq, lo_eq = eqs[s], eqs[s + 1]
            hi_lt, lo_lt = lts[s], lts[s + 1]
            lts2.append(circ.mux(hi_eq, lo_lt, hi_lt))
            eqs2.append(circ.gate("and", hi_eq, lo_eq))
        eqs, lts = eqs2, lts2
    gt = circ.gate("nor", lts[0], eqs[0])
    return circ, [lts[0], eqs[0], gt]


def ripple_carry_adder(nbits: int):
    """nbits-bit adder over wires x[0..n) ++ y[0..n): returns
    (Circuit, [sum wires..., carry]), the standard full-adder chain
    (XOR/AND/OR)."""
    circ = Circuit(2 * nbits)
    outs = []
    carry = -1
    for i in range(nbits):
        x, y = i, nbits + i
        if carry < 0:
            s = circ.gate("xor", x, y)
            carry = circ.gate("and", x, y)
        else:
            axb = circ.gate("xor", x, y)
            s = circ.gate("xor", axb, carry)
            t1 = circ.gate("and", x, y)
            t2 = circ.gate("and", axb, carry)
            carry = circ.gate("or", t1, t2)
        outs.append(s)
    outs.append(carry)
    return circ, outs
