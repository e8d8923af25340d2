"""Unsigned comparisons of two encrypted nbits-bit integers, the answers of
the ``mux_circuit`` loop: each sampled instance's (lt, eq, gt), recomputed
gate by gate with the reference's gate bootstrap from the raw cloud key.

The netlist is a log-depth merge tree over x[0..n) ++ y[0..n) (wire i is
bit i, LSB first): per bit e_i = XNOR(x_i, y_i) and l_i = AND(NOT x_i, y_i),
then merge levels that combine adjacent segments (hi, lo) by

    lt = MUX(eq_hi, lt_lo, lt_hi)       # if the high bits are equal, the
    eq = AND(eq_hi, eq_lo)              # low segment decides

and last gt = NOR(lt, eq).  A binary gate is bootstrap(wx*a + wy*b +
(0, ..., 0, c0)), upstream TFHE's gate encodings (False = -1/8, True =
+1/8); NOT is the negated sample.

A MUX(c, x, y) is three full gate bootstraps, as the program computes it:
u = bootstrap([c + x - 1/8, -c + y - 1/8]), then bootstrap(u0 + u1 + 1/8).
Upstream ``bootsMUX`` (tfhe_gate_bootstrapping.cpp) departs from this: its
two first-stage bootstraps stop before the key switch (two blind rotations,
``tfhe_bootstrap_woKS_FFT``), their sum plus 1/8 is formed on the extracted
N-dimensional samples, and one key switch ends it.  The answers here are the
program's form, compared coefficient by coefficient.
"""

import torch

from gpu_bench.reference import tfhe as R

MU = 1 << 29
# binary kind -> (c0, wx, wy)
AFFINE = {"xnor": (-(1 << 30), -2, -2), "andny": (-MU, -1, 1),
          "and": (-MU, 1, 1), "nor": (-MU, -1, -1)}


def comparator(nbits: int):
    """(n_inputs, gates, outputs): gates (kind, inputs, out) in dependency
    order over wire ids, a MUX's inputs (c, x, y) for c ? x : y; outputs
    (lt, eq, gt) with lt = (x < y)."""
    if nbits < 1 or nbits & (nbits - 1):
        raise ValueError(f"comparator({nbits}): power-of-two widths only")
    gates = []

    def gate(kind, *ins):
        gates.append((kind, ins, 2 * nbits + len(gates)))
        return gates[-1][2]

    eqs, lts = [], []
    for i in reversed(range(nbits)):            # MSB-first segments
        eqs.append(gate("xnor", i, nbits + i))
        lts.append(gate("andny", i, nbits + i))
    while len(eqs) > 1:
        lts = [gate("mux", eqs[s], lts[s + 1], lts[s])
               for s in range(0, len(lts), 2)]
        eqs = [gate("and", eqs[s], eqs[s + 1]) for s in range(0, len(eqs), 2)]
    return 2 * nbits, gates, [lts[0], eqs[0], gate("nor", lts[0], eqs[0])]


def levels(netlist) -> list:
    """The gates by dependency level, inputs at level 0."""
    n_in, gates, _ = netlist
    depth = {w: 0 for w in range(n_in)}
    for kind, ins, out in gates:
        depth[out] = 1 + max(depth[w] for w in ins)
    return [[g for g in gates if depth[g[2]] == lv]
            for lv in range(1, max(depth.values()) + 1)]


def batches(netlist) -> list:
    """Bootstrap rows an instance of each batch the reference runs: a level's
    binary gates (one row each) beside its MUXes' first stage (two), then,
    where the level has MUXes, their second stage (one)."""
    out = []
    for level in levels(netlist):
        mux = sum(kind == "mux" for kind, *_ in level)
        out.append(len(level) + mux)
        if mux:
            out.append(mux)
    return out


def _bootstrap(rows, key, cfg, rotation):
    """(G, S, n+1) int64 -> the gate bootstraps of every row."""
    G, S, m = rows.shape
    return R.gate_bootstrap(R.wrap32(rows).reshape(G * S, m), key, rotation,
                            cfg["ks_t"], cfg["ks_basebit"]).reshape(G, S, m)


def judge(inputs, key, cfg, extra):
    """inputs (S, 2 bits, n+1) int64 torus32 -> (S, 3, n+1): lt, eq, gt."""
    netlist = comparator(extra["bits"])
    wires = dict(enumerate(inputs.transpose(0, 1)))
    rotation = R.BlindRotation(key["bk"], cfg["l"], cfg["bgbit"], 32)
    body = torch.zeros(inputs.shape[-1], dtype=torch.int64,
                       device=inputs.device)
    body[-1] = 1

    for level in levels(netlist):
        binary = [g for g in level if g[0] != "mux"]
        muxes = [g for g in level if g[0] == "mux"]
        rows = []
        for kind, (a, b), _ in binary:
            c0, wx, wy = AFFINE[kind]
            rows.append(wx * wires[a] + wy * wires[b] + c0 * body)
        for _, (c, x, y), _ in muxes:
            rows += [wires[c] + wires[x] - MU * body,
                     -wires[c] + wires[y] - MU * body]
        res = _bootstrap(torch.stack(rows), key, cfg, rotation)
        wires.update(zip((g[2] for g in binary), res))
        if muxes:
            u = res[len(binary):]
            res = _bootstrap(u[0::2] + u[1::2] + MU * body, key, cfg,
                             rotation)
            wires.update(zip((g[2] for g in muxes), res))
    return torch.stack([wires[w] for w in netlist[2]], dim=1)
