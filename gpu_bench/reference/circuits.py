"""Boolean circuits the traffic asks for, as plain netlists, and their
evaluation by the reference's gate bootstrap.

A netlist is (n_inputs, gates, outputs): gates in dependency order as
(kind, a, b, out) over wire ids (inputs are 0..n_inputs-1).  Each binary
gate is bootstrap(wx*a + wy*b + (0, ..., 0, c0)), upstream TFHE's boolean
gate set (bootsAND, bootsOR, bootsXOR, ...), with False = -1/8 and
True = +1/8.
"""

from __future__ import annotations

import torch

from gpu_bench.reference import tfhe as R

MU = 1 << 29
AFFINE = {"and": (-MU, 1, 1), "or": (MU, 1, 1), "xor": (1 << 30, 2, 2),
          "nand": (MU, -1, -1), "nor": (-MU, -1, -1),
          "xnor": (-(1 << 30), -2, -2)}


def ripple_carry_adder(nbits: int):
    """x[0..n) + y[0..n) (LSB first, wires x_i = i, y_i = n + i): the sum
    bits and the carry out, by full adders s = (x ^ y) ^ c,
    c' = (x & y) | ((x ^ y) & c)."""
    gates, outs = [], []
    nxt = 2 * nbits

    def gate(kind, a, b):
        nonlocal nxt
        gates.append((kind, a, b, nxt))
        nxt += 1
        return nxt - 1

    carry = None
    for i in range(nbits):
        x, y = i, nbits + i
        if carry is None:
            outs.append(gate("xor", x, y))
            carry = gate("and", x, y)
        else:
            axb = gate("xor", x, y)
            outs.append(gate("xor", axb, carry))
            t1 = gate("and", x, y)
            t2 = gate("and", axb, carry)
            carry = gate("or", t1, t2)
    return 2 * nbits, gates, outs + [carry]


NETLISTS = {"ripple_carry_adder": ripple_carry_adder}


def evaluate(netlist, inputs, key, cfg: dict):
    """inputs (n_inputs, S, n+1) int64 torus32 -> outputs (n_out, S, n+1):
    every gate of one dependency level in one reference bootstrap."""
    n_in, gates, outs = netlist
    level = {w: 0 for w in range(n_in)}
    for kind, a, b, o in gates:
        level[o] = 1 + max(level[a], level[b])
    wires = {w: inputs[w] for w in range(n_in)}
    rotation = R.BlindRotation(key["bk"], cfg["l"], cfg["bgbit"], 32)
    for lv in range(1, max(level.values()) + 1):
        batch = [g for g in gates if level[g[3]] == lv]
        t = torch.stack([AFFINE[k][1] * wires[a] + AFFINE[k][2] * wires[b]
                         for k, a, b, _ in batch])          # (G, S, n+1)
        t[..., -1] += torch.tensor([AFFINE[k][0] for k, *_ in batch],
                                   device=t.device)[:, None]
        G, S, m = t.shape
        res = R.gate_bootstrap(R.wrap32(t).reshape(G * S, m), key, rotation,
                               cfg["ks_t"], cfg["ks_basebit"]
                               ).reshape(G, S, m)
        for i, g in enumerate(batch):
            wires[g[3]] = res[i]
    return torch.stack([wires[o] for o in outs])
