"""Evaluations of a gate netlist with MUX gates (the mix's ``circuit`` and
``bits``, the configuration's own) over ``instances`` instances through the
program's scheduler (``runtime.scheduler.evaluate``, by the server's
``circuit`` and ``evaluate``), as the built-in ``circuit`` loop runs them:
a closed loop of one client, one evaluation at a time, each ending with its
outputs on the host, inputs cycled from a pool of ``pool`` operand sets the
client encrypted in set-up.  Set-up ends with ``WARM_S`` seconds of such
evaluations (at most the window's length) after the first, which captures
every wave's program: evaluations hold an H100 at its 700 W power limit,
where its clock, and so the rate, drifts with the card's temperature (from
~45 to ~68 C over a cold card's first 45 s), so every window opens on a card
already in the steady state of this load, whatever ran before it.

A unit is one evaluation: ``instances`` answers, and the bootstraps of the
judge's netlist (``reference/judges/<circuit>.py``), one a binary gate and
three a MUX, the three the judged MUX computes (189 a 32-bit comparison),
counted from the netlist and not from the program's counters; its
``bound_s`` is the netlist's blind-rotation bound (``roofline/circuit.py``).
The judge is the netlist's file."""

import time

import torch

from gpu_bench import loops
from gpu_bench.harness import _module
from gpu_bench.reference import circuits as RC
from gpu_bench.roofline import circuit as roof

WARM_S = 30.0


def run(ctx):
    mix, cfg, server = ctx.mix, ctx.cfg, ctx.server
    name, nbits, inst = mix["circuit"], mix["bits"], mix["instances"]
    if (cfg.get("circuit"), cfg.get("bits")) != (name, nbits):
        raise SystemExit(f"mix of {name}({nbits}) on a configuration of "
                         f"{cfg.get('circuit')}({cfg.get('bits')})")
    ref = _module(ctx.folder / "reference" / "judges" / f"{name}.py",
                  f"judge_{name}")
    netlist = getattr(ref, name)(nbits)
    per = sum(3 if kind == "mux" else 1 for kind, *_ in netlist[1])
    bound = None if ctx.peaks is None else roof.evaluation_s(
        cfg, ref.batches(netlist), inst, ctx.peaks)
    circ, wires = server.circuit(name, nbits)
    bits = ctx.client.bits((mix["pool"], netlist[0], inst))
    pool = loops._bits_lwe(ctx, bits, RC.MU, -RC.MU, ctx.secret["lwe_key"],
                           cfg["lwe_stdev_log2"]).to(torch.int32)
    ctx.warm(lambda: server.evaluate(circ, pool[0], wires).cpu())
    until = time.perf_counter() + min(WARM_S, ctx.seconds)
    while time.perf_counter() < until:
        server.evaluate(circ, pool[0], wires).cpu()
    outs = []
    w = ctx.window
    w.open()
    while True:
        outs.append(server.evaluate(circ, pool[len(outs) % len(pool)],
                                    wires).cpu())
        w.unit(inst, per * inst, bound)
        if w.elapsed() >= ctx.seconds:
            break
    w.close()
    picks = [divmod(i, inst) for i in
             loops._pick(ctx.sample_gen, len(outs) * inst, mix["sample"])]
    return loops.Sample(
        name,
        torch.stack([pool[e % len(pool)][:, i] for e, i in picks]
                    ).to(torch.int64),
        torch.stack([outs[e][:, i] for e, i in picks]), {"bits": nbits})
