"""The one traffic generator: a mix file (``traffic/<mix>.json``) names a
loop and its parameters, and the loop drives the program from the seed.
The loops below are built in; a mix may name instead a loop file of its
own, ``traffic/<loop>.py`` with ``run(ctx) -> Sample`` (``harness.find_loop``).

Every loop is a closed loop of one client, who sends the next request when
the card has taken the previous one:

* ``gate_chain``: launches of ``batch`` gate bootstraps, each on the
  previous launch's output (the bit is kept), at most two launches in
  flight and one synchronise at the window's end;
* ``cb_stream``: circuit-bootstrap launches of ``batch`` fresh lvl1 bits,
  cycled from a pool of ``pool_batches`` batches the client encrypted in
  set-up; with ``sync_each`` every launch is one synchronised query, timed
  from submission to return, else at most two in flight;
* ``circuit``: evaluations of a netlist (``circuit``, ``bits``) over
  ``instances`` instances through the scheduler, each ending with its
  outputs on the host, inputs cycled from a pool of ``pool`` operand sets.

Each loop warms up the shapes its window uses (set-up), then runs until
``seconds`` have passed and the card has finished, and draws from the seed
``sample`` answers for the reference to judge.  A unit is one launch (or
one evaluation); its ``bound_s`` is the roofline bound of its blind
rotations, where one is defined.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from gpu_bench.reference import circuits as RC


@dataclasses.dataclass
class Sample:
    """Answers drawn for the reference: what went in, what came out."""
    reference: str             # a judge: reference.judge.find_judge's name
    inputs: torch.Tensor       # int64 torus32, one answer's inputs a row
    outputs: torch.Tensor      # the program's answers, one a row
    extra: dict = dataclasses.field(default_factory=dict)


class Window:
    """The measured window: host clock from ``start`` to the synchronised
    end, one record per unit of work."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.units = []
        self.start = self.end = None

    def open(self):
        self.ctx.reset_counters()
        self.ctx.tracer.begin()
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def unit(self, answers: int, bootstraps: int, bound_s=None,
             latency_s=None):
        self.units.append({"answers": answers, "bootstraps": bootstraps,
                           "bound_s": bound_s, "latency_s": latency_s})
        self.ctx.tracer.after_unit(len(self.units), self.ctx.sync)

    def close(self):
        self.ctx.sync()
        self.end = time.perf_counter()
        self.ctx.tracer.finish(len(self.units), self.ctx.sync)


def _marker(device):
    """An event on the card's stream (None on the host)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _wait(ev):
    if ev is not None:
        ev.synchronize()


def _pick(gen, total: int, count: int):
    return torch.randperm(total, generator=gen)[:min(count, total)].tolist()


def _bits_lwe(ctx, bits, mu_true: int, mu_false: int, key, stdev_log2):
    msgs = torch.where(bits == 1, mu_true, mu_false)
    return ctx.client.lwe(key, msgs, 2.0 ** stdev_log2)


def gate_chain(ctx) -> Sample:
    B, cfg = ctx.mix["batch"], ctx.cfg
    fn = ctx.server.bootstrap_fn()
    x0 = _bits_lwe(ctx, ctx.client.bits((B,)), RC.MU, -RC.MU,
                   ctx.secret["lwe_key"], cfg["lwe_stdev_log2"])
    outs = [x0.to(torch.int32)]
    ctx.warm(lambda: fn(outs[0]))
    bound = ctx.bound(B)
    w = ctx.window
    w.open()
    prev = None
    while True:
        outs.append(fn(outs[-1]))
        ev = _marker(ctx.device)
        w.unit(B, B, bound)
        _wait(prev)                      # keep the next launch queued
        prev = ev
        if w.elapsed() >= ctx.seconds:
            break
    w.close()
    picks = [divmod(i, B) for i in
             _pick(ctx.sample_gen, (len(outs) - 1) * B, ctx.mix["sample"])]
    return Sample("gate_bootstrap",
                  torch.stack([outs[j][r] for j, r in picks]).to(torch.int64),
                  torch.stack([outs[j + 1][r] for j, r in picks]))


def cb_stream(ctx) -> Sample:
    mix, cfg = ctx.mix, ctx.cfg
    B = mix["batch"]
    fn = ctx.server.bootstrap_fn()
    bits = ctx.client.bits((mix["pool_batches"], B))
    pool = _bits_lwe(ctx, bits, -(1 << 31), 0, ctx.secret["ring_lvl1"][0],
                     cfg["input_stdev_log2"]).to(torch.int32)
    ctx.warm(lambda: fn(pool[0]))
    bound = ctx.bound(B)
    outs = []
    w = ctx.window
    w.open()
    prev = None
    while True:
        x = pool[len(outs) % len(pool)]
        if mix["sync_each"]:
            t0 = time.perf_counter()
            outs.append(fn(x))
            ctx.sync()
            w.unit(B, B, bound, latency_s=time.perf_counter() - t0)
        else:
            outs.append(fn(x))
            ev = _marker(ctx.device)
            w.unit(B, B, bound)
            _wait(prev)
            prev = ev
        if w.elapsed() >= ctx.seconds:
            break
    w.close()
    rows = [divmod(i, B) for i in
            _pick(ctx.sample_gen, len(outs) * B, mix["sample"])]
    return Sample("circuit_bootstrap",
                  torch.stack([pool[j % len(pool)][r] for j, r in rows]
                              ).to(torch.int64),
                  torch.stack([outs[j][r] for j, r in rows]))


def circuit(ctx) -> Sample:
    mix, cfg = ctx.mix, ctx.cfg
    inst, nbits = mix["instances"], mix["bits"]
    circ, wires = ctx.server.circuit(mix["circuit"], nbits)
    n_in, gates, _ = RC.NETLISTS[mix["circuit"]](nbits)
    bits = ctx.client.bits((mix["pool"], n_in, inst))
    pool = _bits_lwe(ctx, bits, RC.MU, -RC.MU, ctx.secret["lwe_key"],
                     cfg["lwe_stdev_log2"]).to(torch.int32)
    ctx.warm(lambda: ctx.server.evaluate(circ, pool[0], wires).cpu())
    outs = []
    w = ctx.window
    w.open()
    while True:
        outs.append(ctx.server.evaluate(circ, pool[len(outs) % len(pool)],
                                        wires).cpu())
        w.unit(inst, len(gates) * inst)
        if w.elapsed() >= ctx.seconds:
            break
    w.close()
    picks = [divmod(i, inst) for i in
             _pick(ctx.sample_gen, len(outs) * inst, mix["sample"])]
    return Sample("circuit:" + mix["circuit"],
                  torch.stack([pool[e % len(pool)][:, i] for e, i in picks]
                              ).to(torch.int64),
                  torch.stack([outs[e][:, i] for e, i in picks]),
                  {"bits": nbits})


LOOPS = {"gate_chain": gate_chain, "cb_stream": cb_stream,
         "circuit": circuit}
