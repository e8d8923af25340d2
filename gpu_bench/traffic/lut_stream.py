"""Encrypted k-bit look-up tables on the program's staged path: a launch
circuit-bootstraps the ``lut_bits`` selector bits of each of ``instances``
queries and folds every query's CMux tree against its own selectors
(``tfhe_tpu_torch.models.lut.make_lut_staged``: the circuit bootstrap's
programs A, B and C, then the tree's program).  The table, 2^lut_bits rows
of N1 torus32 coefficients (the server's public function, one output
polynomial a leaf), is drawn from the seed once a run; a configuration
that states its table's ``lut_bits`` runs only a mix of that width.
Closed loop as ``cb_stream``: fresh bits cycled from a pool of
``pool_batches`` launches the client encrypted in set-up, launched back to
back with at most two in flight, one synchronise at the window's end.  A unit is a launch:
``instances`` answers (lvl1 TRLWEs) and ``instances * lut_bits`` selector
bits (circuit bootstraps), with the roofline bound of their blind rotations;
a traced unit also gets ``tree_busy_s``, the card's time in its tree's
lut_cmux kernels (lut_roofline.cb_lut).  The judge is
``reference/judges/lut_tree.py``."""

import torch

from gpu_bench import loops
# the program's staged LUT entry, imported with this file: a program
# without it stops the run here, before a key is made
from tfhe_tpu_torch.models.lut import make_lut_staged, pack_table


def run(ctx):
    mix, cfg, server = ctx.mix, ctx.cfg, ctx.server
    k, inst = mix["lut_bits"], mix["instances"]
    if cfg.get("lut_bits", k) != k:
        raise SystemExit(f"mix of {k}-bit LUTs on a configuration of "
                         f"{cfg['lut_bits']}-bit LUTs")
    fn = make_lut_staged(server.params, server.backend, k)
    table = ctx.client.uniform((1 << k, cfg["n_lvl1"]), 32)
    leaves = pack_table(table, cfg["n_lvl1"], device=ctx.device)
    bits = ctx.client.bits((mix["pool_batches"], inst * k))
    pool = loops._bits_lwe(ctx, bits, -(1 << 31), 0,
                           ctx.secret["ring_lvl1"][0],
                           cfg["input_stdev_log2"]).to(torch.int32)

    def launch(x):
        return fn(x, server.key_data, leaves)

    ctx.warm(lambda: launch(pool[0]))
    bound = ctx.bound(inst * k)
    outs = []
    w = ctx.window
    w.open()
    prev = None
    while True:
        outs.append(launch(pool[len(outs) % len(pool)]))
        ev = loops._marker(ctx.device)
        w.unit(inst, inst * k, bound)
        loops._wait(prev)                # keep the next launch queued
        prev = ev
        if w.elapsed() >= ctx.seconds:
            break
    w.close()
    _tree_busy(ctx.tracer.prof, w.units, k)
    picks = [divmod(i, inst) for i in
             loops._pick(ctx.sample_gen, len(outs) * inst, mix["sample"])]
    return loops.Sample(
        "lut_tree",
        torch.stack([pool[j % len(pool)].reshape(inst, k, -1)[i]
                     for j, i in picks]).to(torch.int64),
        torch.stack([outs[j][i] for j, i in picks]), {"table": table})


def _tree_busy(prof, units, k):
    """Give the traced units, in order, the card's time in their trees'
    kernels: the profiler's lut_cmux kernels, k a launch, in start order
    (the tree program's work; its input copy and output clone are left
    out).  Nothing where the run was not traced on a card."""
    if prof is None:
        return
    cuda = torch.autograd.DeviceType.CUDA
    runs = sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == cuda and "lut_cmux" in e.name)
    for u, i in zip(units, range(0, len(runs) - k + 1, k)):
        u["tree_busy_s"] = sum(t - s for s, t in runs[i:i + k]) / 1e6
