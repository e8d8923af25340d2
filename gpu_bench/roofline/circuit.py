"""Frozen work of one evaluation of a gate netlist over many instances: its
blind rotations, counted from the judge's netlist and the configuration's
parameters, not from the program's launch list, so that a scheduler that
merges or splits launches reads the same work.

The reference runs each dependency level as one batch of bootstraps
(instances x rows), a level with MUXes as two: its binary gates (one row
each) beside its MUXes' first stage (two), then their second stage (one)
(``reference/judges/<netlist>.py`` ``batches``).  Each batch is n CMux
steps at its width (``roofline.gate_bootstrap_s``); the evaluation's bound
is their sum.  Key switches are left out, as in ``roofline``."""

from __future__ import annotations

from gpu_bench.roofline import gate_bootstrap_s


def evaluation_s(cfg: dict, batches: list, instances: int,
                 peaks: dict) -> float:
    """The bound of one evaluation whose batches take ``batches`` rows an
    instance each."""
    return sum(gate_bootstrap_s(cfg, instances * rows, peaks)
               for rows in batches)
