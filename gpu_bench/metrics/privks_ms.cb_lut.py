"""privks_ms.cb_lut: stream ms a LUT launch (64 queries, 256 bits) of the
circuit bootstrap's program C (the private functional key switch), span
graph.circuit.c under the launch's circuit.bootstrap, summed over its
replays (one a TRGSW row block)."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("c")
