"""rotation_ms.cb_lut: stream ms a LUT launch (64 queries, 256 bits) of the
circuit bootstrap's program B (the lvl2 blind rotation and extract), span
graph.circuit.b under the launch's circuit.bootstrap, summed over its
replays (one a level)."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("b")
