"""preks_ms.cb_lut: stream ms a LUT launch (64 queries, 256 bits) of the
circuit bootstrap's program A (preKS and the mod switch), span
graph.circuit.a under the launch's circuit.bootstrap."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("a")
