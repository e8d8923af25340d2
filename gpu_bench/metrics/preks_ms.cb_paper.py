"""preks_ms.cb_paper: stream ms a launch of 256 bits of the circuit
bootstrap's program A (preKS and the mod switch), span graph.circuit.a."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("a")
