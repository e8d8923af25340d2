"""rotation_ms.cb_paper: stream ms a launch of 256 bits of the circuit
bootstrap's program B (the lvl2 blind rotation and extract), span
graph.circuit.b, summed over its replays (one a level, four at CB_PAPER)."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("b")
