"""privks_ms.cb_paper: stream ms a launch of 256 bits of the circuit
bootstrap's program C (the private functional key switch), span
graph.circuit.c, summed over its replays (one a TRGSW row block, eight at
CB_PAPER)."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("c")
