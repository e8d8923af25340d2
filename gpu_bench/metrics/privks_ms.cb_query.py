"""privks_ms.cb_query: stream ms a query of the circuit bootstrap's program C
(the private functional key switch), span graph.circuit.c, summed over its
replays (one a TRGSW row block)."""
from gpu_bench.spans import stage_ms


def read(run):
    return stage_ms("c")
