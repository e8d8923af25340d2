"""graph.launch_ms.cb_query: the card's idle ms a query within its
programs (graph.circuit.a, .b, .c), from the first one's stream entry to
the last one's exit less the card's busy time: the waits for the programs'
launches (gpu_bench/spans.py idle_ms)."""
from gpu_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "circuit.bootstrap", per_program=False)
