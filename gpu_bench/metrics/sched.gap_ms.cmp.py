"""sched.gap_ms.cmp: the card's idle ms a scheduler launch within a
comparison's evaluation, from its first program's stream entry to its last
one's exit less the card's busy time (gpu_bench/spans.py idle_ms), MUX
programs counted once each."""
from gpu_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "circuit.evaluate", per_program=True)
