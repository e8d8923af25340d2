"""sched.gap_ms: the card's idle ms a scheduler launch within an
evaluation, from its first program's stream entry to its last one's exit
less the card's busy time: each program's wait for its own launch and the
scheduler's host path between programs (gpu_bench/spans.py idle_ms)."""
from gpu_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "circuit.evaluate", per_program=True)
