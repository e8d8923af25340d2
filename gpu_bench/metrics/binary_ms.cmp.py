"""binary_ms.cmp: stream ms an evaluation of the scheduler's binary-gate
programs (the graph.wave replays under circuit.wave.binary, one bootstrap
launch each), mean over the traced evaluations."""
from gpu_bench.wave_spans import wave_ms


def read(run):
    return wave_ms("binary")
