"""mux_ms.cmp: stream ms an evaluation of the scheduler's MUX programs (the
graph.wave replays under circuit.wave.mux, each gate_mux's two dependent
bootstrap launches), mean over the traced evaluations."""
from gpu_bench.wave_spans import wave_ms


def read(run):
    return wave_ms("mux")
