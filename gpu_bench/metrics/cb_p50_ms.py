"""cb_p50_ms: the median of the window's query latencies."""
from gpu_bench.readers import latency_ms


def read(run):
    return latency_ms(run, 50)
