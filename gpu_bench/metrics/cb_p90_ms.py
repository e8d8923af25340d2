"""cb_p90_ms: the 90th percentile of the window's query latencies."""
from gpu_bench.readers import latency_ms


def read(run):
    return latency_ms(run, 90)
