"""graph.launch_ms.circuit: host ms a scheduler launch of its program's
replay span (graph.wave or graph.chain): the input copies and
cudaGraphLaunch, and any wait of the launch for room in the card's queue."""
from gpu_bench.spans import launch_host_ms


def read(run):
    return launch_host_ms()
