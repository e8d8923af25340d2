"""lut_tree_ms.cb_lut: stream ms a launch of the LUT's tree program (span
graph.lut.tree under the launch's lut.eval: its k lut_cmux levels), mean
over the traced launches."""
from gpu_bench.spans import per_request


def read(run):
    return per_request("lut.eval", lambda name: name == "graph.lut.tree",
                       lambda r: r["stream_end_ms"] - r["stream_start_ms"])
