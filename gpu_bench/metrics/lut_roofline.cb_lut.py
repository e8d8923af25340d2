"""lut_roofline.cb_lut: the roofline bound of a launch's CMux trees
(roofline/lut.py, by the configuration's numbers) over the card's busy time
in the tree's kernels a launch (the loop's ``tree_busy_s`` of each traced
unit: the profiler's lut_cmux kernels, traffic/lut_stream.py), in
percent."""
import torch

from gpu_bench import roofline
from gpu_bench.roofline import lut


def read(run):
    busy = [u["tree_busy_s"] for u in run.units if "tree_busy_s" in u]
    if not busy or not torch.cuda.is_available():
        return None
    peaks = roofline.PEAKS.get(torch.cuda.get_device_name())
    if peaks is None:
        return None
    bound = lut.tree_bound_s(run.config, run.mix["instances"],
                             run.mix["lut_bits"], peaks)
    return 100.0 * bound * len(busy) / sum(busy)
