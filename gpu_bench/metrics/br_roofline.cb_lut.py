"""br_roofline.cb_lut: blind-rotation roofline bound of a LUT launch's 256
circuit bootstraps over device busy time (the tree's kernels included)."""
from gpu_bench.readers import br_roofline as read  # noqa: F401
