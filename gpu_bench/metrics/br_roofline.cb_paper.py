"""br_roofline.cb_paper: blind-rotation roofline bound over device busy
time."""
from gpu_bench.readers import br_roofline as read  # noqa: F401
