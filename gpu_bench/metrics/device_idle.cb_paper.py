"""device_idle.cb_paper: idle share of the card over the traced window."""
from gpu_bench.readers import device_idle as read  # noqa: F401
