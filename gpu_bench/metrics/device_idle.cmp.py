"""device_idle.cmp: idle share of the card over the traced window."""
from gpu_bench.readers import device_idle as read  # noqa: F401
