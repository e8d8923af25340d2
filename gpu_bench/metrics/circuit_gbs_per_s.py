"""circuit_gbs_per_s: bootstraps completed per second of the window (ct/s)."""
from gpu_bench.readers import bootstraps_per_s as read  # noqa: F401
