"""sched.rows_per_launch: bootstrap rows per launch over the window's
evaluations (the program's bootstrap.* counters)."""
from gpu_bench.readers import rows_per_launch as read  # noqa: F401
