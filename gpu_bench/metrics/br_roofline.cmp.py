"""br_roofline.cmp: the blind-rotation bound of the traced comparisons (the
judge's netlist, roofline/circuit.py: 189 bootstraps an instance in 12
batches) over device busy time, key switches and MUX sums included."""
from gpu_bench.readers import br_roofline as read  # noqa: F401
