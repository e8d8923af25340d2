"""tfhe_tpu_torch — the PyTorch/CUDA port of ``tfhe_tpu`` for NVIDIA Hopper.

Same module layout as ``tfhe_tpu``; every path is exact integer arithmetic
mod 2^32 or 2^64, so each function here is held bit for bit against its JAX
counterpart.  The hot loop (the blind-rotation CMux step) runs in CUDA C++
kernels written for sm_90a (``ops/csrc``), built with nvcc at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper takes its plain PyTorch version.  Keys are
generated on the host with numpy (``rng.TfheRng``) and moved to the device
once.

Slice 1 covers the 32-bit gate bootstrap (``boot.gate``) on the naive,
matmul and onthefly engines; slice 2 the circuit bootstrap
(``boot.circuit``: TLWE -> TRGSW over the 64-bit lvl2 ring on the chunked
engine), the LUT evaluator on its TRGSWs (``models.lut``) and the noise
worksheets (``noise``).
"""

from tfhe_tpu_torch import params as params
from tfhe_tpu_torch import rng as rng

__version__ = "0.1.0"
