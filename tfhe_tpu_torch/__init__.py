"""tfhe_tpu_torch — the PyTorch/CUDA port of ``tfhe_tpu`` for NVIDIA Hopper.

Same module layout as ``tfhe_tpu``; every path is exact integer arithmetic
mod 2^32 or 2^64, so each function here is held bit for bit against its JAX
counterpart.  The hot loop (the blind-rotation CMux step) runs in CUDA C++
kernels written for sm_90a (``ops/csrc``), built with nvcc at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper takes its plain PyTorch version.  Keys are
generated on the host with numpy (``rng.TfheRng``) and moved to the device
once.

Modules: the torus, LWE, TRLWE and TRGSW layers; the gate bootstrap and
its gate set (``boot.gate``); the circuit bootstrap (``boot.circuit``: TLWE
-> TRGSW over the 64-bit lvl2 ring), the LUT evaluator (``models.lut``),
the decrypt probes (``boot.probe``) and the circuit scheduler
(``runtime.scheduler``); the noise worksheets (``noise``); key conversion
from the JAX package (``convert``) and key files (``utils.serialization``);
the native C++ oracle (``utils.native``).  Every backend name of the JAX
package's ``make_engine`` is an engine here (``ops.engine``): naive,
matmul, onthefly, chunked, conv, conv_bf16 (exact), nussbaumer (exact on
keys divisible by 2m, ``ops.nussbaumer``), and fft, fft_f64, fft_dd
(approximate, ``ops.fft``), and the high-precision FFT study
(``ops.hpfft``).  ``graphs`` is the counterpart of ``jax.jit``: on the card
the blind rotation, ``boot.gate.make_bootstrap_fn``, the staged circuit
bootstrap and the scheduler's launches and chains each run as one captured
CUDA graph (``graphs.disable()`` runs them eagerly).  ``parallel`` is the
multi-device layer on ``torch.distributed``: one process a rank, the batch
split over dp, the digit and key-switch rows over ep (one exact all-reduce
a step), host-aware start-up and placement (``parallel.multihost``).
"""

from tfhe_tpu_torch import params as params
from tfhe_tpu_torch import torus as torus
from tfhe_tpu_torch import rng as rng

__version__ = "0.1.0"
