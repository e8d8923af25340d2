"""The 64-bit conv product's two operand layouts on one card, in turns.

    python tools/torch_conv64_ab.py [--rounds 2]

At CB_MXU's lvl2 engine shape (L=6 limbs, J=10, U=2, N=2048) and B=256:
one step's key built by kernels.materialize_w (W, (L, J*N, U*N), row-major
for the GEMM) or by its K-packed entry kernels.materialize_wt (Wt, (L, U*N,
J*N), read through its transposed view), then the six int8 GEMMs
x @ W[l] through torch._int_mm (cuBLAS).  Both give the same int32 partials
(checked first); each round prints the device ms (chip_smoke.device_ms) of
each builder and of the six GEMMs on each layout, W then Wt, Wt then W.
The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c                                   # noqa: E402
from tfhe_tpu_torch.ops import kernels as K              # noqa: E402

L, J, U, N, B = 6, 10, 2, 2048, 256


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        print("torch_conv64_ab: no CUDA device is available", file=sys.stderr)
        return 1
    r = np.random.default_rng(0)
    v = torch.from_numpy(r.integers(-128, 128, (L, J, U, 2 * N))
                         .astype(np.int8)).cuda()
    x = torch.from_numpy(r.integers(-128, 129, (B, J * N))
                         .astype(np.int8)).cuda()
    w, wt = K.materialize_w(v), K.materialize_wt(v)
    same = all(torch.equal(torch._int_mm(x, w[lm]),
                           torch._int_mm(x, wt[lm].t())) for lm in range(L))
    print(f"W and Wt give the same partials: {same}")
    if not same:
        return 1
    cases = {"materialize_w": lambda: K.materialize_w(v),
             "materialize_wt": lambda: K.materialize_wt(v),
             "6 x _int_mm on W[l]": lambda: [torch._int_mm(x, w[lm])
                                             for lm in range(L)],
             "6 x _int_mm on Wt[l].t()": lambda: [torch._int_mm(x, wt[lm].t())
                                                  for lm in range(L)]}
    order = list(cases)
    for i in range(rounds):
        for name in (order if i % 2 == 0 else order[::-1]):
            print(f"round {i} {name}: {c.device_ms(cases[name], 10):.4f} ms",
                  flush=True)
    print(c.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
