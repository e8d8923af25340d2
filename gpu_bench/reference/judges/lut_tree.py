"""k-bit look-up tables over circuit-bootstrapped selectors, the answers
of the ``lut_stream`` loop: each sampled query's bits circuit-bootstrapped
by the reference, then its CMux tree folded with plain external products
over the table's leaves (d0 + TRGSW x (d1 - d0), level by level, least
significant bit first).  A leaf is the noiseless trivial TRLWE (0, row):
a table of (2^k,) scalars puts its value at coefficient 0, a table of
(2^k, N) rows is the body polynomial (one output a coefficient)."""

import torch

from gpu_bench.reference import tfhe as R


def judge(inputs, key, cfg, extra):
    S, k, m = inputs.shape
    gsw = R.circuit_bootstrap(inputs.reshape(S * k, m), key, cfg)
    kp1, l, N = gsw.shape[1], gsw.shape[2], gsw.shape[-1]
    gsw = gsw.reshape(S, k, kp1 * l, kp1, N)
    table = extra["table"].to(inputs.device)
    leaves = torch.zeros((1 << k, kp1, N), dtype=torch.int64,
                         device=inputs.device)
    if table.ndim == 1:
        leaves[:, -1, 0] = table
    else:
        leaves[:, -1] = table
    out = []
    for s in range(S):
        acc = leaves
        for j in range(k):
            diff = R.wrap32(acc[1::2] - acc[0::2])
            digits = R.decompose(diff, l, cfg["bgbit_lvl1"], 32)
            prod = R.external_product(digits.reshape(-1, kp1 * l, N),
                                      R.trgsw_spectrum(gsw[s, j], 32), 32)
            acc = R.wrap32(acc[0::2] + prod)
        out.append(acc[0])
    return torch.stack(out)
