"""Judging the program's answers: the reference works every sampled answer
out again from the same raw cloud key and inputs, and an answer is right
only when it is the same ciphertext, every coefficient (the program's
arithmetic is exact, so an answer that differs anywhere is a different
result: more noise, a dropped key bit, a skipped step)."""

from __future__ import annotations

import torch

from gpu_bench.reference import circuits as RC
from gpu_bench.reference import tfhe as R


def _gate(inputs, key, cfg, extra):
    rotation = R.BlindRotation(key["bk"], cfg["l"], cfg["bgbit"], 32)
    return R.gate_bootstrap(inputs, key, rotation, cfg["ks_t"],
                            cfg["ks_basebit"])


def _circuit_bootstrap(inputs, key, cfg, extra):
    return R.circuit_bootstrap(inputs, key, cfg)


def _netlist(name):
    def run(inputs, key, cfg, extra):
        net = RC.NETLISTS[name](extra["bits"])
        return RC.evaluate(net, inputs.transpose(0, 1), key, cfg).transpose(
            0, 1)
    return run


JUDGES = {"gate_bootstrap": _gate, "circuit_bootstrap": _circuit_bootstrap,
          **{"circuit:" + n: _netlist(n) for n in RC.NETLISTS}}


def wrong_answers(sample, key: dict, cfg: dict) -> int:
    """How many of the sampled answers differ from the reference's."""
    want = JUDGES[sample.reference](sample.inputs, key, cfg, sample.extra)
    got = sample.outputs.to(torch.int64).to(want.device)
    return int((got != want).reshape(got.shape[0], -1).any(1).sum())
