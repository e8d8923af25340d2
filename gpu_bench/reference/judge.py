"""Judging the program's answers: the reference works every sampled answer
out again from the same raw cloud key and inputs, and an answer is right
only when it is the same ciphertext, every coefficient (the program's
arithmetic is exact, so an answer that differs anywhere is a different
result: more noise, a dropped key bit, a skipped step).

A sample names its judge: one of ``JUDGES``, ``circuit:<netlist>`` for a
netlist of ``circuits.NETLISTS``, or the name of a judge file,
``reference/judges/<name>.py`` under the benchmark's folder, which defines
``judge(inputs, key, cfg, extra) -> torch.Tensor`` as the functions below
and, as all of ``reference/``, imports nothing of the program."""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch

from gpu_bench.reference import circuits as RC
from gpu_bench.reference import tfhe as R


def _gate(inputs, key, cfg, extra):
    rotation = R.BlindRotation(key["bk"], cfg["l"], cfg["bgbit"], 32)
    return R.gate_bootstrap(inputs, key, rotation, cfg["ks_t"],
                            cfg["ks_basebit"])


def _circuit_bootstrap(inputs, key, cfg, extra):
    return R.circuit_bootstrap(inputs, key, cfg)


def _netlist(name, inputs, key, cfg, extra):
    net = RC.NETLISTS[name](extra["bits"])
    return RC.evaluate(net, inputs.transpose(0, 1), key, cfg).transpose(0, 1)


JUDGES = {"gate_bootstrap": _gate, "circuit_bootstrap": _circuit_bootstrap}


def find_judge(name: str, folder: Path):
    """The judge a sample names: built in, else ``judge`` of
    ``reference/judges/<name>.py`` under the benchmark's ``folder``."""
    if name in JUDGES:
        return JUDGES[name]
    kind, _, netlist = name.partition(":")
    if kind == "circuit" and netlist in RC.NETLISTS:
        return functools.partial(_netlist, netlist)
    path = Path(folder) / "reference" / "judges" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"judge {name!r} is not built in and there is no "
                         f"file {path}")
    spec = importlib.util.spec_from_file_location(f"judge_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.judge


def wrong_answers(sample, key: dict, cfg: dict, folder: Path) -> int:
    """How many of the sampled answers differ from the reference's."""
    want = find_judge(sample.reference, folder)(sample.inputs, key, cfg,
                                                sample.extra)
    got = sample.outputs.to(torch.int64).to(want.device)
    return int((got != want).reshape(got.shape[0], -1).any(1).sum())
