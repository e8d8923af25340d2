"""Frozen work counts of a launch's CMux trees (``models.lut.lut_tree``), from
the configuration's parameters, so that a change of the tree's kernels
reads the same work:

* MACs: instances * (2^k - 1) CMux rows, each of its (k+1) l1 digit
  polynomials against the (k+1) output polynomials of the selector, every
  one of the key's 4 int8 limbs, N1^2 per negacyclic product:
  instances (2^k - 1) (k+1) l1 N1 (k+1) N1 4;
* bytes, torus32: the selectors' rows read once (instances * k TRGSWs), the
  leaves, and each level's accumulators written and read once (level j
  writes instances * 2^(k-1-j) rows; level 0 reads the leaves, level j > 0
  what level j - 1 wrote).

The tree's bound is max(2 MACs / int8 peak, bytes / bandwidth), with the
peaks of ``roofline.PEAKS``.  The ring is lvl1's, k = 1."""

from __future__ import annotations

from gpu_bench.roofline import bound_s

LIMBS = 4


def tree_work(cfg: dict, instances: int, lut_bits: int) -> tuple:
    """(int8 MACs, bytes) of the CMux trees of ``instances`` LUTs of
    ``lut_bits`` bits."""
    kp1, l, N = 2, cfg["ell_lvl1"], cfg["n_lvl1"]
    rows = (1 << lut_bits) - 1                  # CMuxes of one tree
    macs = instances * rows * kp1 * l * N * kp1 * N * LIMBS
    row = kp1 * N * 4                           # one TRLWE, bytes
    selectors = instances * lut_bits * kp1 * l * row
    leaves = (1 << lut_bits) * row
    written = instances * rows * row
    read = instances * (rows - 1) * row
    return macs, selectors + leaves + written + read


def tree_bound_s(cfg: dict, instances: int, lut_bits: int,
                 peaks: dict) -> float:
    return bound_s(*tree_work(cfg, instances, lut_bits), peaks)
