"""Host-side randomness for key generation and encryption.

The reference uses a process-global std::default_random_engine with uniform
and Gaussian samplers (generic_utils.h:130-190).  Here the generator is an
explicit seeded numpy Generator (keygen/encryption are host-side, cold-path
operations; the device hot path — bootstrapping — consumes no randomness).

``false_random=True`` reproduces the reference's FALSE_RANDOM compile switch
(generic_utils.h:131-149): key bits all 1, "uniform" words 0xcccc...,
Gaussians collapse to their center.  That mode makes every pipeline fully
deterministic and is the bit-exactness anchor against the C++ oracle.
"""

from __future__ import annotations

import numpy as np

_TWO32 = 2.0**32
_TWO64 = 2.0**64


class TfheRng:
    def __init__(self, seed: int = 0, false_random: bool = False):
        self.false_random = false_random
        self._gen = np.random.Generator(np.random.PCG64(seed))

    # --- uniform samplers (generic_utils.h:134-136 / 169-171) ---

    def bit(self, shape=()):
        if self.false_random:
            return np.ones(shape, np.int32)
        return self._gen.integers(0, 2, size=shape, dtype=np.int32)

    def uniform32(self, shape=()):
        if self.false_random:
            return np.full(shape, np.int32(np.uint32(0xCCCCCCCC).astype(np.int32)))
        return self._gen.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)

    def uniform64(self, shape=()):
        if self.false_random:
            return np.full(shape, np.uint64(0xCCCCCCCCCCCCCCCC).astype(np.int64))
        bits = self._gen.integers(0, 2**64, size=shape, dtype=np.uint64)
        return bits.astype(np.int64)

    # --- Gaussian-on-torus samplers (generic_utils.h:176-189) ---

    def gaussian32(self, center, stdev: float, shape=()):
        center = np.asarray(center, np.int32)
        if self.false_random or stdev == 0.0:
            return np.broadcast_to(center, shape).astype(np.int32).copy()
        val = stdev * self._gen.standard_normal(shape) * _TWO32
        # C++ casts double->int32 (truncation); emulate with a wide cast.
        ival = np.trunc(val).astype(np.int64).astype(np.int32)
        return (ival + center).astype(np.int32)

    def gaussian64(self, center, stdev: float, shape=()):
        center = np.asarray(center, np.int64)
        if self.false_random or stdev == 0.0:
            return np.broadcast_to(center, shape).astype(np.int64).copy()
        val = stdev * self._gen.standard_normal(shape) * _TWO64
        with np.errstate(invalid="ignore"):
            ival = np.trunc(val)
            # emulate C++ double->int64 conversion with wrap via float128-free
            # path: values are far below 2^63 for any sane stdev.
            ival = ival.astype(np.int64)
        return (ival + center).astype(np.int64)
