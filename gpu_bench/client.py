"""The client: secret keys, the raw cloud key and the encrypted inputs, made
from ``--seed`` on the run's device in plain PyTorch.

The raw cloud key is what a TFHE client sends a server: TRGSW encryptions
of the small key's bits and the key-switching tables, as plain torus
integers.  Both the program (which derives its evaluation form from it) and
the reference take these tensors; neither makes its own.  One seed gives
the same keys and inputs on every run (one ``torch.Generator`` on the
device, drawn in a fixed order).
"""

from __future__ import annotations

import torch

from gpu_bench.reference import tfhe as R


class Client:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 63))

    # --- draws ---

    def bits(self, shape):
        return torch.randint(0, 2, tuple(shape), generator=self.gen,
                             device=self.device, dtype=torch.int64)

    def uniform(self, shape, bits: int):
        """Uniform torus values as int64 (in [-2^31, 2^31) at 32 bits)."""
        lo = torch.randint(0, 1 << 32, tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.int64)
        if bits == 32:
            return lo - (1 << 31)
        hi = torch.randint(0, 1 << 32, tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.int64)
        return (hi << 32) | lo

    def gaussian(self, shape, stdev: float, bits: int):
        """Centred Gaussian torus noise of ``stdev`` (torus units),
        truncated toward zero as the reference's double -> int cast."""
        e = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float64)
        return torch.trunc(e * (stdev * 2.0 ** bits)).to(torch.int64)

    # --- encryption ---

    def lwe(self, key, messages, stdev: float):
        """LWE32 samples (..., n+1) of int64 torus32 messages under the
        binary key (n,)."""
        a = self.uniform(messages.shape + key.shape, 32)
        b = (a * key).sum(-1) + self.gaussian(messages.shape, stdev, 32) \
            + messages
        return R.wrap32(torch.cat([a, b[..., None]], dim=-1))

    def trlwe_zero(self, key, shape, stdev: float, bits: int):
        """TRLWE encryptions of zero (*shape, k+1, N) under key (k, N)."""
        k, N = key.shape
        a = self.uniform(tuple(shape) + (k, N), bits)
        b = R.key_times(a, key, bits) + self.gaussian(tuple(shape) + (N,),
                                                       stdev, bits)
        if bits == 32:
            b = R.wrap32(b)
        return torch.cat([a, b[..., None, :]], dim=-2)

    def trgsw(self, key, messages, l: int, bgbit: int, stdev: float,
              bits: int):
        """TRGSW (n, k+1, l, k+1, N) of small integer messages (n,)."""
        k, N = key.shape
        c = self.trlwe_zero(key, (messages.shape[0], k + 1, l), stdev, bits)
        h = torch.tensor([R.signed64(1 << (bits - (j + 1) * bgbit))
                          for j in range(l)], dtype=torch.int64,
                         device=self.device)
        for u in range(k + 1):
            c[:, u, :, u, 0] += messages[:, None] * h
        return R.wrap32(c) if bits == 32 else c

    def ks_table(self, in_key, out_key, t: int, basebit: int, stdev: float):
        """ks[i, j, v] = LWE_out(in_key[i] * v * 2^(32-(j+1)basebit)):
        (n_in, t, base, n_out+1) int32 (lweCreateKeySwitchKey)."""
        shifts = torch.tensor([32 - (j + 1) * basebit for j in range(t)],
                              device=self.device)
        v = torch.arange(1 << basebit, device=self.device)
        m = R.wrap32((in_key[:, None, None] << shifts[None, :, None])
                     * v[None, None, :])
        return self.lwe(out_key, m, stdev).to(torch.int32)

    # --- whole keys ---

    def gate_key(self, p: dict):
        """Secret keys and raw cloud key of a gate-bootstrapping
        configuration (numbers of the configuration's file)."""
        s = self.bits((p["n"],))
        S = self.bits((p["k"], p["N"]))
        bk = self.trgsw(S, s, p["l"], p["bgbit"], 2.0 ** p["ring_stdev_log2"],
                        32).to(torch.int32)
        ksk = self.ks_table(S.reshape(-1), s, p["ks_t"], p["ks_basebit"],
                            2.0 ** p["ks_stdev_log2"])
        return {"lwe_key": s, "ring_key": S}, {"bk": bk, "ksk": ksk}

    def circuit_key(self, p: dict):
        """Secret keys and raw cloud key of a circuit-bootstrapping
        configuration: preKS (lvl1 -> lvl0), the TRGSW64 bootstrapping key
        of the lvl0 bits, and the private functional key-switching tables
        privKS[z] (lvl2 LWE -> lvl1 TRLWE of K_z * message, K_0 = -s1,
        K_1 = 1; poc_CircuitBootstrapping.cpp:367, 405-419)."""
        s0 = self.bits((p["n_lvl0"],))
        S1 = self.bits((1, p["n_lvl1"]))
        S2 = self.bits((1, p["n_lvl2"]))
        preks = self.ks_table(S1.reshape(-1), s0, p["ks_len_10"],
                              p["ks_basebit_10"],
                              2.0 ** p["ks_stdev_10_log2"])
        bk = self.trgsw(S2, s0, p["ell_lvl2"], p["bgbit_lvl2"],
                        2.0 ** p["bk_stdev_log2"], 64)
        t, bb = p["ks_len_21"], p["ks_basebit_21"]
        key2ext = torch.cat([S2.reshape(-1),
                             torch.tensor([-1], device=self.device)])
        shifts = torch.tensor([32 - (j + 1) * bb for j in range(t)],
                              device=self.device)
        v = torch.arange(1 << bb, device=self.device)
        mess = R.wrap32((key2ext[:, None, None] << shifts[None, :, None])
                        * v[None, None, :])              # (n2+1, t, base)
        privks = torch.empty((2,) + tuple(mess.shape) + (2, p["n_lvl1"]),
                             dtype=torch.int32, device=self.device)
        for z in range(2):
            c = self.trlwe_zero(S1, mess.shape,
                                2.0 ** p["ks_stdev_21_log2"], 32)
            c[..., z, 0] = R.wrap32(c[..., z, 0] + mess)
            privks[z] = c.to(torch.int32)
            del c
        return ({"key_lvl0": s0, "ring_lvl1": S1, "ring_lvl2": S2},
                {"preks": preks, "bk": bk, "privks": privks})
