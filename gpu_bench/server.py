"""The server: the program under test (``tfhe_tpu_torch``), given the
client's raw cloud key.

Set-up derives the program's evaluation form from the raw key with the
program's own functions (engine ``prepare``: the onthefly doubled limbs or
the chunked, K-packed ``wmt``; the key-switch limb matrices), timed as
``key_prep_s`` with the card synchronised.  The entries are the ones users
call: ``gate.make_bootstrap_fn``, ``circuit.make_circuit_bootstrap_staged``
and ``runtime.scheduler.evaluate``.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def gate_params(cfg: dict, key_limbs: int | None = None):
    """The configuration's numbers as the program's GateParams, checked
    against the preset the file names (unless a control changes the key
    limbs)."""
    from tfhe_tpu_torch import params as P
    limbs = cfg["key_limbs"] if key_limbs is None else key_limbs
    built = P.GateParams(
        lwe=P.LweParams(n=cfg["n"], stdev=2.0 ** cfg["lwe_stdev_log2"]),
        tgsw=P.TGswParams(l=cfg["l"], bgbit=cfg["bgbit"], key_limbs=limbs,
                          tlwe=P.TLweParams(
                              N=cfg["N"], k=cfg["k"],
                              stdev=2.0 ** cfg["ring_stdev_log2"], bits=32)),
        ks=P.KeySwitchParams(t=cfg["ks_t"], basebit=cfg["ks_basebit"],
                             stdev=2.0 ** cfg["ks_stdev_log2"]))
    _check_preset(cfg, built, key_limbs)
    return built


def circuit_params(cfg: dict, key_limbs: int | None = None):
    from tfhe_tpu_torch import params as P
    built = P.make_circuit_params(
        n_lvl0=cfg["n_lvl0"], n_lvl1=cfg["n_lvl1"], n_lvl2=cfg["n_lvl2"],
        bgbit_lvl1=cfg["bgbit_lvl1"], ell_lvl1=cfg["ell_lvl1"],
        bgbit_lvl2=cfg["bgbit_lvl2"], ell_lvl2=cfg["ell_lvl2"],
        bk_stdev=2.0 ** cfg["bk_stdev_log2"],
        ks_stdev_10=2.0 ** cfg["ks_stdev_10_log2"],
        ks_len_10=cfg["ks_len_10"], ks_basebit_10=cfg["ks_basebit_10"],
        ks_stdev_21=2.0 ** cfg["ks_stdev_21_log2"],
        ks_len_21=cfg["ks_len_21"], ks_basebit_21=cfg["ks_basebit_21"],
        bk_limbs=cfg["bk_limbs"] if key_limbs is None else key_limbs)
    _check_preset(cfg, built, key_limbs)
    return built


def _check_preset(cfg, built, key_limbs):
    from tfhe_tpu_torch import params as P
    if key_limbs is None and built != getattr(P, cfg["preset"]):
        raise ValueError(f"{cfg['name']}: the file's numbers are not the "
                         f"program's {cfg['preset']}")


@dataclasses.dataclass
class GateServer:
    """Gate bootstrapping and circuits through the scheduler."""
    params: object
    backend: str
    key_data: dict
    key_prep_s: float

    @staticmethod
    def build(cfg: dict, raw: dict, device, key_limbs=None) -> "GateServer":
        from tfhe_tpu_torch import lwe, tgsw
        from tfhe_tpu_torch.boot import gate
        from tfhe_tpu_torch.ops.engine import make_engine, stack_prepared
        p = gate_params(cfg, key_limbs)
        backend = cfg["backend"]
        sync(device)
        t0 = time.perf_counter()
        eng = make_engine(tgsw.engine_config(p.tgsw), backend)
        rows = tgsw.rows(raw["bk"])                     # (n, kpl, k+1, N)
        if backend == "chunked":
            prep = eng.prepare(rows)
        else:
            prep = stack_prepared([eng.prepare(rows[i])
                                   for i in range(rows.shape[0])])
        ksk = lwe.KeySwitchKey.from_raw(raw["ksk"].cpu().numpy(), p.ks,
                                        keep_raw=False, device=device)
        key_data = gate.CloudKey(p, backend, prep, ksk).data
        sync(device)
        return GateServer(p, backend, key_data, time.perf_counter() - t0)

    def bootstrap_fn(self):
        """samples (B, n+1) int32 -> bootstrapped samples, one program."""
        from tfhe_tpu_torch.boot import gate
        fn = gate.make_bootstrap_fn(self.params, backend=self.backend)
        return lambda samples: fn(self.key_data, samples)

    def circuit(self, name: str, bits: int):
        """One of the scheduler's circuit builders: (Circuit, outputs)."""
        from tfhe_tpu_torch.runtime import scheduler
        return getattr(scheduler, name)(bits)

    def evaluate(self, circ, inputs, outputs):
        from tfhe_tpu_torch.runtime import scheduler
        return scheduler.evaluate(circ, inputs, self.key_data, self.params,
                                  outputs, backend=self.backend)


@dataclasses.dataclass
class CircuitServer:
    """Circuit bootstrapping through the staged programs."""
    params: object
    backend: str
    key_data: dict
    key_prep_s: float

    @staticmethod
    def build(cfg: dict, raw: dict, device,
              key_limbs=None) -> "CircuitServer":
        from tfhe_tpu_torch import lwe
        from tfhe_tpu_torch import torus as T
        from tfhe_tpu_torch.boot import circuit
        p = circuit_params(cfg, key_limbs)
        backend = cfg["backend"]
        sync(device)
        t0 = time.perf_counter()
        preks = lwe.KeySwitchKey.from_raw(raw["preks"].cpu().numpy(),
                                          p.ks10, keep_raw=False,
                                          device=device)
        bk = circuit.prepare_circuit_bk(raw["bk"], p, backend)
        # privKS as PrivKeySwitchKey.generate leaves it: digit-0 rows
        # zeroed (the reference skips them), int8 limb matrices
        raw_pk = raw["privks"]
        kp1, rows = raw_pk.shape[0], raw_pk[0, ..., 0, 0].numel()
        w = torch.empty((kp1, 4, rows, raw_pk.shape[-2] * raw_pk.shape[-1]),
                        dtype=torch.int8, device=device)
        for z in range(kp1):
            c = raw_pk[z].clone()
            c[:, :, 0] = 0
            w[z] = T.balanced_limbs(c.reshape(rows, -1), 4, 8)
            del c
        privks = circuit.PrivKeySwitchKey(p.ks21, p.n_lvl2, p.lvl1.k,
                                          p.n_lvl1, w)
        key_data = circuit.CircuitCloudKey(p, backend, preks, bk,
                                           privks).data
        sync(device)
        return CircuitServer(p, backend, key_data, time.perf_counter() - t0)

    def bootstrap_fn(self):
        """samples (B, n1+1) int32 -> TRGSW (B, k+1, ell1, k+1, N1)."""
        from tfhe_tpu_torch.boot import circuit
        fn = circuit.make_circuit_bootstrap_staged(self.params, self.backend)
        return lambda samples: fn(samples, self.key_data)


SERVERS = {"gate": GateServer, "circuit": CircuitServer}


def counters():
    from tfhe_tpu_torch.utils import observability as obs
    return obs.report()["counters"]


def reset_counters():
    from tfhe_tpu_torch.utils import observability as obs
    obs.reset()


def release():
    """Drop the program's captured programs and cached memory."""
    from tfhe_tpu_torch import graphs
    graphs.clear()
