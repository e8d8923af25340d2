"""The private key switch's kernel against the product it replaces, on the
card.

    python tools/torch_privks_ab.py [--reps 20] [--shapes cb_active.query4,...]
                                    [--no-sweep] [--parts]

At the shapes of the three circuit-bootstrap cells (``cb_active.query4``:
CB_ACTIVE at B=4; ``cb_active.b256``: CB_ACTIVE at B=256;
``cb_paper.b256``: CB_PAPER at B=256; also ``cb_active.b1``,
``cb_active.b64``, ``cb_paper.b4``), on a seeded random privKS table of
both z (int8 limbs, digit-0 rows zeroed, as ``PrivKeySwitchKey.generate``
leaves them) and random LWE64 samples:

  * ``prepare_privks``'s seconds (the packing, set-up work);
  * the kernel (``kernels.priv_keyswitch`` at its chosen plan and at every
    split of the sweep, through the wrapper's ``split``) held bit for bit
    against ``circuit.priv_keyswitch``, the product program C ran before
    (four ``torch._int_mm`` on the row-major limbs and a torch epilogue);
  * device ms a product (chip_smoke.device_ms: the host's enqueue hidden;
    the old product, tens of ms a call, by CUDA events around 5 calls),
    the launches alternating between the two z tables, each 0.5-1.3 GB,
    10-27 times the 50 MB L2, so every launch reads its table cold: the
    old product and the chosen plan in turns (old, new, new, old), then
    each split of the sweep, the chosen one marked;
  * the bound: the packed table's bytes once (4 K' UN) at 3.35 TB/s, and
    the share of it each time reaches;
  * with ``--parts``, the kernel built whole and stripped (PK_PART=1: key
    loads and wgmmas; 2: key loads and the A builds; 3: key loads alone)
    at split 1 and at the chosen split;
  * one torch._int_mm of the same product on the K-packed table
    (chip_smoke.privks_int_mm_kpacked, the one-hot built beforehand: ROADMAP
    K2's lever 1, which the port never calls).

Needs one card and nvcc; prints the card's name and power limit, then one
JSON line a shape.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from tfhe_tpu_torch.boot import circuit  # noqa: E402
from tfhe_tpu_torch.ops import _build  # noqa: E402
from tfhe_tpu_torch.ops import kernels as K  # noqa: E402
from tfhe_tpu_torch.params import CB_ACTIVE, CB_PAPER  # noqa: E402

SHAPES = {"cb_active.query4": (CB_ACTIVE, 4),
          "cb_active.b256": (CB_ACTIVE, 256), "cb_paper.b256": (CB_PAPER, 256), "cb_active.b1": (CB_ACTIVE, 1),
          "cb_active.b64": (CB_ACTIVE, 64), "cb_paper.b4": (CB_PAPER, 4)}
DEFAULT = ("cb_active.query4", "cb_active.b256", "cb_paper.b256")
SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 24, 33, 48, 66, 132)


def keys(P, seed: int = 0):
    """(row-major limbs (k+1, 4, (n+1) t base, (k+1) N1), the pksk over
    them, the packed table, packing seconds), on the card."""
    ks, kp1 = P.ks21, P.lvl1.k + 1
    n1 = P.n_lvl2 + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randint(-128, 128, (kp1, 4, n1 * ks.t * ks.base,
                                  kp1 * P.n_lvl1), dtype=torch.int8,
                      device="cuda", generator=g)
    w.view(kp1, 4, n1, ks.t, ks.base, -1)[:, :, :, :, 0] = 0
    pksk = circuit.PrivKeySwitchKey(ks, P.n_lvl2, P.lvl1.k, P.n_lvl1, w)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    packed = circuit.prepare_privks(w, ks)
    end.record()
    torch.cuda.synchronize()
    return w, pksk, packed, start.elapsed_time(end) / 1e3


def alternating(fn):
    """fn(z) as a call that takes z = 0, 1, 0, ... (the two tables)."""
    state = {"z": 0}

    def call():
        state["z"] ^= 1
        return fn(state["z"])
    return call


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", default=",".join(DEFAULT))
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line())
    _build.build_all()
    for log in sorted(_build.BUILD_DIR.glob("priv_keyswitch-*.ptxas.txt")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print("ptxas:", line.strip())
    sms = K.sm_count(torch.device("cuda"))
    r = np.random.default_rng(1)
    cache = {}
    for name in args.shapes.split(","):
        P, B = SHAPES[name]
        ks = P.ks21
        if P not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[P] = keys(P)
        w, pksk, packed, pack_s = cache[P]
        n1 = P.n_lvl2 + 1
        x = torch.from_numpy(r.integers(-2**63, 2**63, (B, n1),
                                        dtype=np.int64)).cuda()
        kq = K.privks_depth(n1, ks.t, ks.basebit)
        UN = packed.shape[2]
        rows, S, units = K.priv_keyswitch_plan(B, kq, UN, sms)

        def old(z):
            return circuit.priv_keyswitch(x, pksk, z)

        def new(z, split=0):
            return K.priv_keyswitch(x, packed[z], t=ks.t, basebit=ks.basebit,
                                    split=split)
        splits = sorted({s for s in SWEEP if s <= -(-kq // K.PK_BK)} | {S})
        for z in (0, 1):
            want = old(z).reshape(B, -1)
            for split in ([0] if args.no_sweep else [0, *splits]):
                got = new(z, split)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    print(f"{name} z={z} split={split}: NOT bit-identical",
                          file=sys.stderr)
                    return 1
        bound = 4 * kq * UN / cs.PEAK_BYTES * 1e3
        t_old, t_new = [], []
        for f, acc in ((old, t_old), (new, t_new), (new, t_new),
                       (old, t_old)):
            if f is old:                  # tens of ms a call: CUDA events
                acc.append(cs.cuda_ms(alternating(f), 5))
            else:
                acc.append(cs.device_ms(alternating(f), args.reps))
        a = cs.privks_kpacked_onehot(x, packed[0], t=ks.t, basebit=ks.basebit)
        lib_ms = cs.device_ms(alternating(
            lambda z: cs.privks_int_mm_kpacked(a, packed[z])), args.reps)
        sweep = {}
        if not args.no_sweep:
            for split in splits:
                sweep[split] = cs.device_ms(
                    alternating(lambda z: new(z, split)), args.reps)
        res = {"shape": name, "B": B, "t": ks.t, "basebit": ks.basebit,
               "kq": kq, "UN": UN, "plan": [rows, S, units],
               "pack_s": round(pack_s, 4), "old_ms": t_old, "new_ms": t_new,
               "bound_ms": bound,
               "bound_share": bound / min(t_new),
               "int_mm_kpacked_ms": lib_ms,
               "speedup": min(t_old) / min(t_new),
               "sweep_ms": {str(k): v for k, v in sweep.items()}}
        every = ", every split" if sweep else ""
        print(f"{name}: bit-identical (both z{every}); "
              f"plan rows={rows} S={S} units={units}; old {t_old[0]:.3f} / "
              f"{t_old[1]:.3f} ms, kernel {t_new[0]:.4f} / {t_new[1]:.4f} ms "
              f"(bound {bound:.4f}, {res['bound_share']:.1%}); packing "
              f"{pack_s:.3f} s; one _int_mm on the K-packed table "
              f"{lib_ms:.4f} ms")
        for split, ms in sweep.items():
            mark = " <- chosen" if split == S else ""
            print(f"  split {split:4d}: {ms:.4f} ms ({bound / ms:.1%}){mark}")
        if args.parts:
            res["parts_ms"] = parts(x, packed, ks, kq, rows, args.reps)
            print("  parts (split " + ", ".join(
                f"{sp}: " + ", ".join(f"{k} {v:.4f}" for k, v in d.items())
                for sp, d in res["parts_ms"].items()) + ") ms")
        print(json.dumps(res))
    return 0


PARTS = {"whole": (), "loads+wgmma": ("PK_PART=1",),
         "loads+build": ("PK_PART=2",), "loads": ("PK_PART=3",)}


def parts(x, packed, ks, kq, rows, reps):
    """Device ms of the kernel built whole and stripped (PK_PART), through
    its raw entry at the chosen plan's rows, at split 1 (64 or 32 blocks:
    the card's bandwidth left over, so a block's own chain shows) and at
    the chosen split."""
    fns = dict(zip(PARTS, _build.variants("priv_keyswitch",
                                          list(PARTS.values()))))
    B, n1 = x.shape
    out = torch.empty((B, packed.shape[2]), dtype=torch.int32,
                      device=x.device)
    sms = K.sm_count(x.device)
    res = {}
    for split in (1, K.priv_keyswitch_plan(B, kq, packed.shape[2], sms)[1]):
        res[split] = {}
        for name, fn in fns.items():
            def run(z, fn=fn):
                rc = fn(x.data_ptr(), packed[z].data_ptr(), out.data_ptr(), B,
                        n1, ks.t, ks.basebit, packed.shape[2],
                        packed.shape[3], rows, split,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"priv_keyswitch part {name}: "
                                       f"cudaError {rc}")
            res[split][name] = cs.device_ms(alternating(run), reps)
    return res


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
