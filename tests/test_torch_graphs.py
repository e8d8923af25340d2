"""The port's program layer (tfhe_tpu_torch.graphs, the counterpart of
jax.jit) on the CPU, where every program runs eagerly:

  * runtime.scheduler.evaluate with TFHE_WAVE_CHAIN at 1, 2 and 4 on a
    4-bit adder and a 4-bit comparator at GATE_TOY gives tfhe_tpu's
    ciphertexts bit for bit, and counts the compiles the JAX package counts
    (circuit.wave_compiles per launch, circuit.chain_compiles per chain
    signature), none on a second run;
  * the counter bookkeeping that lets a replay count as launches
    (counters / delta / add) as a pure-Python unit;
  * disable() nests, and run() is eager and uncached under it;
  * run()'s cache key on the CPU: structure, input shapes, the step knobs
    and the key tensors' identity.

The graphs themselves run only on the card (tests/test_torch_cuda.py).
Keys: the same TfheRng seed in both packages.  Tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from tfhe_tpu.boot import gate as jgate
from tfhe_tpu.params import GATE_TOY
from tfhe_tpu.rng import TfheRng as JRng
from tfhe_tpu.runtime import scheduler as jsched
from tfhe_tpu.utils import observability as jobs
from tfhe_tpu_torch import graphs
from tfhe_tpu_torch.boot import gate
from tfhe_tpu_torch.params import GATE_TOY as T_TOY
from tfhe_tpu_torch.rng import TfheRng
from tfhe_tpu_torch.runtime import scheduler
from tfhe_tpu_torch.utils import observability as obs

COMPILES = ("circuit.wave_compiles", "circuit.chain_compiles")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _keys(seed=13):
    jrng = JRng(seed)
    jsk = jgate.SecretKey.generate(GATE_TOY, jrng)
    jck = jgate.CloudKey.generate(jsk, jrng, backend="onthefly")
    rng = TfheRng(seed)
    sk = gate.SecretKey.generate(T_TOY, rng)
    ck = gate.CloudKey.generate(sk, rng, backend="onthefly", device="cpu")
    return jrng, jsk, jck, sk, ck


BUILDERS = {"adder4": "ripple_carry_adder", "comparator4": "comparator"}


def _plain(name, bits):
    x = sum(bits[i].astype(int) << i for i in range(4))
    y = sum(bits[4 + i].astype(int) << i for i in range(4))
    if name == "adder4":
        return np.stack([((x + y) >> i) & 1 for i in range(5)]).astype(bool)
    return np.stack([x < y, x == y, x > y])


@pytest.mark.parametrize("chain", ["1", "2", "4"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_evaluate_chained_matches_jax(monkeypatch, name, chain):
    """Ciphertexts and compile counts equal the JAX package's at
    TFHE_WAVE_CHAIN = chain; a second run replays (compiles nothing) in
    both packages."""
    jrng, jsk, jck, sk, ck = _keys()
    bits = np.random.default_rng(len(name) + int(chain)).integers(
        0, 2, (8, 2))
    cts = np.stack([np.asarray(jgate.encrypt_bool(jsk, b, jrng))
                    for b in bits])
    monkeypatch.setenv("TFHE_WAVE_CHAIN", chain)
    jsched._WAVE_JIT.clear()
    jsched._CHAIN_JIT.clear()
    graphs.clear()
    jcirc, jouts = getattr(jsched, BUILDERS[name])(4)
    tcirc, touts = getattr(scheduler, BUILDERS[name])(4)
    for run in range(2):
        jobs.reset()
        want = np.asarray(jsched.evaluate(jcirc, cts, jck.data, GATE_TOY,
                                          jouts, backend="onthefly"))
        obs.reset()
        got = scheduler.evaluate(tcirc, torch.from_numpy(cts), ck.data,
                                 T_TOY, touts, backend="onthefly")
        np.testing.assert_array_equal(got.numpy(), want)
        jrep, rep = jobs.report()["counters"], obs.report()["counters"]
        for c in COMPILES + ("bootstrap.launches", "bootstrap.ciphertexts"):
            assert rep.get(c, 0) == jrep.get(c, 0), (run, c)
        counted = COMPILES[0] if chain == "1" else COMPILES[1]
        assert (rep.get(counted, 0) > 0) == (run == 0)
        assert "graph.captures" not in rep and "graph.replays" not in rep
    dec = np.stack([gate.decrypt_bool(sk, got[i]) for i in range(len(touts))])
    np.testing.assert_array_equal(dec, _plain(name, bits.astype(bool)))


def test_counter_bookkeeping():
    """What a capture counts is taken back, and a replay adds it again:
    kernel launches, the per-call transposes and the other counters, all
    of them observability counters."""
    obs.reset()
    obs.count("kernel.materialize_wt", 5)
    obs.count("bootstrap.launches", 2)
    before = graphs.counters()
    assert before["kernel.materialize_wt"] == 5
    assert "kernel.fused_cmux_step_v2" not in before
    assert before["bootstrap.launches"] == 2
    obs.count("kernel.materialize_wt", 500)          # what a capture counts
    obs.count("kernel.fused_cmux_step_v2", 500)
    obs.count("kernel.ck_dot64p.transposes", 3)
    obs.count("bootstrap.launches")
    obs.count("bootstrap.ciphertexts", 8)
    d = graphs.delta(before, graphs.counters())
    assert d == {"kernel.materialize_wt": 500,
                 "kernel.fused_cmux_step_v2": 500,
                 "kernel.ck_dot64p.transposes": 3,
                 "bootstrap.launches": 1, "bootstrap.ciphertexts": 8}
    graphs.add(d, -1)                                # the capture's count out
    after = graphs.counters()
    assert graphs.delta(before, after) == {}
    for _ in range(3):                               # three replays
        graphs.add(d)
    now = graphs.counters()
    assert now["kernel.materialize_wt"] == 5 + 3 * 500
    assert now["kernel.fused_cmux_step_v2"] == 3 * 500
    assert now["kernel.ck_dot64p.transposes"] == 9
    assert now["bootstrap.launches"] == 2 + 3
    assert now["bootstrap.ciphertexts"] == 3 * 8
    obs.reset()


def test_disable_nests():
    assert graphs.enabled()
    with graphs.disable():
        assert not graphs.enabled()
        with graphs.disable():
            assert not graphs.enabled()
        assert not graphs.enabled()
    assert graphs.enabled()
    with pytest.raises(RuntimeError):
        with graphs.disable():
            raise RuntimeError("out")
    assert graphs.enabled()


def test_run_on_the_cpu_is_eager_and_counts_misses(monkeypatch):
    """On CPU tensors run() calls fn every time; with a counter it counts
    one compile per new key (structure, input shapes, step knobs, key
    identity), none under disable() and none without a counter."""
    graphs.clear()
    obs.reset()
    calls = []
    key = torch.arange(4)

    def fn(x):
        calls.append(1)
        return x.sum() + key

    x = torch.zeros(4, dtype=torch.int64)

    def run(x, structure="s", k=key):
        return graphs.run("test", structure, fn, (x,), (k,),
                          compiles="test.compiles")

    assert torch.equal(run(x), key)
    run(x + 1)                                        # a hit: same shapes
    assert obs.report()["counters"]["test.compiles"] == 1
    run(torch.zeros(5, dtype=torch.int64)[:4] + 0)
    assert obs.report()["counters"]["test.compiles"] == 1
    run(torch.zeros(3, dtype=torch.int64))            # a new shape
    run(x, structure="t")                             # a new structure
    run(x, k=key.clone())                             # another key tensor
    monkeypatch.setenv("TFHE_CK64_FUSED", "1")        # a step knob
    run(x)
    assert obs.report()["counters"]["test.compiles"] == 5
    with graphs.disable():
        run(torch.zeros(7, dtype=torch.int64))
    graphs.run("test", "u", fn, (x,), (key,))
    assert obs.report()["counters"]["test.compiles"] == 5
    assert len(calls) == 9
    assert "graph.captures" not in obs.report()["counters"]
    graphs.clear()
    obs.reset()


def test_leaves_take_every_key_tensor():
    a, b, c, d = (torch.zeros(i + 1) for i in range(4))
    got = graphs.leaves({"ksw": a, "bk": {"hat": (b, c), "v": d}})
    assert [t.shape[0] for t in got] == [2, 3, 4, 1]
    assert graphs.leaves(a) == (a,)
    assert graphs.leaves(3) == ()


def test_the_cache_bound(monkeypatch):
    """Past MAX_PROGRAMS entries the least recently used go first (a miss
    after that counts again), and clear() empties the cache."""
    graphs.clear()
    obs.reset()
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    key = torch.arange(2)

    def run(shape):
        return graphs.run("bound", (), lambda x: x.sum() + key,
                          (torch.zeros(shape, dtype=torch.int64),), (key,),
                          compiles="bound.compiles")

    for shape in (1, 2, 1, 3, 1, 2):    # 2 is evicted by 3, counted again
        run(shape)
    assert obs.report()["counters"]["bound.compiles"] == 4
    assert len(graphs._programs) == 2
    graphs.clear()
    assert len(graphs._programs) == 0
    obs.reset()
