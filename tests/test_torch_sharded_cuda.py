"""The instance-sharded engines on a card: every simkern launch on every
rank equals its plain version at shard width, a 2-rank mesh on the card
equals the same mesh on the CPU (and JAX's goldens), and the whole
sharded stress sweep (``stress --sharded``: 6 mixes x 2 seeds at 8 ranks,
too long for ``chip_smoke.py``) equals JAX's summary.  The ranks are
threads of one process, all on the one card, exchanging through a store
they share.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_sharded_cuda.py
"""

import importlib.util
import json
import os
import time

import pytest
import torch

from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.harness import stress
from tpu_paxos_torch.parallel import mesh as tmesh
from tpu_paxos_torch.parallel import sharded_sim as tss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the simkern kernels have no CPU mode")
    return torch.device("cuda")


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


@pytest.mark.cuda
def test_every_rank_launch_equals_plain_at_shard_width(card):
    """bench.py's sharded record at 2**20 instances on 8 ranks (I_loc =
    2**17): each kernel launch, on each rank, equals its plain version on
    its own operands before the launch goes ahead; the run equals JAX's
    golden."""
    script = _script()
    m = script.sharded_modules(port=True)
    gold = _goldens()["sharded_sim_2p20_d8"]
    cfg = script.sharded_sim_cfg(m, gold["config"])
    plains = {"store_accepts": (tsk.store_accepts_plain, (0, 1)),
              "accum_acks": (tsk.accum_acks_plain, (0,))}
    orig = {n: getattr(tsk, f"{n}_cuda") for n in plains}
    held, bad = {}, []

    def wrap(name):
        plain, in_place = plains[name]

        def launch(*ops):
            want = plain(*ops)
            got = orig[name](*[t.clone() if k in in_place else t for k, t in enumerate(ops)])
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                bad.append((tmesh.current_rank(), name))
            key = (tmesh.current_rank(), name)
            held[key] = held.get(key, 0) + 1
            return orig[name](*ops)
        return launch

    try:
        for n in plains:
            setattr(tsk, f"{n}_cuda", wrap(n))
        mesh = tmesh.make_instance_mesh(8, device=card)
        res = tss.run_sharded(cfg, mesh)
    finally:
        for n, f in sorted(orig.items()):
            setattr(tsk, f"{n}_cuda", f)
    assert not bad, bad
    assert sorted({r for r, _ in held}) == list(range(8))
    assert all(held[(r, n)] >= 1 for r in range(8) for n in plains)
    rec = script.sharded_record(m, cfg, None, res)
    assert rec == {k: gold[k] for k in rec}
    print(f"held per rank: {sorted(held.items())}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fault_free", "reference", "crashes", "gates"])
def test_two_ranks_on_the_card_equal_the_cpu(card, name):
    """A 2-rank mesh on the card makes the CPU mesh's run, array for
    array, and JAX's golden at 2 devices."""
    script = _script()
    m = script.sharded_modules(port=True)
    cfg, wl, gates = script.sharded_cases(m)[name]
    got = {}
    for dev in ("cpu", card):
        res = tss.run_sharded(cfg, tmesh.make_instance_mesh(2, device=dev), wl, gates)
        got[str(dev)] = script.sharded_record(m, cfg, wl, res)
    assert got["cpu"] == got[str(card)] == _goldens()["sharded_parity"][f"{name}@2"]


@pytest.mark.cuda
def test_stress_sweep_sharded_on_the_card_equals_jax(card):
    """``stress --sharded``'s sweep (6 mixes x 2 seeds at 8 ranks on the
    card): the summary less ``seconds`` and ``platform`` equals JAX's."""
    t0 = time.perf_counter()  # paxlint: allow[DET001] the sweep's wall, printed only; never compared
    s = stress.sweep_sharded(2, verbose=False, device=str(card))
    wall = time.perf_counter() - t0  # paxlint: allow[DET001] the sweep's wall, printed only; never compared
    name = torch.cuda.get_device_name(0)
    print(f"stress_sweep_sharded on {name}: {s['runs']} runs at {s['devices']} ranks, "
          f"wall_s={wall:.1f}, summary seconds={s['seconds']}")
    assert s["platform"] == "cuda"
    assert {k: v for k, v in s.items() if k not in ("seconds", "platform")} == \
        _goldens()["stress_sharded"]["summary"]


@pytest.mark.cuda
def test_mesh8_general_engine_cli_on_the_card(card):
    """``chip_smoke.py``'s former 19c ``4 4 10 ... --mesh 8`` CLI (cut for
    phase 20's room): its stdout equals the JAX CLI's golden."""
    import chip_smoke

    chip_smoke.DEV = str(card)
    started = chip_smoke.start_sharded_clis(_goldens(), ROOT, keys=("cli_4_4_10_mesh8",))
    chip_smoke.finish_sharded_clis(_goldens(), started, chip_smoke._card_line())
