"""The selection loop on a card: evolve-quick and the certified recall
(``BENCH_evolve.json``'s contract, through the CLI in its own process) run
on CUDA and equal JAX's goldens:
the summaries less the wall fields (with JAX's zero pattern of builds per
generation), the shrunk artifacts' bytes, and the bench record, with both
``simkern`` kernels launching on the 8-lane population's operands.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_evolve_cuda.py
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.fleet import envelope
from tpu_paxos_torch.fleet import evolve as evo
from tpu_paxos_torch.harness import shrink as shr

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


def _gold():
    with open(GOLDENS) as f:
        return json.load(f)["evolve"]


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _lane_shapes():
    """Wrap both kernels to record the lane count of each launch."""
    seen = {"store_accepts": [], "accum_acks": []}
    orig = {n: getattr(tsk, f"{n}_cuda") for n in seen}

    def wrap(name):
        lane_ndim = 3 if name == "store_accepts" else 4  # [L, A, I] / [L, P, A, I]

        def launch(*ops):
            seen[name].append(int(ops[0].shape[0]) if ops[0].ndim == lane_ndim else 0)
            return orig[name](*ops)
        return launch
    for n in seen:
        setattr(tsk, f"{n}_cuda", wrap(n))
    return seen, orig


@pytest.mark.cuda
def test_evolve_quick_on_the_card_equals_jax(card, tmp_path):
    envelope.clear_cache()
    seen, orig = _lane_shapes()
    try:
        s = evo.evolve(axis="fleet", n_lanes=8, generations=2, base_seed=2,
                       decision_round_max=35, max_wedges=1, triage_dir=str(tmp_path),
                       verbose=False, device=card)
    finally:
        for n, fn in orig.items():
            setattr(tsk, f"{n}_cuda", fn)
    gold = _gold()["quick"]
    assert _script().evolve_less(s) == gold["summary"]
    assert _sha(s["artifact"]) == gold["artifact_sha256"]
    assert s["replay_match"] is True and s["compiles_per_generation"][0] >= 1
    for name, lanes in seen.items():
        assert 8 in lanes, name


@pytest.mark.cuda
def test_certified_recall_on_the_card_equals_jax(card, tmp_path):
    """The certified recall through ``python -m tpu_paxos_torch evolve``
    on the card, alone in its process (its wall is printed): found at 56
    lanes and shrunk at 74 within the certificate's 232-lane budget,
    replay matching, no warm build, a crash gene in the shrunk schedule;
    the summary less the wall fields, the artifact's bytes and the bench
    record (``BENCH_evolve.json`` but for the generation-0 build count)
    equal JAX's."""
    script = _script()
    gold = _gold()
    bench_out = str(tmp_path / "bench.json")
    env = dict(os.environ, TPU_PAXOS_SEEDED_WEDGE=gold["config"]["wedge"])
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()  # paxlint: allow[DET001] the recall's wall, printed only; never compared
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_paxos_torch", "evolve", *gold["config"]["certified"],
         "--bench-out", bench_out, "--triage-dir", str(tmp_path), "--quiet",
         "--device", card.type],
        cwd=ROOT, env=env, capture_output=True, text=True, check=False)
    wall = time.perf_counter() - t0  # paxlint: allow[DET001] the recall's wall, printed only; never compared
    assert proc.returncode == 0, proc.stderr[-3000:]
    s = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"certified recall on {torch.cuda.get_device_name(0)}: wall_s={wall:.1f} "
          f"seconds={s['seconds']} lanes_per_sec={s['lanes_per_sec']} "
          f"compiles_per_generation={s['compiles_per_generation']}")
    want = gold["certified"]
    assert s["certified"] is True and s["ok"] is True
    assert (s["lanes_to_first_find"], s["lanes_to_shrunk_artifact"], s["budget_lanes"]) == (
        56, 74, 232)
    assert s["replay_match"] is True and s["warm_compiles"] == 0
    assert script.evolve_less(s) == want["summary"]
    assert _sha(s["artifact"]) == want["artifact_sha256"]
    case, _ = shr.load_artifact(s["artifact"])
    assert "crash" in {e.kind for e in case.cfg.faults.schedule.episodes}
    with open(os.path.join(ROOT, "BENCH_evolve.json")) as f:
        bench = json.load(f)
    with open(bench_out) as f:
        rec = json.load(f)
    assert script.evolve_bench_less(rec) == script.evolve_bench_less(bench)
