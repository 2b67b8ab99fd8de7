"""The model checker on a card: the tiny fault scope, and the quick
scope's first chunk followed by the gray scope in one process (as ``mc
--scope quick,gray`` runs them), certify on CUDA with the verdict bits of
the committed certificates and JAX's goldens, with JAX's zero pattern of
runner builds per chunk and both ``simkern`` kernels launching on
16-lane operands.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mc_cuda.py
"""

import json
import os

import pytest
import torch

from tpu_paxos_torch.analysis import modelcheck as mc
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.fleet import envelope

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the simkern kernels have no CPU mode")
    return torch.device("cuda")


def _mc_gold():
    with open(GOLDENS) as f:
        return json.load(f)["mc"]


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
def test_tiny_fault_scope_on_the_card_equals_jax(card):
    envelope.clear_cache()
    tsk.reset_counts()
    s = mc.run_scope(mc.McScope.from_dict(_mc_gold()["config"]["tiny_fault"]),
                     verbose=False, device=card)
    gold = _mc_gold()["tiny_fault"]
    assert s["backend"] == "cuda"
    assert (s["verdict_bits"], s["verdict_bits_sha256"]) == (
        gold["verdict_bits"], gold["verdict_bits_sha256"])
    assert [c > 0 for c in s["compiles_per_chunk"]] == gold["compiles_per_chunk"]
    assert s["ok"] and not s["anomalies"]
    assert min(tsk.LAUNCHES.values()) >= 1


@pytest.mark.cuda
def test_gray_scope_rides_the_quick_envelope_on_the_card(card):
    """The quick scope's first chunk builds the shared envelope; the gray
    scope then builds nothing, and its bits equal the certificate,
    compared on CUDA (the port's certificate check has no backend gate)."""
    envelope.clear_cache()
    scopes = mc.load_scopes()
    certs = mc.load_certificates()
    gold = _mc_gold()["quick_scopes"]["summaries"]
    seen, orig = _lane_shapes()
    try:
        quick = mc.run_scope(scopes["quick"], verbose=False, chunk_limit=1, device=card)
        gray = mc.run_scope(scopes["gray"], verbose=False, device=card)
    finally:
        for n, fn in orig.items():
            setattr(tsk, f"{n}_cuda", fn)
    assert [c > 0 for c in quick["compiles_per_chunk"]] == gold["quick"]["compiles_per_chunk"][:1]
    assert [c > 0 for c in gray["compiles_per_chunk"]] == gold["gray"]["compiles_per_chunk"]
    assert gray["verdict_bits_sha256"] == certs["gray"]["verdict_bits_sha256"]
    assert mc.check_certificate(certs["gray"], gray, mc.enum_for(scopes["gray"])) == []
    pre = certs["quick"]["verdict_bits"][:len(quick["verdict_bits"])]
    assert mc.check_certificate(dict(certs["quick"], verdict_bits=pre), quick,
                                mc.enum_for(scopes["quick"])) == []
    assert gray["ok"] and quick["ok"]
    for name, lanes in seen.items():
        assert lanes and set(lanes) == {16}, name


@pytest.mark.cuda
def test_full_scope_prefix_on_the_card(card):
    """``chip_smoke.py``'s former 17c (cut for phase 20's room): the full
    scope's first two chunks on the card, their verdict bits the prefix of
    its certificate's."""
    import importlib.util

    import chip_smoke

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    chip_smoke.DEV = str(card)
    out = chip_smoke.run_mc_full_prefix(script, script.mc_modules(port=True), _mc_gold(),
                                        chip_smoke._card_line())
    assert out["wall_s"] > 0
