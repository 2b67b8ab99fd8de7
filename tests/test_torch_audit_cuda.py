"""The audit on a card: every registered entry runs on CUDA, its kernel
launches equal the kernel calls pinned from the CPU in
``analysis/launch_budget.json`` (kernel by kernel), its rounds, host
reads and collectives equal the CPU's, and its host syncs stay within
the budget's ``cuda`` section, a cap a round that one extra ``.item()``
a round breaches.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_audit_cuda.py
"""

import pytest
import torch

from tpu_paxos_torch.analysis import audit


#: A provider whose ``sim.run_rounds`` makes one more host read a round
#: (an ``.item()`` after each round), at no designed read site.
EXTRA_ITEM = """\
from tpu_paxos_torch.analysis.registry import AuditEntry
from tpu_paxos_torch.core import sim


def audit_entries():
    real = next(e for e in sim.audit_entries() if e.name == "sim.run_rounds")

    def build(device):
        fn, args = real.build(device)

        def leaky(*a):
            lane_round = sim._lane_round

            def one_more_read(*b, **k):
                out = lane_round(*b, **k)
                out.t.sum().item()
                return out

            sim._lane_round = one_more_read
            try:
                return fn(*a)
            finally:
                sim._lane_round = lane_round

        return leaky, args

    return [AuditEntry("sim.run_rounds", build)]
"""


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")


def _extra_item_audit(tmp_path, device):
    prov = tmp_path / "extra_item.py"
    prov.write_text(EXTRA_ITEM)
    return audit.run_audit(providers=audit._load_provider_arg(str(prov)), device=device,
                           triage_dir=str(tmp_path), root=str(tmp_path))


@pytest.fixture(scope="module")
def card_report():
    _need_card()
    return audit.run_audit(device="cuda")


@pytest.mark.cuda
def test_card_audit_within_budget(card_report):
    assert card_report["ok"], (card_report["sweep"], card_report["budget"])
    assert card_report["device"] == "cuda"


@pytest.mark.cuda
def test_launches_equal_the_cpu_pinned_calls(card_report):
    pinned = audit.load_budget()["entries"]
    for name, m in card_report["entries"].items():
        for k in audit.KERNELS:
            assert m["launches"][k] == pinned[name][k], (name, k)
        assert {k: m[k] for k in audit.EXACT} == pinned[name], name


@pytest.mark.cuda
def test_syncs_within_the_cuda_budget(card_report):
    caps = audit.load_budget()["cuda"]["entries"]
    for name, m in card_report["entries"].items():
        assert m["syncs"] <= caps[name]["syncs"], name


def test_extra_item_a_round_moves_no_cpu_count(tmp_path):
    """The seeded read below is no designed read site: the CPU's exact
    counts stay at their pins, so only the card's syncs can catch it."""
    report = _extra_item_audit(tmp_path, "cpu")
    assert report["ok"], report["budget"]
    assert report["entries"]["sim.run_rounds"]["rounds"] == 21


@pytest.mark.cuda
def test_extra_item_a_round_breaches_the_card_cap(tmp_path):
    """One ``.item()`` a round in ``sim.run_rounds`` breaches AU404 on the
    card, named, and nothing else: the run's syncs pass the pin by more
    than the slack and by no more than the seeded reads.  The pin (237 on
    an H100) holds one sync that only the entry's first run in a process
    makes; this run follows the module's audit, so it measures the warm
    236 plus the 21 seeded reads."""
    _need_card()
    report = _extra_item_audit(tmp_path, "cuda")
    assert not report["ok"]
    (v,) = report["budget"]["violations"]
    assert (v["entry"], v["key"], v["rule"]) == ("sim.run_rounds", "syncs", "AU404")
    pinned = audit.load_budget()["cuda"]["entries"]["sim.run_rounds"]["syncs_measured"]
    rounds = report["entries"]["sim.run_rounds"]["rounds"]
    over = v["measured"] - pinned
    assert audit.SYNC_SLACK * rounds < over <= rounds, (over, rounds)
    assert f"pinned {pinned} ({over:+d}, " in v["detail"]
