"""The runner-build census (``tpu_paxos_torch/analysis/buildcount.py``),
the port's counterpart of JAX's XLA compile census: a fixed set of
representative workloads (an mc quick chunk pair, two evolve
generations, a controlled spike A/B), each from a cold envelope, builds
exactly the runners ``analysis/build_budget.json`` pins, by step and by
builder label, and nothing after its first build."""

import pytest

from tpu_paxos_torch.analysis import buildcount as bc
from tpu_paxos_torch.fleet import envelope


@pytest.fixture(scope="module")
def census():
    """One CPU census of every workload, shared by the module."""
    return bc.census("cpu")


def test_census_matches_the_committed_budget(census):
    assert bc.check(census, bc.load_budget()) == []


@pytest.mark.parametrize("name", sorted(bc.WORKLOADS))
def test_zero_builds_after_the_first(census, name):
    steps = census[name]["per_step"]
    assert steps[0] >= 1, (name, steps)
    assert steps[1:] == [0] * (len(steps) - 1), (name, steps)


def test_builds_are_named_by_builder(census):
    assert census["mc_quick_chunk_pair"]["by_label"] == {"runner_for": 1}
    assert census["evolve_two_generations"]["by_label"] == {"runner_for": 1}
    assert census["control_spike_ab"]["by_label"] == {"control_window_for": 1}
    assert len(census["evolve_two_generations"]["per_step"]) == 2
    assert len(census["mc_quick_chunk_pair"]["per_step"]) == 2


def test_committed_budget_pins_every_workload():
    assert sorted(bc.load_budget()["workloads"]) == sorted(bc.WORKLOADS)


def test_check_names_warm_builds_and_drift():
    pinned = {"workloads": {"w": {"per_step": [1, 0], "by_label": {"runner_for": 1}}}}
    assert bc.check({"w": {"per_step": [1, 0], "by_label": {"runner_for": 1}}}, pinned) == []
    problems = bc.check({"w": {"per_step": [1, 1], "by_label": {"runner_for": 2}}}, pinned)
    assert any("step 1 built 1 runner(s) on a warm envelope" in p for p in problems)
    assert any("2 runner_for builds != pinned 1 (+1)" in p for p in problems)
    assert bc.check({"x": {"per_step": [1], "by_label": {}}}, pinned) == [
        "x: no pinned build budget (analysis/build_budget.json)"]


def test_memo_counts_by_label():
    before = envelope.cache_misses_by_label()
    total = envelope.cache_misses()
    cache = {}
    envelope.memo(("k",), object, cache=cache, label="probe")
    envelope.memo(("k",), object, cache=cache, label="probe")
    after = envelope.cache_misses_by_label()
    assert after.get("probe", 0) - before.get("probe", 0) == 1
    assert envelope.cache_misses() - total == 1
