"""The shard tier on the port (``analysis/shard_audit.run_shard_audit``,
``analysis/shard_rules.py``, ``parallel/partition_rules.coverage``): the
surviving contracts of ``tests/test_shard_audit.py`` — rule matching,
coverage by leaf path, the per-mesh budget's exact collective census and
per-rank bytes ceilings — and the committed tree held against
``analysis/shard_budget.json`` over the grid D = 1, 2, 4, 8 and (2, 4),
with a seeded unruled leaf and a seeded undeclared collective failing by
name."""

import json

import numpy as np
import pytest
import torch

from tpu_paxos_torch.analysis import shard_audit, shard_rules as shr
from tpu_paxos_torch.parallel import partition_rules as prules


@pytest.fixture(scope="module")
def repo_report():
    """One full shard-tier run of the committed tree on the CPU, shared by
    the module."""
    return shard_audit.run_shard_audit(device="cpu", budget_path=shr.DEFAULT_BUDGET)


# ---------------- the committed tree ----------------

def test_repo_shard_tier_within_budget(repo_report):
    assert repo_report["ok"], json.dumps(
        {k: repo_report[k] for k in ("coverage", "budget")}, indent=1, sort_keys=True)
    assert repo_report["grid"] == ["1", "2", "4", "8", "2x4"]
    cov = repo_report["coverage"]
    assert cov["unmatched"] == cov["rank"] == cov["stale_rules"] == []
    assert cov["rules"] == len(prules.RULES)


def test_rank_bytes_fall_with_the_mesh(repo_report):
    """The replication curve: a rank's state bytes halve as the lane tile
    doubles (no lane-stacked leaf replicates), and fall for the sharded
    engines too, less than halving (their [P]/[A] scalars replicate)."""
    m = repo_report["measured"]
    for name in ("fleet.run_lanes", "fleet.run_lanes_envelope", "member.fleet_lanes",
                 "serve.fleet_window"):
        b = [m[name][d]["bytes_per_rank"] for d in ("1", "2", "4", "8")]
        assert b == [b[0], b[0] // 2, b[0] // 4, b[0] // 8], (name, b)
        assert m[name]["2x4"]["bytes_per_rank"] == b[3]
    for name in ("sharded.choose_all", "sharded_sim.run_rounds"):
        b = [m[name][d]["bytes_per_rank"] for d in ("1", "2", "4", "8")]
        assert b == sorted(b, reverse=True) and b[3] > b[0] // 8, (name, b)


def test_collective_census_per_mesh(repo_report):
    """Lane tiles make no collective at any mesh; the sharded engines'
    collectives scale with the ranks; the (2, 4) mesh makes what an
    8-rank mesh makes."""
    m = repo_report["measured"]
    for name in ("fleet.run_lanes", "member.fleet_lanes", "serve.fleet_window"):
        assert all(cell["collectives"] == 0 for cell in m[name].values()), name
    sharded = m["sharded.choose_all"]
    assert [sharded[d]["collectives"] for d in ("1", "2", "4", "8")] == [2, 4, 8, 16]
    for name in ("sharded.choose_all", "sharded_sim.run_rounds"):
        assert m[name]["2x4"] == m[name]["8"], name


def test_committed_budget_and_certificate_parse():
    budget = shr.load_budget()
    assert budget["version"] == 1
    assert sorted(budget["entries"]) == [
        "fleet.run_lanes", "fleet.run_lanes_envelope", "member.fleet_lanes",
        "serve.fleet_window", "sharded.choose_all", "sharded_sim.run_rounds"]
    for per_mesh in budget["entries"].values():
        assert sorted(per_mesh) == ["1", "2", "2x4", "4", "8"]
    cert = shard_audit.load_certificate()
    assert sorted(cert["entries"]) == sorted(shard_audit.drivers())


# ---------------- seeded breaches ----------------

def test_unruled_leaf_fails_named_by_path():
    import collections

    tree = collections.namedtuple("Wedge", "unruled")(np.zeros((2, 2)))
    rep = shard_audit.run_shard_audit(
        providers=("tpu_paxos_torch.parallel.sharded",), device="cpu", budget_path=None,
        shapes=((1, 1),), extra_states={"wedge": ("wedge", tree)})
    assert not rep["ok"]
    assert rep["coverage"]["unmatched"] == [
        {"entry": "wedge", "path": "wedge/unruled", "shape": [2, 2]}]


def test_undeclared_collective_fails_naming_entry_mesh(tmp_path):
    budget = shr.load_budget()
    budget["entries"]["sharded.choose_all"]["2"]["collectives"] -= 1
    path = tmp_path / "budget.json"
    path.write_text(json.dumps(budget))
    rep = shard_audit.run_shard_audit(
        providers=("tpu_paxos_torch.parallel.sharded",), device="cpu",
        budget_path=str(path), shapes=((1, 1), (2, 1)), triage_dir=str(tmp_path))
    assert not rep["ok"]
    (v,) = rep["budget"]["violations"]
    assert (v["entry"], v["mesh"], v["key"], v["rule"], v["measured"], v["cap"]) == (
        "sharded.choose_all", "2", "collectives", "SH303", 4, 3)
    assert "+1" in v["detail"]
    assert rep["dumped"] and rep["dumped"][0].endswith("shard_sharded_choose_all.json")


# ---------------- rule matching and coverage ----------------

def test_match_path_first_rule_wins():
    idx, dims = prules.match_path("sim/acc/promised")
    assert dims == prules.REP and prules.RULES[idx][0] == r"^sim/acc/(promised|max_seen)$"
    idx, dims = prules.match_path("sim/prop/pend")
    assert dims == (prules.LANE, None, None)
    # the catch-all for the proposer control plane comes after the rows
    # that split proposer leaves
    idx2, dims2 = prules.match_path("sim/prop/ballot")
    assert dims2 == prules.REP and idx2 > idx


def test_match_path_unmatched_is_none():
    assert prules.match_path("nosuch/leaf") is None


def test_is_trivial_scalars_and_singletons():
    assert prules.is_trivial(np.int32(3))
    assert prules.is_trivial(np.zeros((1, 1)))
    assert not prules.is_trivial(np.zeros((2,)))


def test_rank_problem_exact_pin():
    assert prules.rank_problem((None, prules.LANE), 2) is None
    assert "rank 2" in prules.rank_problem((None, prules.LANE), 3)


def test_rank_problem_open_rank():
    assert prules.rank_problem((prules.LANE, ...), 5) is None
    assert "rank >= 1" in prules.rank_problem((prules.LANE, ...), 0)


def test_dims_of_names_unruled_leaf_by_path():
    with pytest.raises(prules.PartitionRuleError, match="wedge/x"):
        prules.dims_of("wedge/x", np.zeros((4, 4)))


def test_dims_of_names_rank_drift():
    with pytest.raises(prules.PartitionRuleError, match="sim/learned"):
        prules.dims_of("sim/learned", np.zeros((4, 4, 4)))


def test_coverage_reports_stale_rules_and_unmatched():
    from tpu_paxos_torch.core import fast

    cov = prules.coverage({
        "f": ("fast", fast.init_state(8, 3, device="cpu")),
        "w": ("wedge", (np.zeros((3, 3)), np.zeros(()))),
    })
    assert cov["unmatched"] == [{"entry": "w", "path": "wedge/0", "shape": [3, 3]}]
    stale = {s["rule"] for s in cov["stale_rules"]}
    assert r"^fast/(promised|max_seen)$" not in stale
    assert r"^serve/" in stale


def test_rank_bytes_split_and_replicate():
    from tpu_paxos_torch.core import fast

    st = fast.init_state(16, 3, device="cpu")
    # [A, I] int32 x3 split, [A] int32 x2 replicated
    assert prules.rank_bytes("fast", st, 2) == [3 * 3 * 8 * 4 + 2 * 3 * 4] * 2
    assert prules.leaf_bytes(torch.zeros((4,), dtype=torch.int8)) == 4


# ---------------- budget machinery ----------------

def _cell(b=1000, r=10, c=0):
    return {"bytes_per_rank": b, "rounds": r, "collectives": c}


def test_check_budget_collectives_exact_both_directions():
    budget = {"entries": {"e": {"2": _cell(c=4)}}}
    for got, delta in ((5, "+1"), (3, "-1")):
        v, _ = shr.check_budget({"e": {"2": _cell(c=got)}}, budget, full=False)
        assert [(x["key"], x["rule"]) for x in v] == [("collectives", "SH303")]
        assert delta in v[0]["detail"]


def test_check_budget_bytes_ceiling_and_unpinned_cell():
    budget = {"entries": {"e": {"2": _cell(b=100)}}}
    v, _ = shr.check_budget({"e": {"2": _cell(b=101), "4": _cell()}}, budget, full=False)
    assert sorted((x["mesh"], x["key"]) for x in v) == [("2", "bytes_per_rank"),
                                                        ("4", "budget")]


def test_check_budget_stale_only_on_full_grid():
    budget = {"entries": {"e": {"2": _cell(), "8": _cell()}}}
    measured = {"e": {"2": _cell()}}
    assert shr.check_budget(measured, budget, full=False)[1] == []
    assert shr.check_budget(measured, budget, full=True)[1] == ["e@mesh8"]


def test_save_budget_headroom_and_roundtrip(tmp_path):
    path = str(tmp_path / "b.json")
    data = shr.save_budget({"e": {"1": _cell(b=1000, r=3, c=2)}}, path)
    assert data["entries"]["e"]["1"] == {
        "bytes_per_rank": int(1000 * 1.3) + 4096, "rounds": 3, "collectives": 2}
    assert shr.load_budget(path) == data


def test_first_divergence_orders_verdict_before_log():
    ref = {"verdicts": "ff", "lane_logs": ["a", "b"]}
    assert shard_audit.first_divergence(ref, ref) is None
    got = {"verdicts": "fe", "lane_logs": ["x", "b"]}
    lane, detail = shard_audit.first_divergence(ref, got)
    assert lane == 0 and "decision-log" in detail
    got = {"verdicts": "fe", "lane_logs": ["a", "b"]}
    assert shard_audit.first_divergence(ref, got)[0] == 1


def test_check_certificate_unpinned_entry(tmp_path):
    path = tmp_path / "cert.json"
    path.write_text(json.dumps({"entries": {}}))
    fails = shard_audit.check_certificate(((1, 1),), device="cpu",
                                          entries=["fleet.run_lanes"], path=str(path))
    assert [f["entry"] for f in fails] == ["fleet.run_lanes"]
    assert "no pinned parity certificate" in fails[0]["detail"]


def test_cli_shard_only_rules():
    from tpu_paxos_torch.analysis import audit

    assert set(shr.RULES) == {"SH301", "SH302", "SH303", "SH304"}
    assert not set(shr.RULES) & set(audit.RULES)
