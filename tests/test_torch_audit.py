"""The port's audit (``tpu_paxos_torch/analysis/audit.py``): the entry
registry, the unregistered-surface sweep, the per-round budget and the
CLI — the surviving contracts of ``tests/test_jaxpr_audit.py`` on the
port, whose IR tiers have no counterpart.

- **Enforcement**: one ``python -m tpu_paxos_torch audit --device cpu
  --json`` run of the committed tree, shared by the module, must exit 0
  against ``analysis/launch_budget.json``.
- **Registry**: the 14 providers register real entries under exactly the
  28 names of JAX's ``op_budget.json``.
- **Seeded breaches**: one extra kernel call fails naming the entry and
  the delta; an unregistered launching function fails the sweep by name.
"""

import json
import os
import subprocess
import sys

import pytest

from tpu_paxos_torch.analysis import audit
from tpu_paxos_torch.analysis import registry as regm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_OP_BUDGET = os.path.join(REPO, "tpu_paxos", "analysis", "op_budget.json")


def _env():
    from _subproc import scrubbed_env

    return scrubbed_env()


def _audit_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "tpu_paxos_torch", "audit", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=_env(),
    )


@pytest.fixture(scope="module")
def repo_run():
    """One full CLI audit of the shipped tree on the CPU, shared by the
    module: ``(exit code, JSON report)``."""
    p = _audit_cli("--device", "cpu", "--json")
    assert p.stdout, p.stderr[-3000:]
    return p.returncode, json.loads(p.stdout)


# ---------------- registry + repo audit ----------------

def test_repo_audit_within_budget(repo_run):
    rc, report = repo_run
    assert rc == 0 and report["ok"], json.dumps(
        {k: report[k] for k in ("sweep", "budget")}, indent=1, sort_keys=True)
    assert report["device"] == "cpu"


def test_every_provider_registers_entries(repo_run):
    _rc, report = repo_run
    by_module = {}
    for name in regm.AUDIT_PROVIDERS:
        by_module[name] = len(regm.provider_module(name).audit_entries())
    assert len(by_module) == 14
    assert all(n >= 1 for n in by_module.values()), by_module
    assert len(regm.collect()) == len(report["entries"]) == 28


def test_registry_names_are_the_jax_op_budget_entries():
    with open(JAX_OP_BUDGET) as f:
        want = sorted(json.load(f)["entries"])
    assert sorted(e.name for e in regm.collect()) == want


def test_providers_are_jax_providers_counterparts():
    from tpu_paxos.analysis import registry as jreg

    assert regm.AUDIT_PROVIDERS == tuple(
        "tpu_paxos_torch" + m[len("tpu_paxos"):] for m in jreg.AUDIT_PROVIDERS)


def test_report_counts_a_round(repo_run):
    """The measured contracts: the sim round reads its predicates ~11
    times a round, launches a store kernel in a few rounds only (a round
    with no eligible accept skips it), and makes no collective; the
    sharded engine makes collectives; the windows entry counts one call a
    window."""
    _rc, report = repo_run
    e = report["entries"]
    sim = e["sim.run_rounds"]
    assert sim["rounds"] > 0 and 0 < sim["store_accepts"] < sim["rounds"]
    assert 5 < sim["per_round"]["host_reads"] < 20
    assert sim["collectives"] == 0
    assert e["sharded_sim.run_rounds"]["collectives"] > 0
    assert e["sharded.choose_all"]["collectives"] == 2
    assert e["fastwin.steady_windows"]["steady_state_windows"] == 2
    assert e["simkern.store_accepts"]["store_accepts"] == 1
    assert e["simkern.accum_acks"]["accum_acks"] == 1
    assert all(m["per_round"]["collectives"] == 0 for n, m in e.items()
               if not n.startswith("sharded"))


def test_measure_is_deterministic():
    entry = next(e for e in regm.collect(("tpu_paxos_torch.core.sim",))
                 if e.name == "sim.run_rounds_gates")
    a, b = audit.measure(entry, "cpu"), audit.measure(entry, "cpu")
    assert {k: a[k] for k in audit.EXACT} == {k: b[k] for k in audit.EXACT}


def test_registry_rejects_duplicate_names(tmp_path):
    prov = tmp_path / "dup_provider.py"
    prov.write_text(
        "from tpu_paxos_torch.analysis.registry import AuditEntry\n"
        "def audit_entries():\n"
        "    b = lambda device: (lambda x: x, (1,))\n"
        "    return [AuditEntry('d.same', b), AuditEntry('d.same', b)]\n"
    )
    names = audit._load_provider_arg(str(prov))
    with pytest.raises(regm.RegistryError, match="duplicate"):
        regm.collect(names)


def test_registry_rejects_missing_provider_fn(tmp_path):
    prov = tmp_path / "empty_provider.py"
    prov.write_text("x = 1\n")
    names = audit._load_provider_arg(str(prov))
    with pytest.raises(regm.RegistryError, match="audit_entries"):
        regm.collect(names)


# ---------------- unregistered-surface sweep ----------------

def _sweep_of(tmp_path, source: str, entries_src: str, name="sweep_provider") -> list[dict]:
    prov = tmp_path / f"{name}.py"
    prov.write_text(
        "from tpu_paxos_torch.analysis.registry import AuditEntry\n"
        + source + "\n" + entries_src
    )
    names = audit._load_provider_arg(str(prov))
    return audit.run_sweep(names, root=str(tmp_path))


def test_sweep_flags_unregistered_launching_function(tmp_path):
    problems = _sweep_of(
        tmp_path,
        "from tpu_paxos_torch.core import simkern as sk\n"
        "def rogue(*ops):\n"
        "    return sk.store_accepts_cuda(*ops)\n",
        "def audit_entries():\n    return []\n",
    )
    assert [p["kind"] for p in problems] == ["unregistered_surface"]
    assert problems[0]["surface"] == "rogue"
    assert "rogue" in problems[0]["detail"] and "AUDIT_EXEMPT" in problems[0]["detail"]


def test_sweep_accepts_covered_and_exempt(tmp_path):
    problems = _sweep_of(
        tmp_path,
        "def covered(mesh, f):\n"
        "    def inner(g):\n"
        "        return mesh.run(g)\n"
        "    return inner(f)\n"
        "def debug_only(x):\n"
        "    return x.thing_cuda()\n"
        "AUDIT_EXEMPT = {'debug_only': 'debug helper, never in the round path'}\n",
        "def audit_entries():\n"
        "    return [AuditEntry('s.c', lambda device: (lambda x: x, (1,)),"
        " covers=('covered',))]\n",
    )
    assert problems == []


def test_sweep_coverage_is_scoped_per_module(tmp_path):
    a = tmp_path / "prov_a.py"
    a.write_text(
        "from tpu_paxos_torch.analysis.registry import AuditEntry\n"
        "def shared_name(x):\n"
        "    return x.k_cuda()\n"
        "def audit_entries():\n"
        "    return [AuditEntry('a.e', lambda device: (lambda x: x, (1,)),"
        " covers=('shared_name',))]\n"
    )
    b = tmp_path / "prov_b.py"
    b.write_text(
        "def shared_name(x):\n"
        "    return x.k_cuda()\n"
        "def audit_entries():\n"
        "    return []\n"
    )
    names = audit._load_provider_arg(f"{a},{b}")
    problems = audit.run_sweep(names, root=str(tmp_path))
    assert [(p["kind"], p["surface"]) for p in problems] == [
        ("unregistered_surface", "shared_name")]
    assert problems[0]["module"].endswith("prov_b")


def test_sweep_catches_module_level_build_and_mesh_entries(tmp_path):
    problems = _sweep_of(
        tmp_path,
        "from tpu_paxos_torch.parallel import mesh as pmesh\n"
        "class kbuild:\n"
        "    load = staticmethod(lambda *a: None)\n"
        "LIB = kbuild.load('x', {})\n"
        "class Runner:\n"
        "    def go(self, f, dev, tree):\n"
        "        return pmesh.on_lanes(self.mesh, 'fleet', f, dev, tree)\n",
        "def audit_entries():\n    return []\n",
    )
    assert sorted(p["surface"] for p in problems) == ["<module>", "Runner.go"]


def test_sweep_double_booked_surface(tmp_path):
    problems = _sweep_of(
        tmp_path,
        "def both(x):\n    return x.k_cuda()\n"
        "AUDIT_EXEMPT = {'both': 'reason'}\n",
        "def audit_entries():\n"
        "    return [AuditEntry('s.b', lambda device: (lambda x: x, (1,)), covers=('both',))]\n",
    )
    assert [p["kind"] for p in problems] == ["double_booked_surface"]


def test_repo_sweep_is_clean_and_sees_the_launching_surfaces():
    assert audit.run_sweep(root=REPO) == []
    from tpu_paxos_torch.core import fastwin, simkern
    from tpu_paxos_torch.fleet import runner

    assert audit.sweep_module(simkern.__file__) == {"load", "store_accepts", "accum_acks"}
    assert audit.sweep_module(fastwin.__file__) == {"load", "steady_state_windows_fused"}
    assert audit.sweep_module(runner.__file__) == {"FleetRunner.run"}


def test_scoped_providers_do_not_report_stale_pins(tmp_path):
    report = audit.run_audit(providers=("tpu_paxos_torch.core.fast",), device="cpu",
                             triage_dir=str(tmp_path), root=REPO)
    assert report["budget"]["stale"] == []
    assert report["budget"]["violations"] == []
    assert report["ok"], report["budget"]


# ---------------- seeded breaches ----------------

def test_one_extra_kernel_call_fails_naming_entry_and_delta(tmp_path):
    """A store_accepts entry whose run makes one extra dispatcher call
    breaches the committed pin by +1, named, with the counts dumped."""
    prov = tmp_path / "extra_call.py"
    prov.write_text(
        "from tpu_paxos_torch.analysis.registry import AuditEntry\n"
        "from tpu_paxos_torch.core import simkern as sk\n"
        "def audit_entries():\n"
        "    real = next(e for e in sk.audit_entries() if e.name == 'simkern.store_accepts')\n"
        "    def build(device):\n"
        "        fn, args = real.build(device)\n"
        "        def twice(*a):\n"
        "            fn(*a)\n"
        "            return fn(*a)\n"
        "        return twice, args\n"
        "    return [AuditEntry('simkern.store_accepts', build)]\n"
    )
    names = audit._load_provider_arg(str(prov))
    report = audit.run_audit(providers=names, device="cpu", triage_dir=str(tmp_path),
                             root=str(tmp_path))
    assert not report["ok"]
    (v,) = report["budget"]["violations"]
    assert (v["entry"], v["key"], v["rule"], v["measured"], v["cap"]) == (
        "simkern.store_accepts", "store_accepts", "AU401", 2, 1)
    assert "simkern.store_accepts" in v["detail"] and "+1" in v["detail"]
    dumped = report["budget"]["dumped"]
    assert [os.path.basename(d) for d in dumped] == ["audit_simkern_store_accepts.json"]
    with open(dumped[0]) as f:
        assert json.load(f)["store_accepts"] == 2


def test_cli_unregistered_function_fails_the_audit(tmp_path):
    prov = tmp_path / "rogue_provider.py"
    prov.write_text(
        "from tpu_paxos_torch.analysis.registry import AuditEntry\n"
        "def launch(x):\n"
        "    return x.steady_cuda()\n"
        "def audit_entries():\n"
        "    return [AuditEntry('r.e', lambda device: (lambda: None, ()))]\n"
    )
    p = _audit_cli("--device", "cpu", "--no-budget", "--providers", str(prov))
    assert p.returncode == 1, p.stdout + p.stderr[-2000:]
    assert "launching surface `launch`" in p.stdout
    assert "1 sweep problems" in p.stdout


def test_cli_budget_breach_names_entry(tmp_path):
    with open(audit.DEFAULT_BUDGET) as f:
        tight = json.load(f)
    tight["entries"]["member.round"]["host_reads"] -= 1
    path = tmp_path / "tight.json"
    path.write_text(json.dumps(tight))
    p = _audit_cli("--device", "cpu", "--providers", "tpu_paxos_torch.membership.engine",
                   "--budget", str(path),
                   "--triage-dir", str(tmp_path))
    assert p.returncode == 1, p.stdout
    assert "budget AU402: entry member.round: 2 host_reads" in p.stdout
    assert "(+1)" in p.stdout
    assert os.path.exists(tmp_path / "audit_member_round.json")


# ---------------- budget machinery ----------------

def _m(**kw):
    base = {k: 0 for k in audit.EXACT}
    base.update(kw)
    return base


def test_check_budget_names_entry_and_delta():
    measured = {"sim.run_rounds": _m(rounds=20, store_accepts=3)}
    budget = {"entries": {"sim.run_rounds": _m(rounds=20, store_accepts=2)}}
    violations, stale = audit.check_budget(measured, budget, cuda=False)
    assert len(violations) == 1 and stale == []
    v = violations[0]
    assert (v["entry"], v["key"], v["measured"], v["cap"]) == ("sim.run_rounds",
                                                              "store_accepts", 3, 2)
    assert "+1" in v["detail"]


def test_check_budget_exact_both_directions():
    measured = {"e": _m(rounds=5, host_reads=9)}
    budget = {"entries": {"e": _m(rounds=5, host_reads=10)}}
    violations, _ = audit.check_budget(measured, budget, cuda=False)
    assert [(v["key"], v["rule"]) for v in violations] == [("host_reads", "AU402")]
    assert "-1" in violations[0]["detail"]


def test_check_budget_unpinned_entry_is_a_violation():
    violations, _ = audit.check_budget({"new.entry": _m()}, {"entries": {}}, cuda=False)
    assert [v["entry"] for v in violations] == ["new.entry"]
    assert "re-pin" in violations[0]["detail"]


def test_check_budget_stale_entry_is_flagged():
    _, stale = audit.check_budget({}, {"entries": {"gone.entry": _m()}}, cuda=False)
    assert stale == ["gone.entry"]


def test_check_budget_cuda_launches_and_syncs():
    m = _m(rounds=4, store_accepts=2)
    m["syncs"] = 30
    m["launches"] = {"store_accepts": 1, "accum_acks": 0, "steady_state_windows": 0}
    budget = {"entries": {"e": _m(rounds=4, store_accepts=2)},
              "cuda": {"entries": {"e": {"syncs": 20, "syncs_measured": 18}}}}
    violations, _ = audit.check_budget({"e": m}, budget, cuda=True)
    assert sorted((v["rule"], v["key"]) for v in violations) == [
        ("AU404", "syncs"), ("AU405", "store_accepts_launches")]
    (v,) = [v for v in violations if v["rule"] == "AU404"]
    assert "pinned 18 (+12, +3 a round)" in v["detail"]
    # the CPU never judges the cuda section
    assert audit.check_budget({"e": _m(rounds=4, store_accepts=2)}, budget, cuda=False) == ([], [])


def test_save_budget_sections_and_roundtrip(tmp_path):
    path = str(tmp_path / "budget.json")
    audit.save_budget({"e": _m(rounds=3, accum_acks=2)}, path, "cpu")
    m = _m(rounds=3, accum_acks=2)
    m["syncs"] = 100
    data = audit.save_budget({"e": m}, path, "cuda", card="H100, 700.00 W")
    assert data["entries"]["e"] == _m(rounds=3, accum_acks=2)
    assert data["cuda"]["entries"]["e"] == {"syncs": 101, "syncs_measured": 100}
    assert data["cuda"]["card"] == "H100, 700.00 W"
    assert audit.load_budget(path) == data


def test_one_extra_sync_a_round_breaches_every_cuda_cap():
    """The committed ``cuda`` caps are a round: every entry at its pinned
    counts passes, and the same run with one more host sync a round (a
    call's worth for an entry that runs no round) breaches AU404."""
    budget = audit.load_budget()
    for name, cap in sorted(budget["cuda"]["entries"].items()):
        pinned = budget["entries"][name]
        launches = {k: pinned[k] for k in audit.KERNELS}
        m = dict(pinned, syncs=cap["syncs_measured"], launches=launches)
        assert audit.check_budget({name: m}, budget, cuda=True)[0] == [], name
        m["syncs"] += max(pinned["rounds"], 1)
        violations, _ = audit.check_budget({name: m}, budget, cuda=True)
        assert [(v["entry"], v["rule"]) for v in violations] == [(name, "AU404")]


def test_mesh_run_adds_rank_launches_to_the_callers_count():
    """The audit reads launches through one ``simkern.counting`` block: a
    mesh run inside it adds its ranks' own counts when it ends, and
    ``simkern.LAUNCHES`` is left alone."""
    from tpu_paxos_torch.core import simkern
    from tpu_paxos_torch.parallel import mesh as pmesh

    before = dict(simkern.LAUNCHES)
    mesh = pmesh.make_instance_mesh(2, device="cpu")

    def fn(coll):
        for _ in range(coll.rank + 1):
            simkern._count("store_accepts")
        simkern._count("accum_acks")

    counts = {k: 0 for k in simkern.LAUNCHES}
    with simkern.counting(counts):
        simkern._count("accum_acks")
        mesh.run(fn)
    assert mesh.launches == [{"store_accepts": 1, "accum_acks": 1},
                             {"store_accepts": 2, "accum_acks": 1}]
    assert counts == {"store_accepts": 3, "accum_acks": 3}
    assert simkern.LAUNCHES == before
    mesh.run(fn)  # no block: the ranks' counts stay the mesh's own
    assert simkern.LAUNCHES == before and counts == {"store_accepts": 3, "accum_acks": 3}


def test_committed_budget_pins_every_entry():
    budget = audit.load_budget()
    assert sorted(budget["entries"]) == sorted(e.name for e in regm.collect())
    assert all(sorted(v) == sorted(audit.EXACT) for v in budget["entries"].values())


# ---------------- CLI ----------------

def test_cli_list_and_rules():
    p = _audit_cli("--list")
    assert p.returncode == 0
    assert len(p.stdout.splitlines()) == 28
    assert "sim.run_rounds " in p.stdout and "covers=FleetRunner.run" in p.stdout
    p = _audit_cli("--rules")
    assert p.returncode == 0
    for rid in ("AU401", "AU402", "AU403", "AU404", "AU405", "AU406", "SH301", "SH302",
                "SH303", "SH304"):
        assert rid in p.stdout


def test_cli_default_device_is_the_card():
    """No card here: the default ``--device cuda`` raises by name, never
    falls back to the CPU."""
    p = _audit_cli("--providers", "tpu_paxos_torch.core.fast")
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
