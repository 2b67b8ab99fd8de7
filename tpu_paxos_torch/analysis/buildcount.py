"""The runner-build census: the port's counterpart of
``tpu_paxos/analysis/tracecount.py``'s XLA compile census.

JAX's census counted XLA compiles per engine and failed a tier-1 run
whose warm dispatches recompiled.  The port compiles nothing at run
time; what a warm dispatch must not repeat is a runner BUILD (the round
functions, the padded tables and the caches a runner holds), which the
envelope builders count (``fleet/envelope.cache_misses_by_label``:
``runner_for``, ``serve_fleet_for``, ``serve_control_for``,
``member_runner_for``, ``control_window_for``).

:func:`census` runs a fixed set of representative workloads from a cold
envelope and records each one's builds per step and by label:

- ``mc_quick_chunk_pair``: the committed ``quick`` scope's first two
  chunks (``analysis/modelcheck.run_scope``, ``chunk_limit=2``);
- ``evolve_two_generations``: two generations of the fleet axis
  (``fleet/evolve.evolve``, evolve-quick's 8 lanes and seed, no
  synthetic wedge bound);
- ``control_spike_ab``: the controlled spike A/B
  (``serve/control.spike_ab``, bench.py's cell at 1000 values): its
  off, on and replay runs share one controlled window, so the A/B
  builds once.

:func:`check` holds a census against ``analysis/build_budget.json``:
every count pinned exactly, and every step after a workload's first
pinned at zero builds, as JAX requires zero compiles after the first.
The census is checked by its own test file
(``tests/test_torch_buildcount.py``), not a test-session hook.
"""

from __future__ import annotations

import json
import os

DEFAULT_BUDGET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build_budget.json")


def _cold() -> None:
    """Drop every runner cache, so the next build counts."""
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.serve import control as sctl
    from tpu_paxos_torch.serve import driver as drv

    env.clear_cache()
    sctl.clear_cache()
    drv.clear_cache()


def _by_label_since(before: dict) -> dict:
    from tpu_paxos_torch.fleet import envelope as env

    now = env.cache_misses_by_label()
    return {k: v - before.get(k, 0) for k, v in sorted(now.items()) if v - before.get(k, 0)}


def _mc_quick_chunk_pair(device) -> dict:
    from tpu_paxos_torch.analysis import modelcheck as mcm

    s = mcm.run_scope(mcm.load_scopes()["quick"], chunk_limit=2, verbose=False, device=device)
    return {"per_step": list(s["compiles_per_chunk"])}


def _evolve_two_generations(device) -> dict:
    from tpu_paxos_torch.fleet import evolve as evo

    s = evo.evolve(axis="fleet", n_lanes=8, generations=2, base_seed=2, max_wedges=1,
                   verbose=False, device=device)
    return {"per_step": list(s["compiles_per_generation"])}


def _control_spike_ab(device) -> dict:
    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.fleet import envelope as env
    from tpu_paxos_torch.serve import control as sctl
    from tpu_paxos_torch.serve import harness as sh

    cfg = cfgm.SimConfig(n_nodes=3, n_instances=2048, proposers=(0, 1), seed=3,
                         max_rounds=8000, assign_window=8)
    before = env.cache_misses()
    sctl.spike_ab(
        cfg, 1000, 2000, slo=sh.ServeSLO(latency_rounds=16, budget_milli=150), seed=0,
        rounds_per_window=4, windows_per_dispatch=2, spike_factor=4,
        spike_start_frac=0.25, spike_len_frac=0.5, window_rounds=32, device=device,
    )
    return {"per_step": [env.cache_misses() - before]}


#: The census's workloads, by name, in run order.
WORKLOADS = {
    "mc_quick_chunk_pair": _mc_quick_chunk_pair,
    "evolve_two_generations": _evolve_two_generations,
    "control_spike_ab": _control_spike_ab,
}


def census(device="cuda", workloads=None) -> dict:
    """Run each workload from a cold envelope: ``{name: {"per_step":
    [builds], "by_label": {label: builds}}}``."""
    from tpu_paxos_torch.fleet import envelope as env

    out = {}
    for name in workloads or WORKLOADS:
        _cold()
        before = env.cache_misses_by_label()
        rec = WORKLOADS[name](device)
        rec["by_label"] = _by_label_since(before)
        out[name] = rec
    return out


def load_budget(path: str = DEFAULT_BUDGET) -> dict:
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def save_budget(measured: dict, path: str = DEFAULT_BUDGET) -> dict:
    data = {
        "version": 1,
        "_workflow": "runner builds per step and by builder label of each "
                     "representative workload, from a cold envelope; every step "
                     "after the first must build nothing.  Re-pin: "
                     "python -c 'from tpu_paxos_torch.analysis import buildcount as b; "
                     "b.save_budget(b.census(\"cpu\"))'",
        "workloads": {k: measured[k] for k in sorted(measured)},
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return data


def check(measured: dict, budget: dict) -> list[str]:
    """Problems with a census (empty: it holds): a warm step that built,
    an unpinned workload, or a count that moved from its pin (named with
    the workload, the label or step, and the delta)."""
    pinned = budget.get("workloads", {})
    problems = []
    for name in sorted(measured):
        m = measured[name]
        for i, n in enumerate(m["per_step"][1:], start=1):
            if n:
                problems.append(f"{name}: step {i} built {n} runner(s) on a warm envelope "
                                "(every step after the first must build nothing)")
        want = pinned.get(name)
        if want is None:
            problems.append(f"{name}: no pinned build budget (analysis/build_budget.json)")
            continue
        if list(m["per_step"]) != list(want["per_step"]):
            problems.append(f"{name}: builds per step {m['per_step']} != pinned "
                            f"{want['per_step']}")
        for label in sorted(set(m["by_label"]) | set(want["by_label"])):
            got, exp = m["by_label"].get(label, 0), want["by_label"].get(label, 0)
            if got != exp:
                problems.append(f"{name}: {got} {label} builds != pinned {exp} "
                                f"({got - exp:+d})")
    return problems
