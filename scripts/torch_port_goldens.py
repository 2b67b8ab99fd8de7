"""Compute the JAX-reference goldens the PyTorch port is held to.

Runs the JAX package (``tpu_paxos``) on the CPU for the runs that
``chip_smoke.py`` repeats with the port on the card, and prints (or
writes) what each must reproduce:

- ``bench_sim``: the ``"engine": "sim"`` bench record's configuration
  (``bench.bench_sim_record``): 5 nodes, 2**23 instances, proposers
  (0, 1), assign_window 2**20, debug.conf faults (drop 500, dup 1000,
  delay 0-2), seed 0, default workload;
- ``bench_sim_partition_flap`` and ``bench_sim_wan3``: the same run
  under the correlated-fault mixes of ``tpu_paxos/harness/stress.py``
  (``partition-flap``: drop 300, dup 500, delay 0-2, three flapping
  bisections; ``wan-3region``: the WAN3 per-edge tables at ring bound
  8, a gray node and a one-way cut);
- ``cli_4_4_10``: ``python -m tpu_paxos 4 4 10 --seed=0
  --net-drop-rate=500 --net-dup-rate=1000 --net-max-delay=2``;
- ``fast_cli_2p23``: the stdout of ``python -m tpu_paxos 5 8192 1024
  --engine=fast --json`` (2**23 instances through the fast path);
- ``fleet``: the JAX ``FleetRunner`` at ``bench.py``'s fleet record
  configuration (``bench.bench_fleet_record``): 5 nodes, proposers (0,
  1), the gated stress workload ``stress._workload(2, default_rng(0))``
  on 56 instances, ``max_rounds`` 20000, ring bound 8, 128 lanes with
  schedules drawn lane after lane by ``search.sample_schedule(rng, 5, 4,
  96)`` from ``default_rng(1)``, under the headline knob cycle (seeds
  0-127) and the delay-spread cycle (seeds 50000-50127); per lane the
  six verdict fields and the decision-log sha256 (stride: the runner's
  vid bound);
- ``stress_quick``: the summary (less ``seconds``) of ``python -m
  tpu_paxos.harness.stress --seeds 1 --triage-dir DIR``: ``make
  stress-quick``'s host-loop sweep over the 10 mixes at one seed a mix
  (the Makefile runs two; one keeps the card's triage phase near 200 s);
- ``triage_wedge``: failure triage at the stress workload's size.  Under
  ``TPU_PAXOS_SEEDED_WEDGE=takeover`` the sweep ``stress.sweep(n_seeds=2,
  mixes=[pause-crash], triage_dir=DIR)`` finds no failing seed, so its
  summary is held and two cases are shrunk instead: ``culprit``, the
  three-episode ``decision_round_max`` case of
  ``tests/test_shrink.py::test_shrinker_isolates_culprit_episode``, and
  ``takeover``, a real seeded wedge (the model checker's quick-scope
  scenario 220: a partition of node 0 and a crash of node 1 at round 8,
  with the wedge armed).  Each holds its input case, the shrink's final
  config, violation, accepted moves and eval count, and the sha256 of
  the artifact file and of the ``repro --json`` stdout; the artifacts
  themselves are written beside the goldens file
  (``repro_culprit.json``, ``repro_takeover.json``);
- ``triage_full``: ``bench_sim_partition_flap`` (2**23 instances) with
  ``decision_round_max`` one round below its last decision, shrunk with
  ``shrink_case(max_evals=3, batch=False)``: the final config, the
  violation, the artifact's ``decision_log_sha256`` and ``rounds``, and
  the sha256 of the artifact file and of the ``repro --json`` stdout;
- ``telemetry``: the flight recorder.  ``runs``: ``sim.run_with_telemetry``
  (``window_rounds`` 16) on ``bench_sim``, ``bench_sim_partition_flap``
  and ``bench_sim_wan3`` (the last with the preset's region map and
  names), each ``summary_to_dict(summary, windows)``; ``fleet``: the
  128-lane ``FleetRunner(telemetry=True)`` at the fleet entry's
  configuration and headline cycle, with ``run(regions=)`` cycling the
  WAN3 map, the WAN5 map and None over the lanes, per lane the sha256
  of ``lane_telemetry(i)`` as sorted compact JSON (lanes 0 and 12, the
  one that never finishes, also in full) and the decision-log sha256;
  ``trace``: the sha256 of ``python -m tpu_paxos trace <basename>
  --stdout`` run in the artifact's directory, for the two committed
  artifacts (``repro_culprit.json``, ``repro_takeover.json``, the latter
  with the seeded wedge armed as its shrink had it) and for
  ``triage_full``'s 2**23 artifact (rewritten here and held to its
  golden file sha256 first).

The general-engine entries hold the round count, ``done``, the chosen
count and the decision-log sha256 (with the config, faults included, as
plain JSON the port rebuilds without the JAX package); the scheduled
ones also the sha256 of the ``chosen_round`` array (int32, little
endian), since a schedule moves decision rounds more than decisions.

Usage (from the repo root)::

    JAX_PLATFORMS=cpu python scripts/torch_port_goldens.py \
        [--write tpu_paxos_torch/data/goldens.json] [--instances N]

``--triage-only [ENTRY ...]`` recomputes only the triage entries (all
three, or those named) of an existing ``--write`` file; ``triage_wedge``
rewrites the two artifacts beside it.

``--telemetry-only`` recomputes only the ``telemetry`` entry of an
existing ``--write`` file (about 25 min on the CPU box).

Phase 13 of ``chip_smoke.py`` (the schedule search, the fleet stress
sweep and the geometry-padded envelope) holds three more entries:

- ``search``: ``fleet_quick``, the summary of ``python -m tpu_paxos fleet
  --lanes 8 --generations 1 --seed 2 --decision-round-max 35
  --max-wedges 1 --triage-dir DIR --quiet`` (``make fleet-quick``'s
  arguments), less ``seconds``, ``lanes_per_sec`` and each wedge's
  ``shrink_seconds``, artifact paths cut to their basename, with the
  sha256 of its wedge artifact (written beside the goldens file as
  ``repro_fleet_g0_lane0.json``) and of ``python -m tpu_paxos repro
  <basename> --json`` run in its directory; ``search_wide``, the summary
  of ``python -m tpu_paxos fleet --lanes 128 --generations 2 --seed 0
  --gray --wan --quiet`` less the same keys (128: the GPU's
  ``default_lane_count``);
- ``stress_fleet``: both summary lines of ``python -m
  tpu_paxos.harness.stress --fleet --seeds 8 --triage-dir DIR``, less
  ``seconds``, ``lanes_per_sec`` and ``compiles_per_mix`` (JAX's XLA
  compile count; the port counts runner builds there);
- ``envelope``: ``bench.py``'s geometry-padded envelope configuration
  (``bench.bench_envelope_record``): menu 3/(0,), 5/(0,1), 7/(0,1,2),
  template rows 100-107, 200-207, 300-307 on 48 instances,
  ``max_rounds`` 4000, 64 lanes (seeds 10000-10063, no schedule) under
  both protocol configs and both rates, through ONE padded
  ``envelope.runner_for(..., geometry=)``; per cell and lane the rounds,
  ``ok`` and the decision-log sha256 (stride 308).

``--search-only``, ``--stress-fleet-only`` and ``--envelope-only``
recompute just those entries of an existing ``--write`` file (about 10,
6 and 4 min on the CPU box).

``--instances`` shrinks the bench run (for a quick self-check); the
committed file holds the full 2**23 run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COMMAND = "JAX_PLATFORMS=cpu python scripts/torch_port_goldens.py --write tpu_paxos_torch/data/goldens.json"


def bench_sim_config(n_instances: int = 1 << 23) -> dict:
    return {
        "n_nodes": 5,
        "n_instances": n_instances,
        "proposers": [0, 1],
        "seed": 0,
        "assign_window": max(256, min(1 << 20, n_instances // 8)),
        "max_rounds": 20_000,
        "faults": {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
    }


CLI_ARGS = [4, 4, 10]
CLI_FAULTS = {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2}


SCHEDULED = {
    "bench_sim_partition_flap": "partition-flap",
    "bench_sim_wan3": "wan-3region",
}
FAST_CLI_ARGS = ["5", "8192", "1024", "--engine=fast", "--json"]


def _faults_json(kw: dict) -> dict:
    """A stress mix's FaultConfig kwargs as plain JSON."""
    out = {}
    for k, v in sorted(kw.items()):
        out[k] = v.to_dict() if hasattr(v, "to_dict") else v
    return out


def _summary(res, log_text: str) -> dict:
    return {
        "rounds": int(res.rounds),
        "done": bool(res.done),
        "chosen": int((res.chosen_vid != -1).sum()),
        "decision_log_sha256": hashlib.sha256(log_text.encode()).hexdigest(),
    }


def chosen_round_sha256(chosen_round) -> str:
    import numpy as np

    return hashlib.sha256(np.asarray(chosen_round, "<i4").tobytes()).hexdigest()


def _bench_run(bc: dict, faults, rounds_sha: bool = False) -> dict:
    from tpu_paxos import config as cfgm
    from tpu_paxos.core import sim
    from tpu_paxos.replay.decision_log import decision_log

    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=faults,
    )
    res = sim.run(cfg)
    stride = max(cfg.n_instances, 1024)
    out = _summary(res, decision_log(res.chosen_vid, res.chosen_ballot, stride, cfg.n_instances))
    out.update(config=bc, stride=stride)
    if rounds_sha:
        out["chosen_round_sha256"] = chosen_round_sha256(res.chosen_round)
    return out


def _fast_cli_stdout(argv) -> str:
    import contextlib
    import io

    from tpu_paxos import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    if rc != 0:
        raise RuntimeError(f"python -m tpu_paxos {' '.join(argv)} exited {rc}")
    return buf.getvalue()


FLEET_LANES = 128
FLEET_CYCLES = {
    # cycle: (first seed, knob mixes as FaultConfig kwargs, cycled by lane)
    "headline": (0, [
        {},
        {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
        {"drop_rate": 2000, "dup_rate": 500, "max_delay": 2},
        {"drop_rate": 1000, "dup_rate": 2000, "max_delay": 2},
    ]),
    "delay": (50_000, [
        {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
        {"drop_rate": 2000, "dup_rate": 500, "max_delay": 4},
        {"drop_rate": 200, "dup_rate": 200, "min_delay": 1, "max_delay": 6},
        {"drop_rate": 300, "dup_rate": 500, "max_delay": 8},
    ]),
}


def fleet_config(workload) -> dict:
    return {
        "n_nodes": 5,
        "n_instances": 2 * sum(len(w) for w in workload),
        "proposers": [0, 1],
        "seed": 0,
        "max_rounds": 20_000,
        "faults": {"drop_rate": 300, "dup_rate": 500, "max_delay": 8},
        "workload": "stress._workload(2, numpy.random.default_rng(0))",
        "schedules": "search.sample_schedule(rng, 5, 4, 96) per lane, rng = default_rng(1)",
        "lanes": FLEET_LANES,
    }


def fleet_goldens(n_lanes: int = FLEET_LANES) -> dict:
    import numpy as np

    from tpu_paxos import config as cfgm
    from tpu_paxos.fleet import runner as frun
    from tpu_paxos.fleet import search
    from tpu_paxos.harness import stress
    from tpu_paxos.replay.decision_log import decision_log

    workload, gates, _ = stress._workload(2, np.random.default_rng(0))
    fc = fleet_config(workload)
    cfg = cfgm.SimConfig(
        n_nodes=fc["n_nodes"], n_instances=fc["n_instances"],
        proposers=tuple(fc["proposers"]), seed=fc["seed"],
        max_rounds=fc["max_rounds"], faults=cfgm.FaultConfig(**fc["faults"]),
    )
    rng = np.random.default_rng(1)
    schedules = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n_lanes)]
    runner = frun.FleetRunner(cfg, workload, gates)
    out = {"config": dict(fc, lanes=n_lanes), "stride": runner.vid_bound}
    for name, (first, mixes) in sorted(FLEET_CYCLES.items()):
        knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n_lanes)]
        rep = runner.run([first + i for i in range(n_lanes)], schedules, knobs=knobs)
        # one transfer per fleet dispatch, after its verdict
        chosen_vid = np.asarray(rep.final.met.chosen_vid)  # paxlint: allow[JAX103] once per dispatch
        chosen_ballot = np.asarray(rep.final.met.chosen_ballot)  # paxlint: allow[JAX103] once per dispatch
        v = rep.verdict
        out[name] = {
            "first_seed": first,
            "knob_mixes": mixes,
            **{f: np.asarray(getattr(v, f)).tolist() for f in v._fields},
            "decision_log_sha256": [
                hashlib.sha256(decision_log(
                    chosen_vid[i], chosen_ballot[i], runner.vid_bound, cfg.n_instances,
                ).encode()).hexdigest()
                for i in range(n_lanes)
            ],
        }
    return out


STRESS_QUICK_SEEDS = 1
TRIAGE_SWEEP = {"n_seeds": 2, "mix": "pause-crash", "wedge": "takeover"}
TRIAGE_FULL_KEY = "bench_sim_partition_flap"
TRIAGE_FULL_EVALS = 3


def _summary_less_seconds(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k != "seconds"}


def stress_quick_golden() -> dict:
    from tpu_paxos.harness import stress

    s = stress.sweep(n_seeds=STRESS_QUICK_SEEDS, verbose=False)
    return {
        "cli": f"python -m tpu_paxos.harness.stress --seeds {STRESS_QUICK_SEEDS} --triage-dir DIR",
        "summary": _summary_less_seconds(s),
    }


def triage_inputs() -> dict:
    """The two small triage cases, as artifact-shaped JSON (the port
    rebuilds them with its own ``shrink._cfg_from_dict``)."""
    import numpy as np

    from tpu_paxos import config as cfgm
    from tpu_paxos.core import faults as flt
    from tpu_paxos.harness import shrink as shr
    from tpu_paxos.harness import stress

    culprit = cfgm.SimConfig(
        n_nodes=5, n_instances=64, proposers=(0, 1), seed=7, max_rounds=4000,
        faults=cfgm.FaultConfig(
            drop_rate=300, dup_rate=500, max_delay=2,
            schedule=flt.FaultSchedule((
                flt.partition(5, 45, (0, 1), (2, 3, 4)),
                flt.pause(50, 60, 3),
                flt.burst(2, 8, 1500),
            )),
        ),
    )
    wl, gates, chains = stress._workload(2, np.random.default_rng(0), n_ids=4, n_free=4)
    takeover = cfgm.SimConfig(
        n_nodes=5, n_instances=2 * sum(len(w) for w in wl), proposers=(0, 1),
        seed=0, max_rounds=600,
        faults=cfgm.FaultConfig(schedule=flt.FaultSchedule((
            flt.partition(4, 18, (0,)),
            flt.crash(8, 1),
        ))),
    )
    return {
        "culprit": {
            "source": "tests/test_shrink.py::test_shrinker_isolates_culprit_episode",
            "env": {},
            "max_evals": 40,
            "cfg": shr._cfg_to_dict(culprit),
            "workload": [list(range(100, 110)), list(range(200, 210))],
            "gates": None,
            "chains": [[], []],
            "extra_checks": {"decision_round_max": 40},
        },
        "takeover": {
            "source": "analysis/mc_scope.json quick scope, scenario 220, "
                      "TPU_PAXOS_SEEDED_WEDGE=takeover",
            "env": {"TPU_PAXOS_SEEDED_WEDGE": "takeover"},
            "max_evals": 200,
            "cfg": shr._cfg_to_dict(takeover),
            "workload": [w.tolist() for w in wl],
            "gates": [g.tolist() for g in gates],
            "chains": [c.tolist() for c in chains],
            "extra_checks": {},
        },
    }


class _Moves:
    """A logger that keeps the shrinker's accepted moves."""

    def __init__(self):
        self.moves = []

    def info(self, fmt, *args):
        self.moves.append(fmt % args)


def _file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def repro_stdout(artifact: str, env_extra: dict) -> str:
    """Stdout of ``python -m tpu_paxos repro <basename> --json`` run in
    the artifact's directory (the summary names the path as given)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_paxos", "repro", os.path.basename(artifact), "--json"],
        cwd=os.path.dirname(os.path.abspath(artifact)), env=env,
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"JAX repro of {artifact} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def _shrink_golden(case, out_dir: str, name: str, env: dict, max_evals: int,
                   batch: bool = True) -> dict:
    from tpu_paxos.harness import shrink as shr

    logger, stats = _Moves(), {}
    small, viol = shr.shrink_case(case, max_evals=max_evals, logger=logger, batch=batch,
                                  stats=stats)
    path = os.path.join(out_dir, f"repro_{name}.json")
    art = shr.save_artifact(path, small, viol)
    out = repro_stdout(path, env)
    return {
        "final_cfg": shr._cfg_to_dict(small.cfg),
        "violation": viol,
        "moves": logger.moves,
        "evals": stats["evals"],
        "artifact": os.path.basename(path),
        "artifact_sha256": _file_sha256(path),
        "decision_log_sha256": art["decision_log_sha256"],
        "rounds": art["rounds"],
        "repro_stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
        "repro_match": json.loads(out.splitlines()[-1])["match"],
    }


def _with_env(env: dict):
    import contextlib

    from tpu_paxos.fleet import envelope as env_cache

    @contextlib.contextmanager
    def scope():
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        env_cache.clear_cache()
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            env_cache.clear_cache()
    return scope()


def triage_wedge_golden(out_dir: str) -> dict:
    """The sweep under the seeded wedge, then both small cases shrunk,
    saved into ``out_dir`` and replayed through the JAX CLI."""
    import tempfile

    import numpy as np

    from tpu_paxos.harness import shrink as shr
    from tpu_paxos.harness import stress

    mix = [m for m in stress.MIXES if m[0] == TRIAGE_SWEEP["mix"]]
    with _with_env({"TPU_PAXOS_SEEDED_WEDGE": TRIAGE_SWEEP["wedge"]}):
        with tempfile.TemporaryDirectory() as tmp:
            s = stress.sweep(n_seeds=TRIAGE_SWEEP["n_seeds"], mixes=mix, verbose=False,
                             triage_dir=tmp)
    cases = {}
    for name, spec in sorted(triage_inputs().items()):
        case = shr.ReproCase(
            cfg=shr._cfg_from_dict(spec["cfg"]),
            workload=[np.asarray(w, np.int32) for w in spec["workload"]],
            gates=None if spec["gates"] is None else [np.asarray(g, np.int32) for g in spec["gates"]],
            chains=[np.asarray(c, np.int32) for c in spec["chains"]],
            extra_checks=dict(spec["extra_checks"]),
        )
        with _with_env(spec["env"]):
            cases[name] = dict(spec, **_shrink_golden(case, out_dir, name, spec["env"],
                                                       spec["max_evals"]))
    return {
        "sweep": dict(TRIAGE_SWEEP, summary=_summary_less_seconds(s)),
        "case_taken": "the sweep finds no failing seed, so the shrunk cases are "
                      "'culprit' and 'takeover'",
        "cases": cases,
    }


def triage_full_golden(bench_sched: dict) -> dict:
    """``bench_sim_partition_flap`` with a decision-round bound one below
    its last decision, shrunk at full width with a 3-eval budget."""
    import tempfile

    import numpy as np

    from tpu_paxos import config as cfgm
    from tpu_paxos.core import faults as flt
    from tpu_paxos.core import sim
    from tpu_paxos.harness import shrink as shr

    bc = bench_sched["config"]
    f = dict(bc["faults"])
    f["schedule"] = flt.FaultSchedule.from_dict(f["schedule"])
    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**f),
    )
    wl = sim.default_workload(cfg)
    res = sim.run(cfg, wl)
    last = int(res.chosen_round[res.chosen_vid != -1].max())
    case = shr.ReproCase(cfg=cfg, workload=wl, gates=None,
                         chains=[np.zeros(0, np.int32)] * len(wl),
                         extra_checks={"decision_round_max": last - 1})
    # The candidates are judged by JAX's sim.run (shrink's run_case), not
    # its runtime-knob fleet runner: the JAX package pins the two equal
    # decision log for decision log, and the fleet runner's always-on
    # masked round takes too long at 2**23 on a CPU.
    saved = shr._runtime_candidate_eval
    shr._runtime_candidate_eval = lambda case: None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = _shrink_golden(case, tmp, "full", {}, TRIAGE_FULL_EVALS, batch=False)
    finally:
        shr._runtime_candidate_eval = saved
    return dict(out, source=TRIAGE_FULL_KEY, config=bc, last_decision_round=last,
                extra_checks=case.extra_checks, max_evals=TRIAGE_FULL_EVALS, batch=False,
                workload="sim.default_workload(cfg)", jax_evaluator="run_case (sim.run)")


def triage_goldens(out: dict, out_dir: str, parts=("stress_quick", "triage_wedge",
                                                     "triage_full")) -> dict:
    make = {
        "stress_quick": stress_quick_golden,
        "triage_wedge": lambda: triage_wedge_golden(out_dir),
        "triage_full": lambda: triage_full_golden(out[TRIAGE_FULL_KEY]),
    }
    return {k: make[k]() for k in parts}


TELEMETRY_WINDOW_ROUNDS = 16
TELEMETRY_FLEET_CYCLE = "headline"
#: lanes whose full lane_telemetry dict is kept beside every lane's sha
TELEMETRY_FLEET_FULL_LANES = (0, 12)


def lane_telemetry_sha256(d: dict) -> str:
    """The sha256 of a ``lane_telemetry`` dict as sorted compact JSON."""
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def telemetry_fleet_regions(n_lanes: int):
    """Per-lane region maps of the armed fleet golden: the WAN3 map, the
    WAN5 map and None in turn."""
    from tpu_paxos.core import wan as wanm

    maps = [wanm.node_regions(wanm.WAN3, 5).tolist(), wanm.node_regions(wanm.WAN5, 5).tolist(),
            None]
    return [maps[i % len(maps)] for i in range(n_lanes)]


def _telemetry_run(gold: dict) -> dict:
    from tpu_paxos import config as cfgm
    from tpu_paxos.core import faults as flt
    from tpu_paxos.core import sim
    from tpu_paxos.core import wan as wanm
    from tpu_paxos.harness import stress
    from tpu_paxos.replay.decision_log import decision_log
    from tpu_paxos.telemetry import recorder as telem

    bc = gold["config"]
    f = dict(bc["faults"])
    if "schedule" in f:
        f["schedule"] = flt.FaultSchedule.from_dict(f["schedule"])
    if "edges" in f:
        f["edges"] = cfgm.EdgeFaultConfig.from_dict(f["edges"])
    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**f),
    )
    mix = bc.get("mix")
    rmap = stress.WAN_REGIONS.get(mix)
    names = tuple(stress.WAN_NAMES.get(mix, ()))
    res, summ, wsum = sim.run_with_telemetry(
        cfg, sim.default_workload(cfg), None, window_rounds=TELEMETRY_WINDOW_ROUNDS,
        region_map=rmap,
    )
    return {
        "source": gold.get("mix", "bench_sim"),
        "region_map": None if rmap is None else [int(x) for x in rmap],
        "region_names": list(names),
        "decision_log_sha256": hashlib.sha256(decision_log(
            res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances,
        ).encode()).hexdigest(),
        "summary": telem.summary_to_dict(summ, wsum, TELEMETRY_WINDOW_ROUNDS, names),
    }


def _telemetry_fleet(n_lanes: int = FLEET_LANES) -> dict:
    import numpy as np

    from tpu_paxos import config as cfgm
    from tpu_paxos.fleet import runner as frun
    from tpu_paxos.fleet import search
    from tpu_paxos.harness import stress
    from tpu_paxos.replay.decision_log import decision_log

    workload, gates, _ = stress._workload(2, np.random.default_rng(0))
    fc = fleet_config(workload)
    cfg = cfgm.SimConfig(
        n_nodes=fc["n_nodes"], n_instances=fc["n_instances"],
        proposers=tuple(fc["proposers"]), seed=fc["seed"],
        max_rounds=fc["max_rounds"], faults=cfgm.FaultConfig(**fc["faults"]),
    )
    rng = np.random.default_rng(1)
    schedules = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n_lanes)]
    runner = frun.FleetRunner(cfg, workload, gates, telemetry=True)
    first, mixes = FLEET_CYCLES[TELEMETRY_FLEET_CYCLE]
    knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n_lanes)]
    regions = telemetry_fleet_regions(n_lanes)
    rep = runner.run([first + i for i in range(n_lanes)], schedules, knobs=knobs,
                     regions=regions)
    chosen_vid = np.asarray(rep.final.met.chosen_vid)  # paxlint: allow[JAX103] once per dispatch
    chosen_ballot = np.asarray(rep.final.met.chosen_ballot)  # paxlint: allow[JAX103] once per dispatch
    dicts = [rep.lane_telemetry(i) for i in range(n_lanes)]
    return {
        "cycle": TELEMETRY_FLEET_CYCLE,
        "regions": "telemetry_fleet_regions(lanes): WAN3 map, WAN5 map, None in turn",
        "lane_telemetry_sha256": [lane_telemetry_sha256(d) for d in dicts],
        "lane_telemetry": {str(i): dicts[i] for i in TELEMETRY_FLEET_FULL_LANES},
        "decision_log_sha256": [
            hashlib.sha256(decision_log(
                chosen_vid[i], chosen_ballot[i], runner.vid_bound, cfg.n_instances,
            ).encode()).hexdigest()
            for i in range(n_lanes)
        ],
    }


def trace_stdout(artifact: str, env_extra: dict) -> str:
    """Stdout of ``python -m tpu_paxos trace <basename> --stdout`` run in
    the artifact's directory (the trace names the path as given)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_paxos", "trace", os.path.basename(artifact), "--stdout"],
        cwd=os.path.dirname(os.path.abspath(artifact)), env=env,
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"JAX trace of {artifact} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def _trace_golden(path: str, env: dict) -> dict:
    before = _file_sha256(path)
    out = trace_stdout(path, env)
    if _file_sha256(path) != before:
        raise RuntimeError(f"tracing {path} changed the artifact")
    return {"env": env, "artifact_sha256": before,
            "stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
            "stdout_bytes": len(out.encode())}


def _full_artifact(gold: dict, path: str) -> None:
    """Rewrite ``triage_full``'s artifact with JAX and hold it to its
    golden file sha256."""
    import numpy as np

    from tpu_paxos.core import sim
    from tpu_paxos.harness import shrink as shr

    cfg = shr._cfg_from_dict(gold["final_cfg"])
    wl = sim.default_workload(cfg)
    case = shr.ReproCase(cfg=cfg, workload=wl, gates=None,
                         chains=[np.zeros(0, np.int32)] * len(wl),
                         extra_checks=dict(gold["extra_checks"]))
    shr.save_artifact(path, case, gold["violation"])
    if _file_sha256(path) != gold["artifact_sha256"]:
        raise RuntimeError("the rewritten 2**23 artifact differs from triage_full's golden")


def telemetry_goldens(out: dict, out_dir: str) -> dict:
    import tempfile

    runs = {key: _telemetry_run(out[key])
            for key in ("bench_sim", "bench_sim_partition_flap", "bench_sim_wan3")}
    fleet = _telemetry_fleet()
    trace = {}
    for name, spec in sorted(out["triage_wedge"]["cases"].items()):
        trace[spec["artifact"]] = _trace_golden(os.path.join(out_dir, spec["artifact"]),
                                                spec["env"])
    full = out["triage_full"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, full["artifact"])
        _full_artifact(full, path)
        trace[full["artifact"]] = _trace_golden(path, {})
    return {"window_rounds": TELEMETRY_WINDOW_ROUNDS, "runs": runs, "fleet": fleet,
            "trace": trace}


FLEET_QUICK_ARGS = ["--lanes", "8", "--generations", "1", "--seed", "2",
                    "--decision-round-max", "35", "--max-wedges", "1"]  # Makefile:133-135
FLEET_QUICK_ARTIFACT = "repro_fleet_g0_lane0.json"
SEARCH_WIDE_ARGS = ["--generations", "2", "--seed", "0", "--gray", "--wan"]
SEARCH_WIDE_LANES = 128  # the GPU's default_lane_count
STRESS_FLEET_SEEDS = 8
SEARCH_TIMING_KEYS = ("seconds", "lanes_per_sec")
STRESS_TIMING_KEYS = ("seconds", "lanes_per_sec", "compiles_per_mix")
ENVELOPE = {
    "menu": [[3, [0]], [5, [0, 1]], [7, [0, 1, 2]]],
    "template": [[100, 108], [200, 208], [300, 308]],  # arange(lo, hi) rows
    "n_instances": 48,
    "max_rounds": 4000,
    "lanes": 64,
    "first_seed": 10_000,
    "protocols": [
        {},
        {"prepare_delay_min": 1, "prepare_delay_max": 6, "prepare_retry_count": 2,
         "prepare_retry_timeout": 3, "accept_retry_count": 2, "accept_retry_timeout": 3,
         "commit_retry_timeout": 3},
    ],
    "rates": [{"max_delay": 2}, {"drop_rate": 500, "dup_rate": 500, "max_delay": 2}],
    "stride": 308,
}


def normalize_summary(summary: dict, timing_keys) -> dict:
    """A search or sweep summary less its wall-clock keys, with each
    wedge's or failure's ``shrink_seconds`` dropped and artifact paths cut
    to their basename (the triage directory differs run to run)."""
    out = {k: v for k, v in summary.items() if k not in timing_keys}
    for key in ("wedges", "failures"):
        if key in out:
            out[key] = [
                {k: (os.path.basename(v) if k == "artifact" else v)
                 for k, v in item.items() if k != "shrink_seconds"}
                for item in out[key]
            ]
    return out


def _jax_module(args, cwd=None):
    """``python -m <args>`` of the JAX package on the CPU; returns the
    completed process (stdout, stderr, exit code)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd or root, env=env,
                          capture_output=True, text=True, check=False)


def search_goldens(out_dir: str) -> dict:
    """Phase 13a-b: the fleet-quick search with its wedge artifact (copied
    into ``out_dir``) and its CLI replay, and the 128-lane gray/WAN
    search."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        proc = _jax_module(["tpu_paxos", "fleet", *FLEET_QUICK_ARGS, "--triage-dir", tmp,
                            "--quiet"])
        if proc.returncode != 0:
            raise RuntimeError(f"JAX fleet-quick exited {proc.returncode}: {proc.stderr[-2000:]}")
        quick = json.loads(proc.stdout.strip().splitlines()[-1])
        path = os.path.join(out_dir, FLEET_QUICK_ARTIFACT)
        shutil.copyfile(os.path.join(tmp, FLEET_QUICK_ARTIFACT), path)
    out = repro_stdout(path, {})
    proc = _jax_module(["tpu_paxos", "fleet", "--lanes", str(SEARCH_WIDE_LANES),
                        *SEARCH_WIDE_ARGS, "--quiet"])
    if proc.returncode not in (0, 1):
        raise RuntimeError(f"JAX wide search exited {proc.returncode}: {proc.stderr[-2000:]}")
    wide = json.loads(proc.stdout.strip().splitlines()[-1])
    return {
        "fleet_quick": {
            "args": FLEET_QUICK_ARGS, "summary": normalize_summary(quick, SEARCH_TIMING_KEYS),
            "artifact": FLEET_QUICK_ARTIFACT, "artifact_sha256": _file_sha256(path),
            "repro_stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
        },
        "search_wide": {
            "args": SEARCH_WIDE_ARGS, "lanes": SEARCH_WIDE_LANES,
            "summary": normalize_summary(wide, SEARCH_TIMING_KEYS),
        },
    }


def stress_fleet_golden() -> dict:
    """Phase 13c: ``stress --fleet``'s two summary lines."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        proc = _jax_module(["tpu_paxos.harness.stress", "--fleet", "--seeds",
                            str(STRESS_FLEET_SEEDS), "--triage-dir", tmp])
    if proc.returncode != 0:
        raise RuntimeError(f"JAX stress --fleet exited {proc.returncode}: {proc.stderr[-2000:]}")
    host, fleet = [json.loads(ln) for ln in proc.stdout.strip().splitlines()[-2:]]
    return {"seeds": STRESS_FLEET_SEEDS,
            "host": normalize_summary(host, STRESS_TIMING_KEYS),
            "fleet": normalize_summary(fleet, STRESS_TIMING_KEYS)}


def envelope_cells():
    """The envelope grid's cells in order: ``(n_nodes, proposers,
    protocol index, rate index)``."""
    return [(n, tuple(props), pi, ri)
            for n, props in ENVELOPE["menu"]
            for pi in range(len(ENVELOPE["protocols"]))
            for ri in range(len(ENVELOPE["rates"]))]


def envelope_golden() -> dict:
    """Phase 13d: every cell of the padded envelope grid through one JAX
    ``runner_for(..., geometry=)``."""
    import numpy as np

    from tpu_paxos import config as cfgm
    from tpu_paxos.core import geom as geo
    from tpu_paxos.fleet import envelope as env
    from tpu_paxos.replay.decision_log import decision_log

    e = ENVELOPE
    genv = geo.GeometryEnvelope(menu=tuple((n, tuple(p)) for n, p in e["menu"]))
    tmpl = [np.arange(lo, hi, dtype=np.int32) for lo, hi in e["template"]]
    lanes = e["lanes"]
    seeds = [e["first_seed"] + i for i in range(lanes)]
    cells = []
    runner = None
    for n, props, pi, ri in envelope_cells():
        pc = cfgm.ProtocolConfig(**e["protocols"][pi])
        fc = cfgm.FaultConfig(**e["rates"][ri])
        cfg = cfgm.SimConfig(n_nodes=n, n_instances=e["n_instances"], proposers=props, seed=0,
                             max_rounds=e["max_rounds"], faults=cfgm.FaultConfig(max_delay=2),
                             protocol=pc)
        r = env.runner_for(cfg, tmpl, geometry=genv)
        if runner is not None and r is not runner:
            raise RuntimeError("the padded envelope did not collapse to one runner")
        runner = r
        wl = tmpl[: len(props)]
        rep = runner.run(seeds, [None] * lanes, workloads=[(wl, None)] * lanes,
                         knobs=[fc] * lanes, geometry=(n, props), protocol=pc)
        cv = np.asarray(rep.final.met.chosen_vid)  # paxlint: allow[JAX103] once per dispatch
        cb = np.asarray(rep.final.met.chosen_ballot)  # paxlint: allow[JAX103] once per dispatch
        cells.append({
            "n_nodes": n, "proposers": list(props), "protocol": pi, "rate": ri,
            "rounds": rep.verdict.rounds.tolist(),  # the verdict is host numpy
            "ok": rep.verdict.ok.tolist(),
            "decision_log_sha256": [
                hashlib.sha256(decision_log(cv[i], cb[i], e["stride"], e["n_instances"])
                               .encode()).hexdigest()
                for i in range(lanes)
            ],
        })
    return {"config": e, "cells": cells}


def phase13_goldens(out: dict, out_dir: str, parts=("search", "stress_fleet", "envelope")) -> dict:
    if "search" in parts:
        out["search"] = search_goldens(out_dir)
    if "stress_fleet" in parts:
        out["stress_fleet"] = stress_fleet_golden()
    if "envelope" in parts:
        out["envelope"] = envelope_golden()
    return out


def compute(n_instances: int = 1 << 23, out_dir: str | None = None) -> dict:
    """Every entry; the triage artifacts go to ``out_dir`` (a temporary
    directory when None)."""
    import tempfile

    out = compute_runs(n_instances)

    def rest(path):
        out.update(triage_goldens(out, path))
        out["telemetry"] = telemetry_goldens(out, path)
        phase13_goldens(out, path)

    if out_dir is not None:
        rest(out_dir)
        return out
    with tempfile.TemporaryDirectory() as tmp:
        rest(tmp)
    return out


def compute_runs(n_instances: int = 1 << 23) -> dict:
    from tpu_paxos import config as cfgm
    from tpu_paxos.harness import reference_runner as refr
    from tpu_paxos.harness import stress
    from tpu_paxos.replay.decision_log import decision_log
    from tpu_paxos.core import sim

    bc = bench_sim_config(n_instances)
    bench = _bench_run(bc, cfgm.FaultConfig(**bc["faults"]))
    mixes = {m[0]: m[1] for m in stress.MIXES + stress.WAN_MIXES}
    scheduled = {}
    for key, mix in sorted(SCHEDULED.items()):
        sc = dict(bc, faults=_faults_json(mixes[mix]), mix=mix)
        scheduled[key] = _bench_run(sc, cfgm.FaultConfig(**mixes[mix]), rounds_sha=True)

    srv, clt, ids = CLI_ARGS
    workload, gates, _ = refr.equivalent_workload(srv, clt, ids)
    ccfg = cfgm.SimConfig(
        n_nodes=srv, n_instances=clt * ids * 2, proposers=tuple(range(srv)),
        seed=0, faults=cfgm.FaultConfig(**CLI_FAULTS),
    )
    cres = sim.run(ccfg, workload, gates)
    cli = _summary(cres, decision_log(cres.chosen_vid, cres.chosen_ballot, ids, ccfg.n_instances))
    cli.update(
        args=CLI_ARGS, faults=CLI_FAULTS, stride=ids,
        cli="python -m tpu_paxos 4 4 10 --seed=0 --net-drop-rate=500 "
            "--net-dup-rate=1000 --net-max-delay=2",
    )
    fast_argv = list(FAST_CLI_ARGS)
    if n_instances != 1 << 23:  # the quick self-check shrinks this too
        fast_argv[1] = str(max(1, n_instances // 1024))
    out = _fast_cli_stdout(fast_argv)
    fast_cli = {
        "args": fast_argv,
        "cli": "python -m tpu_paxos " + " ".join(fast_argv),
        "stdout": out,
        "stdout_sha256": hashlib.sha256(out.encode()).hexdigest(),
    }
    return {"command": COMMAND, "bench_sim": bench, "cli_4_4_10": cli,
            "fast_cli_2p23": fast_cli, "fleet": fleet_goldens(), **scheduled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", default="", help="write the goldens JSON here")
    ap.add_argument("--instances", type=int, default=1 << 23)
    ap.add_argument("--fleet-only", action="store_true",
                    help="recompute only the fleet entry of the --write file")
    ap.add_argument("--triage-only", nargs="*", default=None,
                    choices=("stress_quick", "triage_wedge", "triage_full"),
                    help="recompute only the triage entries (all three, or those "
                    "named) of the --write file")
    ap.add_argument("--telemetry-only", action="store_true",
                    help="recompute only the telemetry entry of the --write file")
    for part in ("search", "stress-fleet", "envelope"):
        ap.add_argument(f"--{part}-only", action="store_true",
                        help=f"recompute only the {part.replace('-', '_')} entry of the "
                        "--write file")
    args = ap.parse_args(argv)
    out_dir = os.path.dirname(os.path.abspath(args.write or "goldens.json"))
    p13 = tuple(p for p in ("search", "stress_fleet", "envelope") if getattr(args, f"{p}_only"))
    if args.fleet_only or args.triage_only is not None or args.telemetry_only or p13:
        with open(args.write) as f:
            out = json.load(f)
        if args.fleet_only:
            out["fleet"] = fleet_goldens()
        if args.triage_only is not None:
            out.update(triage_goldens(out, out_dir, tuple(args.triage_only) or (
                "stress_quick", "triage_wedge", "triage_full")))
        if args.telemetry_only:
            out["telemetry"] = telemetry_goldens(out, out_dir)
        if p13:
            phase13_goldens(out, out_dir, p13)
    else:
        out = compute(args.instances, out_dir)
    text = json.dumps(out, indent=1, sort_keys=True) + "\n"
    if args.write:
        with open(args.write, "w") as f:
            f.write(text)
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
