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

Phase 14 of ``chip_smoke.py`` (membership) holds one more entry,
``member`` (``--member-only`` recomputes just it, about 6 min on the CPU
box):

- ``config5``: BASELINE config 5 at its literal size, ``ChurnEngine(7,
  2**20, churn=grow_shrink_schedule(7, 5, values_per_step=1),
  max_rounds=4000).run(seed)`` at seeds 5, 6 and 7: rounds, ``done``,
  ``injected``, the ``decision_log_of`` sha256 and the ``chosen_round``
  sha256;
- ``literal``: ``MemberSim(7, 2**20, seed=5)`` driven through
  :func:`literal_scenario` (``tests/test_membership.py``'s literal-size
  scenario): rounds, acceptors, decision-log and chosen-round sha256;
- ``cli``: in a fresh directory, the stdout of ``python -m tpu_paxos 4 4
  10 --engine=member --json --record-injections member_injections.json``
  (the reference member demo workload) and the injection log's text,
  the stdout of ``--replay-injections member_injections.json``, and the
  stdout of the same line with ``--crash-rate=5000`` (a rate at which a
  node crashes and the run still ends ``"ok": true``);
- ``rejoin``: ``MemberSim(7, 2**20, seed=4)`` through
  :func:`rejoin_scenario` (crash, checkpoint, rejoin): rounds, the
  decision-log sha256 and the injection-log ops less the rejoin's
  checkpoint path and hash (the file's bytes hold zip timestamps);
- ``fleet``: 128 lanes of the member envelope ``evolve --axis member``
  runs (3 nodes, 8 instances, 200 rounds, 4 episodes), each lane drawn by
  :func:`member_fleet_lanes` from ``np.random.default_rng(0)`` as
  ``evolve``'s ``fresh`` draws a genome; per lane the six verdict fields
  and the decision-log sha256, and the sha256 of the drawn genomes.

Phase 19 of ``chip_smoke.py`` (the instance-sharded engines) and the
sharded CPU tests hold these entries (``--sharded-only`` recomputes them,
about 5 min on the CPU box; JAX runs on 8 virtual CPU devices, provisioned
before its backend starts as ``tests/conftest.py`` does):

- ``sharded_parity``: :func:`sharded_cases` (fault-free, reference
  faults, crashes, gates across shards at 128 instances) on every mesh of
  :data:`SHARDED_MESHES` (1, 2, 4 and 8 devices and the (2, 4)
  ``("dcn", "i")`` mesh): rounds, ``done``, the chosen count, the
  decision-log sha256 and the sha256 of every SimResult array;
- ``sharded_sim_2p20_d8`` and ``sharded_sim_2p20_2x4``: ``bench.py``'s
  sharded general-engine record configuration (7 nodes, 2**20 instances,
  proposers (0, 1), ``assign_window`` 16384) at 8 devices and on (2, 4);
- ``sharded_fast``: ``sharded_choose_all`` over 10M iota vids and 7 nodes
  on (2, 4): ``n_chosen`` and the sha256 of every FastState field;
- ``cli_4_4_10_mesh8`` and ``fast_cli_2p23_mesh8``: the stdout of the
  ``--mesh 8`` CLI lines;
- ``sharded_repro``: ``tests/test_sharded_repro.py``'s case at 8 devices,
  saved (unshrunk) as ``repro_sharded_d8.json`` beside the goldens file,
  with its file sha256 and the stdout of ``repro <basename> --json`` in
  its directory;
- ``stress_sharded``: ``stress.sweep_sharded(n_seeds=2)``'s summary less
  ``seconds`` and ``platform``, and one of its runs (:data:`STRESS_SHARDED_ONE`)
  with the suite's verdict.

Phase 22 of ``chip_smoke.py`` (the library surface) holds ``library``
(``--library-only`` recomputes it, about 2 min on the CPU box):
``bench_sim``'s ``SimResult.rounds_to_chosen`` (length, sum, max,
sha256) and ``value_status`` of three vids, the same on ``cli_4_4_10``
with ``value_status`` of every workload vid and four sentinel or unknown
ones,
``run_equivalent_sim(4, 4, 10)`` at seeds 0-2 (rounds, ``done`` and the
sha256 of every SimResult array), and each JAX example's stdout on one
CPU device.

``tests`` is JAX's side of the port's heaviest CPU test files: for each
part of :data:`TEST_GOLDENS`, ``tests/test_torch_<part>.py``'s
``jax_goldens(tmp)`` (``--tests-only [part ...]`` recomputes them, 2-4
min a part); those files hold the port to it instead of rerunning JAX.

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


def _jax_module(args, cwd=None, env_extra=None):
    """``python -m <args>`` of the JAX package on the CPU, with
    ``env_extra`` set; returns the completed process (stdout, stderr,
    exit code)."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
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
    fleet = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"seeds": STRESS_FLEET_SEEDS, "host_seeds": STRESS_HOST_SEEDS,
            "host": stress_host_golden(),
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


MEMBER_CONFIG5 = {"n_nodes": 7, "n_instances": 1 << 20, "grow_to": 7, "shrink_to": 5,
                  "values_per_step": 1, "max_rounds": 4000, "seeds": [5, 6, 7]}
MEMBER_CLI_ARGS = ["4", "4", "10", "--engine=member", "--json"]
MEMBER_CLI_CRASH_RATE = 5000
MEMBER_INJECTIONS = "member_injections.json"
MEMBER_FLEET = {"n_nodes": 3, "n_instances": 8, "max_rounds": 200, "max_episodes": 4,
                "horizon": 96, "lanes": 128, "rng_seed": 0}


def literal_scenario(member_sim, n_instances: int = 1 << 20, **kw):
    """BASELINE config 5 through the host driver, as
    ``tests/test_membership.py``'s literal-size test drives it: grow
    1 -> 7 with a value in flight before each AddAcceptor, shrink to 5,
    Applied sequencing, then every value chosen.  ``member_sim`` is either
    package's ``MemberSim`` (``kw`` its extra arguments)."""
    ms = member_sim(n_nodes=7, n_instances=n_instances, seed=5, **kw)
    vid = 100
    for tgt in range(1, 7):
        ms.propose(0, vid)
        vid += 1
        cv = ms.add_acceptor(tgt)
        if not ms.run_until(lambda: ms.applied(cv), max_rounds=4000):
            raise RuntimeError(f"add_acceptor({tgt}) never applied")
    for tgt in (6, 5):
        cv = ms.del_acceptor(tgt)
        if not ms.run_until(lambda: ms.applied(cv), max_rounds=4000):
            raise RuntimeError(f"del_acceptor({tgt}) never applied")
    if not ms.run_until(lambda: all(ms.chosen(v) for v in range(100, vid)), max_rounds=4000):
        raise RuntimeError("the literal scenario's values were not all chosen")
    return ms


def rejoin_scenario(member_sim, checkpoint, path: str, n_instances: int = 1 << 20, **kw):
    """Crash-rejoin through the host driver: grow to {0, 1, 2}, choose
    100, crash node 2, checkpoint to ``path`` (``checkpoint`` is either
    package's module), choose 101 without node 2, rejoin it from the
    checkpoint and run until it has applied both values."""
    ms = member_sim(n_nodes=7, n_instances=n_instances, seed=4, **kw)
    for tgt in (1, 2):
        cv = ms.add_acceptor(tgt)
        if not ms.run_until(lambda: ms.applied(cv), max_rounds=2000):
            raise RuntimeError(f"add_acceptor({tgt}) never applied")
    ms.propose(0, 100)
    if not ms.run_until(lambda: ms.chosen(100)):
        raise RuntimeError("100 was not chosen")
    ms.crash(2)
    checkpoint.save(path, ms.state, meta={"crashed_node": 2})
    ms.propose(0, 101)
    if not ms.run_until(lambda: ms.chosen(101)):
        raise RuntimeError("101 was not chosen")
    ms.rejoin_from_checkpoint(2, path)
    if not ms.run_until(lambda: {100, 101} <= set(ms.applied_log(2).tolist())):
        raise RuntimeError("node 2 did not catch up")
    return ms


def rejoin_ops(injections) -> list:
    """An injection log's ops with each rejoin's checkpoint path and hash
    left out (the checkpoint file's bytes hold zip timestamps)."""
    return [[t, op, [args[0], args[2]["n_nodes"], args[2]["n_instances"]]] if op == "rejoin"
            else [t, op, args] for t, op, args in injections]


def member_fleet_lanes(search, n_lanes: int, n_nodes: int, rng_seed: int = 0,
                       horizon: int = 96, max_episodes: int = 4):
    """``n_lanes`` member genomes drawn as ``fleet/evolve.py``'s member
    axis draws them (``fresh``: a churn schedule, a member-legal fault
    schedule under the classic alphabet's member kinds, an engine seed),
    from ``np.random.default_rng(rng_seed)``; ``search`` is either
    package's ``fleet.search``.  Returns ``(seeds, churns, schedules)``."""
    import numpy as np

    kinds = search.Alphabet.classic().member().kinds
    rng = np.random.default_rng(rng_seed)
    seeds, churns, scheds = [], [], []
    for _ in range(n_lanes):
        churn = search.sample_churn_schedule(rng, n_nodes, horizon=horizon)
        scheds.append(search.sample_member_schedule(
            rng, n_nodes, churn=churn, max_episodes=max_episodes, horizon=horizon, kinds=kinds))
        seeds.append(int(rng.integers(0, 1 << 16)))
        churns.append(churn)
    return seeds, churns, scheds


def genomes_sha256(seeds, churns, scheds) -> str:
    """The sha256 of a fleet's drawn genomes as sorted compact JSON."""
    doc = [[s, c.to_dict() if c is not None else None, f.to_dict() if f is not None else None]
           for s, c, f in zip(seeds, churns, scheds)]
    return hashlib.sha256(json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def member_goldens() -> dict:
    """Phase 14: the membership goldens (module doc)."""
    import tempfile

    from tpu_paxos import checkpoint
    from tpu_paxos.fleet import envelope as env
    from tpu_paxos.fleet import search
    from tpu_paxos.membership import churn_table as ctm
    from tpu_paxos.membership import engine as meng

    def sha(text):
        return hashlib.sha256(text.encode()).hexdigest()

    c5 = MEMBER_CONFIG5
    eng = meng.ChurnEngine(
        c5["n_nodes"], c5["n_instances"],
        churn=ctm.grow_shrink_schedule(c5["grow_to"], c5["shrink_to"], c5["values_per_step"]),
        max_rounds=c5["max_rounds"],
    )
    runs = {}
    for seed in c5["seeds"]:
        r = eng.run(seed=seed)
        if not r.done:
            raise RuntimeError(f"config 5 seed {seed} did not complete")
        runs[str(seed)] = {
            "rounds": r.rounds, "done": r.done, "injected": r.injected,
            "decision_log_sha256": sha(meng.decision_log_of(r.state)),
            "chosen_round_sha256": chosen_round_sha256(r.state.chosen_round),
        }
    del eng
    ms = literal_scenario(meng.MemberSim)
    literal = {
        "rounds": int(ms.state.t), "acceptors": sorted(ms.acceptor_set(0)),
        "decision_log_sha256": sha(ms.decision_log()),
        "chosen_round_sha256": chosen_round_sha256(ms.state.chosen_round),
    }
    del ms
    with tempfile.TemporaryDirectory() as tmp:
        rec = _jax_module(["tpu_paxos", *MEMBER_CLI_ARGS, "--record-injections",
                           MEMBER_INJECTIONS], cwd=tmp)
        with open(os.path.join(tmp, MEMBER_INJECTIONS)) as f:
            inj = f.read()
        rep = _jax_module(["tpu_paxos", *MEMBER_CLI_ARGS, "--replay-injections",
                           MEMBER_INJECTIONS], cwd=tmp)
        crash = _jax_module(["tpu_paxos", *MEMBER_CLI_ARGS,
                             f"--crash-rate={MEMBER_CLI_CRASH_RATE}"], cwd=tmp)
        for name, proc in (("record", rec), ("replay", rep), ("crash", crash)):
            if proc.returncode != 0 or not json.loads(proc.stdout.splitlines()[-1])["ok"]:
                raise RuntimeError(f"JAX member CLI ({name}) failed: {proc.stderr[-2000:]}")
        ms = rejoin_scenario(meng.MemberSim, checkpoint, os.path.join(tmp, "rejoin.npz"))
        path = os.path.join(tmp, "rejoin_injections.json")
        ms.save_injections(path)
        again = meng.MemberSim.replay(path)
        if again.decision_log() != ms.decision_log():
            raise RuntimeError("the JAX rejoin replay diverged")
        if len(ms.crashed_set()) != 0 or ms.crashed_set() != again.crashed_set():
            raise RuntimeError("the rejoin scenario left a node crashed")
        rejoin = {"rounds": int(ms.state.t), "decision_log_sha256": sha(ms.decision_log()),
                  "ops": rejoin_ops(ms.injections)}
        del ms, again
    f = MEMBER_FLEET
    seeds, churns, scheds = member_fleet_lanes(search, f["lanes"], f["n_nodes"], f["rng_seed"],
                                               f["horizon"], f["max_episodes"])
    runner = env.member_runner_for(f["n_nodes"], f["n_instances"],
                                   max_episodes=f["max_episodes"], max_rounds=f["max_rounds"])
    rep_f = runner.run(seeds, churns, scheds)
    v = rep_f.verdict
    fleet = {
        "config": f, "genomes_sha256": genomes_sha256(seeds, churns, scheds),
        **{k: [int(x) if k == "rounds" else bool(x) for x in getattr(v, k)] for k in v._fields},
        "decision_log_sha256": [sha(rep_f.lane_log(i)) for i in range(rep_f.n_lanes)],
    }
    return {
        "config5": {"config": c5, "runs": runs},
        "literal": literal,
        "cli": {
            "args": MEMBER_CLI_ARGS, "injections": MEMBER_INJECTIONS,
            "record_stdout": rec.stdout, "injection_log": inj,
            "replay_stdout": rep.stdout, "crash_rate": MEMBER_CLI_CRASH_RATE,
            "crash_stdout": crash.stdout,
        },
        "rejoin": rejoin,
        "fleet": fleet,
    }


STRESS_HOST_SEEDS = 1  # 13c's host-loop half, cut to one seed a mix (PR 10)


def stress_host_golden() -> dict:
    """Phase 13c's host-loop half: JAX's ``sweep`` over the i.i.d.-only
    mixes (what ``stress --fleet`` runs on the host loop) at
    :data:`STRESS_HOST_SEEDS` seeds a mix."""
    import tempfile

    from tpu_paxos.harness import stress

    host_mixes = [m for m in stress.MIXES if "schedule" not in m[1]]
    with tempfile.TemporaryDirectory() as tmp:
        host = stress.sweep(STRESS_HOST_SEEDS, 0, verbose=False, triage_dir=tmp,
                            mixes=host_mixes)
    return normalize_summary(host, STRESS_TIMING_KEYS)


#: Phase 15 (open-loop serving), ``bench.py``'s serve records at their
#: on-TPU sizes: ``bench_serve_record`` (:1229, 2**16 values on 2**17
#: instances, Poisson at 16000 milli), ``BENCH_serve.json``'s
#: configuration (2**12 values on 2**13) and ``bench_serve_fleet_record``
#: (:1500, 256 lanes of 2**12 values on 2**13 instances).
SERVE = {
    "nodes": 5, "proposers": [0, 1], "seed": 0, "max_rounds": 20_000,
    "faults": {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
    "rounds_per_window": 2, "windows_per_dispatch": 32, "window_rounds": 128,
    "slo": {"latency_rounds": 64, "budget_milli": 100},
    "stride": 64,
    "full": {"n_values": 1 << 16, "rate_milli": 16_000},
    "twins": {"n_values": 1 << 12, "rate_milli": 16_000,
              "sweep_rates": [8000, 16_000, 32_000, 64_000]},
    "fleet": {"n_values": 1 << 12, "lanes": 256, "rates": [32_000, 128_000]},
    "cli": [["serve"], ["serve", "--fleet", "--lanes", "8"]],
    "trace": [["trace", "--serve", "--stdout"],
              ["trace", "--serve", "--stdout", "--lanes", "4", "--lane", "1"]],
}
SERVE_WALL_KEYS = ("wall_seconds", "values_per_sec", "values_per_sec_surface")


def serve_modules(port: bool):
    """The serving modules of one package: the port's (``port=True``;
    the card's ``chip_smoke.py`` drives these) or the JAX package's."""
    import types

    import numpy as np

    if port:
        from tpu_paxos_torch import config as cfgm
        from tpu_paxos_torch.core import sim
        from tpu_paxos_torch.replay.decision_log import decision_log
        from tpu_paxos_torch.serve import arrivals, control, fleet, harness

        def host(x):
            return x.cpu().numpy()
    else:
        from tpu_paxos import config as cfgm
        from tpu_paxos.core import sim
        from tpu_paxos.replay.decision_log import decision_log
        from tpu_paxos.serve import arrivals, control, fleet, harness

        host = np.asarray
    return types.SimpleNamespace(cfgm=cfgm, sim=sim, decision_log=decision_log,
                                 arrv=arrivals, sfl=fleet, sh=harness, ctl=control, host=host)


def less_wall(d):
    """A serve summary less its wall-clock fields, at every depth."""
    if isinstance(d, list):
        return [less_wall(x) for x in d]
    if not isinstance(d, dict):
        return d
    return {k: less_wall(v) for k, v in d.items() if k not in SERVE_WALL_KEYS}


def serve_cfg(m, n_values: int):
    return m.cfgm.SimConfig(
        n_nodes=SERVE["nodes"], n_instances=2 * n_values, proposers=tuple(SERVE["proposers"]),
        seed=SERVE["seed"], max_rounds=SERVE["max_rounds"],
        faults=m.cfgm.FaultConfig(**SERVE["faults"]),
    )


def serve_stream(m, n_values: int, rate_milli: int):
    import numpy as np

    vids = np.arange(n_values, dtype=np.int32)
    rounds = m.arrv.poisson_rounds(n_values, rate_milli, SERVE["seed"])
    return m.arrv.split_round_robin(vids, rounds, len(SERVE["proposers"]))


def serve_slo(m):
    return m.sh.ServeSLO(**SERVE["slo"])


def _log_sha(m, cv, cb) -> str:
    text = m.decision_log(cv, cb, stride=SERVE["stride"], n_instances=len(cv))
    return hashlib.sha256(text.encode()).hexdigest()


def serve_report_record(m, rep) -> dict:
    """What a ``serve_run`` report must reproduce: every field but the
    wall clock, the summary and SLO dicts whole, and the decision-log
    sha256."""
    return {
        "rounds": rep.rounds, "dispatches": rep.dispatches, "windows": rep.windows_count,
        "done": rep.done, "decided": rep.decided_values, "backlog": rep.backlog,
        "p50": rep.p50, "p99": rep.p99, "p999": rep.p999, "latency_max": rep.latency_max,
        "admit_width": rep.admit_width, "window_decided": rep.window_decided,
        "summary": rep.summary, "slo": rep.slo,
        "slo_first_breach_dispatch": rep.slo_first_breach_dispatch,
        "decision_log_sha256": _log_sha(m, rep.chosen_vid, rep.chosen_ballot),
    }


def serve_full_run(m, **dev):
    """15a: the 2**16-value stream on 2**17 instances, pipelined, at the
    plan's ``max_block``; returns the report."""
    f = SERVE["full"]
    cfg = serve_cfg(m, f["n_values"])
    streams, arrs = serve_stream(m, f["n_values"], f["rate_milli"])
    return m.sh.serve_run(
        cfg, streams, arrs, rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=SERVE["windows_per_dispatch"],
        window_rounds=SERVE["window_rounds"], slo=serve_slo(m), **dev,
    )


def serve_twins_width(m) -> int:
    """15b's one admit width: the main stream's and every sweep rate's
    ``max_block``, as ``bench_serve_record`` takes it."""
    t = SERVE["twins"]
    width = 1
    for rate in [t["rate_milli"]] + t["sweep_rates"]:
        streams, arrs = serve_stream(m, t["n_values"], rate)
        width = max(width, m.arrv.ArrivalPlan(streams, arrs, SERVE["rounds_per_window"]).max_block)
    return width


#: 15b's three dispatch modes of one stream: (windows per dispatch,
#: pipelined, windowed plane and SLO armed)
SERVE_TWINS = {"pipelined": (32, True, True), "sequential": (1, False, True),
               "plain": (32, True, False)}


def serve_twin_run(m, mode: str, width: int, **dev):
    """15b: one dispatch mode of the 2**12-value stream; the report."""
    t = SERVE["twins"]
    s, pipelined, armed = SERVE_TWINS[mode]
    cfg = serve_cfg(m, t["n_values"])
    streams, arrs = serve_stream(m, t["n_values"], t["rate_milli"])
    return m.sh.serve_run(
        cfg, streams, arrs, rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=s, admit_width=width, pipelined=pipelined,
        window_rounds=SERVE["window_rounds"] if armed else 0,
        slo=serve_slo(m) if armed else None, **dev,
    )


def serve_sweep(m, width: int, **dev) -> dict:
    """15b's ``sweep_load`` at the four rates bracketing the knee, less
    the wall fields."""
    t = SERVE["twins"]
    out = m.sh.sweep_load(
        serve_cfg(m, t["n_values"]), t["n_values"], t["sweep_rates"], seed=SERVE["seed"],
        rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=SERVE["windows_per_dispatch"], admit_width=width,
        window_rounds=SERVE["window_rounds"], slo=serve_slo(m), **dev,
    )
    return less_wall(out)


def serve_fleet_width(m) -> int:
    f = SERVE["fleet"]
    return m.sfl.grid_admit_width(
        serve_cfg(m, f["n_values"]), f["n_values"], [f["lanes"]], f["rates"],
        seed=SERVE["seed"], rounds_per_window=SERVE["rounds_per_window"],
    )


def serve_fleet_record(m, rep) -> dict:
    """What one 256-lane serve fleet run must reproduce: the dispatch and
    round counts, every lane's decided count, breach flag, first breach
    dispatch and decision-log sha256, the flagged lanes' host-confirmed
    verdicts (whole for the first, sha256 of the sorted JSON of all)."""
    met = rep.final.sim.met
    cv, cb = m.host(met.chosen_vid), m.host(met.chosen_ballot)
    slo = {str(k): v for k, v in sorted((rep.slo or {}).items())}
    flagged = sorted(int(k) for k in slo)
    return {
        "lanes": rep.n_lanes, "dispatches": rep.dispatches, "rounds": rep.rounds,
        "done": rep.done, "admit_width": rep.admit_width,
        "decided": [int(x) for x in rep.decided],
        "breach": [bool(x) for x in rep.breach],
        "first_breach_dispatch": list(rep.first_breach_dispatch),
        "flagged": flagged,
        "slo_sha256": hashlib.sha256(json.dumps(slo, sort_keys=True).encode()).hexdigest(),
        "slo_first": slo[str(flagged[0])] if flagged else None,
        "decision_log_sha256": [_log_sha(m, cv[i], cb[i]) for i in range(rep.n_lanes)],
    }


def serve_fleet_run(m, rate_milli: int, width: int, **dev):
    """15c: the 256-lane fleet at ``rate_milli``; the report."""
    f = SERVE["fleet"]
    cfg = serve_cfg(m, f["n_values"])
    lanes = m.sfl.fleet_lanes(cfg, f["lanes"], f["n_values"], rate_milli, SERVE["seed"])
    return m.sfl.serve_fleet_run(
        cfg, lanes, rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=SERVE["windows_per_dispatch"], admit_width=width,
        window_rounds=SERVE["window_rounds"], slo=serve_slo(m), **dev,
    )


def serve_zero_load(m, **dev) -> dict:
    """15c's parity anchor: a 1-lane zero-load fleet and the closed-loop
    ``sim.run`` of the same streams; their decision-log sha256."""
    import numpy as np

    f = SERVE["fleet"]
    cfg = serve_cfg(m, f["n_values"])
    vids = np.arange(f["n_values"], dtype=np.int32)
    streams, _ = m.arrv.split_round_robin(vids, m.arrv.immediate_rounds(f["n_values"]), 2)
    zarrs = [np.zeros(len(s), np.int32) for s in streams]
    rep = m.sfl.serve_fleet_run(
        cfg, [m.sfl.ServeLane(streams, zarrs, SERVE["seed"])],
        rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=SERVE["windows_per_dispatch"], **dev,
    )
    closed = m.sim.run(cfg, streams, **dev)
    cv, cb = rep.lane_chosen(0)
    return {"fleet": _log_sha(m, cv, cb),
            "closed": _log_sha(m, closed.chosen_vid, closed.chosen_ballot),
            "rounds": rep.rounds, "closed_rounds": int(closed.rounds)}


def serve_goldens() -> dict:
    """Every phase-15 golden, from the JAX package on the CPU."""
    m = serve_modules(port=False)
    full = serve_report_record(m, serve_full_run(m))
    width = serve_twins_width(m)
    twins = {mode: serve_report_record(m, serve_twin_run(m, mode, width)) for mode in SERVE_TWINS}
    fwidth = serve_fleet_width(m)
    fleet = {str(rate): serve_fleet_record(m, serve_fleet_run(m, rate, fwidth))
             for rate in SERVE["fleet"]["rates"]}
    cli = {}
    for args in SERVE["cli"]:
        proc = _jax_module(["tpu_paxos", *args])
        cli[" ".join(args)] = {"rc": proc.returncode,
                               "summary": less_wall(json.loads(proc.stdout.strip().splitlines()[-1]))}
    trace = {}
    for args in SERVE["trace"]:
        proc = _jax_module(["tpu_paxos", *args])
        if proc.returncode != 0:
            raise RuntimeError(f"JAX {' '.join(args)} exited {proc.returncode}")
        trace[" ".join(args)] = {"stdout_sha256": hashlib.sha256(proc.stdout.encode()).hexdigest(),
                                 "bytes": len(proc.stdout)}
    return {
        "config": SERVE, "full": full, "twins_admit_width": width, "twins": twins,
        "sweep": serve_sweep(m, width), "fleet_admit_width": fwidth, "fleet": fleet,
        "zero_load": serve_zero_load(m), "cli": cli, "trace": trace,
    }


#: Phase 16 (the admission controller).  ``ab``: ``bench.py``'s
#: ``bench_serve_control_record`` (``bench.py:1765-1860``), held against
#: the committed ``BENCH_serve_control.json``; ``full``: one armed
#: controlled run at phase 15a's width under a spike; ``fleet``: the
#: controlled 256-lane fleet at 15c's 128000-milli cell; ``cli``: the
#: controller's CLIs at small sizes (``serve-control-quick``'s, the
#: ``serve-control`` A/B, a controlled 8-lane fleet and ``repro`` of the
#: saved artifact).
CONTROL = {
    "ab": {"n_nodes": 3, "n_instances": 2048, "proposers": [0, 1], "seed": 3,
           "max_rounds": 8000, "assign_window": 8, "n_values": 1000, "rate_milli": 2000,
           "arrival_seed": 0, "rounds_per_window": 4, "windows_per_dispatch": 2,
           "window_rounds": 32, "spike_factor": 4, "spike_start_frac": 0.25,
           "spike_len_frac": 0.5, "slo": {"latency_rounds": 16, "budget_milli": 150}},
    "full": {"n_values": 1 << 16, "rate_milli": 16_000, "spike_factor": 4,
             "spike_start_frac": 0.375, "spike_len_frac": 0.25},
    "fleet": {"n_values": 1 << 12, "lanes": 256, "rate_milli": 128_000},
    "artifact": "serve_control.json",
    "cli": [
        ["serve", "--nodes", "3", "--values", "60", "--rate-milli", "2000", "--slo-latency", "16",
         "--slo-budget-milli", "150", "--control", "--rounds-per-window", "4",
         "--windows-per-dispatch", "2", "--window-rounds", "32", "--max-rounds", "4000",
         "--save-artifact", "serve_control.json"],
        ["serve", "--control-ab", "--nodes", "3", "--values", "1000", "--rate-milli", "2000",
         "--spike-factor", "4", "--spike-start-frac", "0.25", "--spike-len-frac", "0.5",
         "--slo-latency", "16", "--slo-budget-milli", "150", "--rounds-per-window", "4",
         "--windows-per-dispatch", "2", "--window-rounds", "32", "--instances", "2048",
         "--assign-window", "8", "--max-rounds", "8000", "--seed", "3", "--arrival-seed", "0"],
        ["serve", "--fleet", "--lanes", "8", "--control", "--slo-latency", "16",
         "--slo-budget-milli", "150", "--rate-milli", "16000"],
    ],
    "repro": ["repro", "serve_control.json", "--json"],
    "committed_artifact": "artifacts/serve_control_spike.json",
}


def control_policy(m):
    """``spike_ab``'s default shed-only policy."""
    return m.ctl.ControlPolicy(n_tiers=3, defer_tier=2, shed_tier=2)


def control_ab(m, artifact_path=None, **dev) -> dict:
    """16a: ``spike_ab`` at ``bench_serve_control_record``'s configuration."""
    a = CONTROL["ab"]
    cfg = m.cfgm.SimConfig(
        n_nodes=a["n_nodes"], n_instances=a["n_instances"], proposers=tuple(a["proposers"]),
        seed=a["seed"], max_rounds=a["max_rounds"], assign_window=a["assign_window"],
    )
    return m.ctl.spike_ab(
        cfg, a["n_values"], a["rate_milli"], slo=m.sh.ServeSLO(**a["slo"]),
        seed=a["arrival_seed"], rounds_per_window=a["rounds_per_window"],
        windows_per_dispatch=a["windows_per_dispatch"], spike_factor=a["spike_factor"],
        spike_start_frac=a["spike_start_frac"], spike_len_frac=a["spike_len_frac"],
        window_rounds=a["window_rounds"], artifact_path=artifact_path, **dev,
    )


def control_full_inputs(m):
    """16b's stream: ``spike_rounds`` at phase 15a's size, split round
    robin over the proposers with ``spike_ab``'s priority tiers."""
    import numpy as np

    f = CONTROL["full"]
    n = f["n_values"]
    rounds = m.arrv.spike_rounds(n, f["rate_milli"], SERVE["seed"], factor=f["spike_factor"],
                                 start_frac=f["spike_start_frac"], len_frac=f["spike_len_frac"])
    vids = np.arange(n, dtype=np.int32)
    n_prop = len(SERVE["proposers"])
    streams, arrs = m.arrv.split_round_robin(vids, rounds, n_prop)
    prios = m.arrv.tier_priorities(vids, 3)
    return streams, arrs, [prios[p::n_prop] for p in range(n_prop)]


def control_full_run(m, **dev):
    """16b: one armed ``controlled_serve_run`` at 15a's full width."""
    streams, arrs, prios = control_full_inputs(m)
    return m.ctl.controlled_serve_run(
        serve_cfg(m, CONTROL["full"]["n_values"]), streams, arrs, priorities=prios,
        control=control_policy(m), rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=SERVE["windows_per_dispatch"],
        window_rounds=SERVE["window_rounds"], slo=serve_slo(m), **dev,
    )


def _json_sha(x) -> str:
    return hashlib.sha256(json.dumps(x, sort_keys=True).encode()).hexdigest()


def control_report_record(rep) -> dict:
    """What a ``controlled_serve_run`` report must reproduce: every field
    but the wall clock, the summary and SLO dicts whole, the decisions,
    the shed records' sha256 and the combined decision-log sha256."""
    return {
        "rounds": rep.rounds, "dispatches": rep.dispatches, "done": rep.done,
        "decided": rep.decided_values, "shed": rep.shed_count, "backlog": rep.backlog,
        "p50": rep.p50, "p99": rep.p99, "latency_max": rep.latency_max,
        "admit_width": rep.admit_width, "window_decided": rep.window_decided,
        "summary": rep.summary, "slo": rep.slo,
        "slo_first_breach_dispatch": rep.slo_first_breach_dispatch,
        "decisions": rep.decisions, "sheds_sha256": _json_sha(rep.sheds),
        "decision_log_sha256": rep.decision_log_sha256,
    }


def control_fleet_run(m, **dev):
    """16c: the controlled 256-lane fleet at 15c's 128000-milli cell."""
    f = CONTROL["fleet"]
    cfg = serve_cfg(m, f["n_values"])
    lanes = m.sfl.fleet_lanes(cfg, f["lanes"], f["n_values"], f["rate_milli"], SERVE["seed"])
    return m.ctl.controlled_fleet_run(
        cfg, lanes, control=control_policy(m), rounds_per_window=SERVE["rounds_per_window"],
        windows_per_dispatch=SERVE["windows_per_dispatch"],
        window_rounds=SERVE["window_rounds"], slo=serve_slo(m), **dev,
    )


def control_fleet_record(m, rep) -> dict:
    """What the controlled fleet must reproduce: per lane the decided
    count, breach flag, first breach dispatch, shed count, decisions and
    combined decision-log sha256 (the protocol log plus the lane's
    control trail), the flagged lanes' verdicts (sha256 of the sorted
    JSON), and the dispatch and round counts."""
    met = rep.final.serve.sim.met
    cv, cb = m.host(met.chosen_vid), m.host(met.chosen_ballot)
    by_lane = [[] for _ in range(rep.n_lanes)]
    for dc in rep.decisions:
        by_lane[dc["lane"]].append({k: dc[k] for k in sorted(dc) if k != "lane"})
    slo = {str(k): v for k, v in sorted((rep.slo or {}).items())}
    return {
        "lanes": rep.n_lanes, "dispatches": rep.dispatches, "rounds": rep.rounds,
        "done": rep.done, "admit_width": rep.admit_width,
        "decided": [int(x) for x in rep.decided],
        "breach": [bool(x) for x in rep.breach],
        "first_breach_dispatch": list(rep.first_breach_dispatch),
        "lane_shed": list(rep.lane_shed), "shed_total": rep.shed_total,
        "lane_decisions": [len(x) for x in by_lane],
        "decisions_sha256": _json_sha(rep.decisions),
        "sheds_sha256": _json_sha(rep.sheds),
        "flagged": sorted(int(k) for k in slo),
        "slo_sha256": _json_sha(slo),
        "decision_log_sha256": [
            hashlib.sha256(m.ctl.decision_log_text(cv[i], cb[i], by_lane[i]).encode()).hexdigest()
            for i in range(rep.n_lanes)
        ],
    }


def control_cli_goldens(run) -> dict:
    """16d: ``run(args, cwd)`` of each controller CLI in one fresh
    directory (the saved artifact's path is relative, so ``repro`` prints
    the same name in either package): the summary less the wall fields
    and the exit code, the saved artifact's sha256, and the ``repro``
    stdout's sha256."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for args in CONTROL["cli"]:
            proc = run(args, tmp)
            out[" ".join(args)] = {"rc": proc.returncode,
                                   "summary": less_wall(json.loads(proc.stdout.strip().splitlines()[-1]))}
        out["artifact_sha256"] = _file_sha256(os.path.join(tmp, CONTROL["artifact"]))
        proc = run(CONTROL["repro"], tmp)
        out["repro"] = {"rc": proc.returncode,
                        "stdout_sha256": hashlib.sha256(proc.stdout.encode()).hexdigest()}
    return out


def control_committed_goldens() -> dict:
    """``repro ... --json`` and ``trace ... --stdout`` of the committed
    spike artifact, run from the repo root: the exit code and the
    stdout's sha256 (JAX's trace of a serve artifact replays its config
    and workload closed-loop, recorder-free)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    art = CONTROL["committed_artifact"]
    out = {"artifact_sha256": _file_sha256(os.path.join(root, art))}
    for key, args in (("repro", ["repro", art, "--json"]), ("trace", ["trace", art, "--stdout"])):
        proc = _jax_module(["tpu_paxos", *args])
        out[key] = {"args": args, "rc": proc.returncode,
                    "stdout_sha256": hashlib.sha256(proc.stdout.encode()).hexdigest()}
    return out


def control_goldens() -> dict:
    """Every phase-16 golden, from the JAX package on the CPU."""
    m = serve_modules(port=False)
    return {
        "config": CONTROL,
        "ab": less_wall(control_ab(m)),
        "full": control_report_record(control_full_run(m)),
        "fleet": control_fleet_record(m, control_fleet_run(m)),
        "cli": control_cli_goldens(lambda args, cwd: _jax_module(["tpu_paxos", *args], cwd=cwd)),
        "committed": control_committed_goldens(),
    }


#: Phase 17 (model checking).  ``tiny_fault`` and ``tiny_control`` are
#: the small scopes of ``tests/test_modelcheck.py`` and
#: ``tests/test_mc_control.py``; ``churn_cx`` is the 4-round scope of
#: ``test_mc_member.py::test_churn_counterexample_dumps_named_artifact``
#: with adds of nodes 1 and 2 over two events (that test's own grid, one
#: plain value, finishes within its 4 rounds, so it dumps nothing);
#: ``quick_scopes`` run in ``make mc-quick``'s order in one process;
#: ``lane_chunks`` of the quick scope are held lane by lane.
MC = {
    "tiny_fault": {
        "n_nodes": 3, "proposers": 2, "horizon": 12, "max_rounds": 400,
        "intervals": [[2, 8]], "kinds": ["pause", "burst", "crash"],
        "pause_set_sizes": [1], "burst_rates": [2000],
        "crash_rounds": [4], "crash_set_sizes": [1], "max_episodes": 2,
        "knob_tiers": [{"drop_rate": 500, "max_delay": 2}],
        "gate_tiers": [True, False], "seeds": [0], "chunk_lanes": 4,
        "n_ids": 2, "n_free": 2,
    },
    "tiny_control": {
        "tier_bands": [[3, 1, 2]], "patiences": [1], "ladders": [[]],
        "window_sets": [[], ["gray-region"], ["saturation"]],
        "burn_tiers": [0, 900], "max_dispatches": 2, "plan_values": 4,
        "chunk_lanes": 16,
    },
    "tiny_control_cx": 3,
    "churn_cx": {
        "n_nodes": 3, "n_instances": 8, "max_rounds": 4, "horizon": 2,
        "plain_values": 1, "add_targets": [1, 2], "t0_grid": [0],
        "max_events": 2, "seeds": [0], "chunk_lanes": 4,
    },
    "churn_cx_max": 2,
    "quick_scopes": ["quick", "gray", "churn", "control"],
    "lane_chunks": 2,
    "recall": {"scope": "quick", "wedge": "takeover", "max_counterexamples": 1},
    "full_chunks": 2,
    "gray_cli": ["mc", "--scope", "gray", "--json", "--quiet"],
    "nosuch_cli": ["mc", "--scope", "nosuch"],
}

#: Summary keys that hold timings or name the device, and the two the
#: ``mc`` CLI adds (the scope's name; its certificate failures, which its
#: exit code reflects).
MC_LESS_KEYS = ("lanes_per_sec", "backend", "scope", "certificate_failures")


def mc_modules(port: bool):
    """The model checker's modules of one package (``port=True``: the
    port's, which ``chip_smoke.py`` and the tests drive)."""
    import types

    if port:
        from tpu_paxos_torch.analysis import mc_control, mc_member, modelcheck
        from tpu_paxos_torch.fleet import envelope, runner
        from tpu_paxos_torch.harness import shrink, stress
        from tpu_paxos_torch.replay.decision_log import decision_log
        from tpu_paxos_torch.serve import control
    else:
        from tpu_paxos.analysis import mc_control, mc_member, modelcheck
        from tpu_paxos.fleet import envelope, runner
        from tpu_paxos.harness import shrink, stress
        from tpu_paxos.replay.decision_log import decision_log
        from tpu_paxos.serve import control
    return types.SimpleNamespace(mc=modelcheck, mcm=mc_member, mcc=mc_control, env=envelope,
                                 frun=runner, shr=shrink, strs=stress, ctl=control,
                                 decision_log=decision_log)


def mc_less(summary: dict) -> dict:
    """A run_scope or ``mc --json`` summary less :data:`MC_LESS_KEYS`,
    ``compiles_per_chunk`` cut to its zero pattern (JAX counts XLA
    compiles, the port runner builds) and counterexamples without their
    artifact path and shrink seconds."""
    out = {k: v for k, v in summary.items() if k not in MC_LESS_KEYS}
    out["compiles_per_chunk"] = [c > 0 for c in summary["compiles_per_chunk"]]
    out["counterexamples"] = [
        {k: v for k, v in cx.items() if k not in ("artifact", "shrink_seconds")}
        for cx in summary["counterexamples"]
    ]
    return out


def mc_env(m, env: dict):
    """``env`` set in ``os.environ`` for the block, the envelope cache of
    ``m``'s package cleared on the way in and out."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        m.env.clear_cache()
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            m.env.clear_cache()
    return scope()


def mc_first_reports(m, keep: int):
    """The reports of the first ``keep`` ``FleetRunner.run`` dispatches
    of ``m``'s package in the block (``run_scope``'s own chunks)."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        real = m.frun.FleetRunner.run
        reports = []

        def run(self, *a, **kw):
            rep = real(self, *a, **kw)
            if len(reports) < keep:
                reports.append(rep)
            return rep
        m.frun.FleetRunner.run = run
        try:
            yield reports
        finally:
            m.frun.FleetRunner.run = real
    return scope()


def mc_lane_shas(m, reports) -> list:
    """The decision-log sha256 of every judged lane of the quick scope's
    chunk ``reports`` (stride: the largest workload vid + 1)."""
    import numpy as np

    scope = m.mc.load_scopes()["quick"]
    wl, _, _ = m.strs._workload(scope.proposers, np.random.default_rng(scope.workload_seed),
                                n_ids=scope.n_ids, n_free=scope.n_free)
    n_instances = 2 * sum(len(w) for w in wl)
    stride = int(max(int(w.max()) for w in wl)) + 1
    pads = m.mc.chunk_pad(m.mc.ScopeEnum(scope).reduced, scope.chunk_lanes)
    out = []
    for rep, (_, n_real) in zip(reports, pads):
        for i in range(n_real):
            r = rep.lane_result(i)
            text = m.decision_log(r.chosen_vid, r.chosen_ballot, stride, n_instances)
            out.append(hashlib.sha256(text.encode()).hexdigest())
    return out


def mc_recall(m, out_dir: str, **dev) -> dict:
    """17b, the fault scope: the quick scope with the takeover wedge
    armed, stopped at its first counterexample, shrunk into
    ``out_dir``; the summary and the certificate failures it draws."""
    rc = MC["recall"]
    scope = m.mc.load_scopes()[rc["scope"]]
    enum = m.mc.ScopeEnum(scope)
    with mc_env(m, {"TPU_PAXOS_SEEDED_WEDGE": rc["wedge"]}):
        s = m.mc.run_scope(scope, verbose=False, triage_dir=out_dir,
                           max_counterexamples=rc["max_counterexamples"], **dev)
    pinned = m.mc.load_certificates()[rc["scope"]]
    fails = m.mc.check_certificate(
        dict(pinned, verdict_bits=pinned["verdict_bits"][:len(s["verdict_bits"])]), s, enum)
    return {"summary": s, "certificate_failures": fails}


def mc_tiny_control(m, out_dir: str, **dev) -> dict:
    """17b, the controller: the tiny host scope clean, then armed with
    ``shed-on-gray`` (counterexamples shrunk into ``out_dir``)."""
    scope = m.mcc.ControlScope.from_dict(MC["tiny_control"])
    clean = m.mcc.run_scope(scope, verbose=False, **dev)
    with mc_env(m, {"TPU_PAXOS_SEEDED_WEDGE": m.ctl.WEDGE_SHED_ON_GRAY}):
        wedged = m.mcc.run_scope(scope, verbose=False, triage_dir=out_dir,
                                 max_counterexamples=MC["tiny_control_cx"], **dev)
    return {"clean": clean, "wedged": wedged}


def mc_churn_cx(m, out_dir: str, **dev) -> dict:
    scope = m.mcm.ChurnScope.from_dict(MC["churn_cx"])
    return m.mcm.run_scope(scope, triage_dir=out_dir, verbose=False,
                           max_counterexamples=MC["churn_cx_max"], **dev)


def _dump_texts(summary: dict) -> dict:
    out = {}
    for cx in summary["counterexamples"]:
        if "artifact" in cx:
            with open(cx["artifact"]) as f:
                out[os.path.basename(cx["artifact"])] = f.read()
    return out


def mc_goldens() -> dict:
    """Every phase-17 golden, from the JAX package on the CPU."""
    import tempfile

    m = mc_modules(port=False)
    out = {"config": MC}
    proc = _jax_module(["tpu_paxos", "mc", "--scope", ",".join(MC["quick_scopes"]), "--json",
                        "--quiet"])
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    out["quick_scopes"] = {"rc": proc.returncode,
                           "summaries": {d["scope"]: mc_less(d) for d in lines}}
    with mc_first_reports(m, MC["lane_chunks"]) as reports:
        m.mc.run_scope(m.mc.load_scopes()["quick"], verbose=False,
                       chunk_limit=MC["lane_chunks"])
    out["quick_lanes"] = mc_lane_shas(m, reports)
    out["tiny_fault"] = mc_less(m.mc.run_scope(m.mc.McScope.from_dict(MC["tiny_fault"]),
                                               verbose=False))
    with tempfile.TemporaryDirectory() as tmp:
        rec = mc_recall(m, tmp)
        s = rec["summary"]
        cx = s["counterexamples"][0]  # the one shrunk (the budget is 1)
        name = os.path.basename(cx["artifact"])
        rstdout = repro_stdout(cx["artifact"], {"TPU_PAXOS_SEEDED_WEDGE": MC["recall"]["wedge"]})
        out["recall"] = {
            "summary": mc_less(s),
            "certificate_failures": rec["certificate_failures"],
            "artifact": name,
            "artifact_sha256": _file_sha256(cx["artifact"]),
            "repro_stdout_sha256": hashlib.sha256(rstdout.encode()).hexdigest(),
            "repro_match": json.loads(rstdout.splitlines()[-1])["match"],
        }
    with tempfile.TemporaryDirectory() as tmp:
        ctl = mc_tiny_control(m, tmp)
        arts = _dump_texts(ctl["wedged"])
        first = os.path.basename(ctl["wedged"]["counterexamples"][0]["artifact"])
        clis = {}
        for args in (["repro", first], ["repro", first, "--json"], ["trace", first, "--stdout"]):
            p = _jax_module(["tpu_paxos", *args], cwd=tmp)
            clis[" ".join(args)] = {"rc": p.returncode, "stdout": p.stdout}
        out["tiny_control"] = {"clean": mc_less(ctl["clean"]), "wedged": mc_less(ctl["wedged"]),
                               "artifacts": arts, "cli": clis}
    with tempfile.TemporaryDirectory() as tmp:
        s = mc_churn_cx(m, tmp)
        out["churn_cx"] = {"summary": mc_less(s), "artifacts": _dump_texts(s)}
    p = _jax_module(["tpu_paxos", *MC["gray_cli"]])
    gray = json.loads(p.stdout)
    out["gray_cli"] = {"rc": p.returncode, "certificate_failures": gray["certificate_failures"],
                       "summary": mc_less(gray)}
    p = _jax_module(["tpu_paxos", *MC["nosuch_cli"]])
    out["nosuch_cli"] = {"rc": p.returncode, "stdout": p.stdout}
    return out


#: Phase 18 (the selection loop): 18a ``make evolve-quick``'s line, 18b
#: the member and serve axes and the one-lane ``lane_causes`` case at
#: ``tests/test_evolve.py``'s sizes, 18c the card's default population,
#: 18d the certified recall (``BENCH_evolve.json``'s contract, the takeover
#: wedge armed); ``sweep`` sizes the seeded sweep of the pure operators.
EVOLVE = {
    "quick": ["--lanes", "8", "--generations", "2", "--seed", "2",
              "--decision-round-max", "35", "--max-wedges", "1"],  # Makefile:153-155
    "member": {"axis": "member", "n_lanes": 4, "generations": 2, "base_seed": 0,
               "hunt": "duel-churn", "max_wedges": 2},
    "serve": {"axis": "serve", "n_lanes": 6, "generations": 3, "base_seed": 0,
              "hunt": "saturation", "max_wedges": 4},
    "lane_causes": {"axis": "fleet", "n_lanes": 1, "generations": 1, "base_seed": 0,
                    "hunt": "duel-churn", "decision_round_max": 1, "max_wedges": 0},
    "wide": ["--lanes", "128", "--generations", "2", "--seed", "0", "--hunt", "duel-churn"],
    "certified": ["--lanes", "8", "--generations", "29", "--seed", "0", "--hunt", "duel-churn",
                  "--certified"],
    "wedge": "takeover",
    "sweep": {"seeds": 20, "lanes": 8, "alphabets": ["classic", "gray_wan", "member"]},
}

#: Summary keys that hold wall-clock timings.
EVOLVE_WALL_KEYS = ("seconds", "lanes_per_sec")


def evolve_modules(port: bool):
    """The selection loop's modules of one package (``port=True``: the
    port's, which ``chip_smoke.py`` and the tests drive)."""
    import types

    if port:
        from tpu_paxos_torch.core import faults
        from tpu_paxos_torch.fleet import envelope, evolve, search
    else:
        from tpu_paxos.core import faults
        from tpu_paxos.fleet import envelope, evolve, search
    return types.SimpleNamespace(evo=evolve, srch=search, fltm=faults, env=envelope)


def evolve_less(summary: dict) -> dict:
    """An ``evolve`` summary less :data:`EVOLVE_WALL_KEYS`,
    ``compiles_per_generation`` cut to its zero pattern (JAX counts XLA
    compiles, the port runner builds), artifact paths cut to their
    basename and each wedge without its ``shrink_seconds``, in the JSON
    form the CLI prints (tuples as lists)."""
    out = {k: v for k, v in sorted(summary.items()) if k not in EVOLVE_WALL_KEYS}
    out["compiles_per_generation"] = [c > 0 for c in summary["compiles_per_generation"]]
    if out.get("artifact"):
        out["artifact"] = os.path.basename(out["artifact"])
    out["wedges"] = [
        {k: (os.path.basename(v) if k == "artifact" else v)
         for k, v in sorted(w.items()) if k != "shrink_seconds"}
        for w in summary["wedges"]
    ]
    return json.loads(json.dumps(out, sort_keys=True))  # an in-process summary as the CLI prints it


def evolve_bench_less(rec: dict) -> dict:
    """A ``BENCH_evolve.json`` record with ``compiles_per_generation``
    cut to its zero pattern."""
    return dict(rec, compiles_per_generation=[c > 0 for c in rec["compiles_per_generation"]])


def _sweep_alphabet(m, name: str):
    """(alphabet, node count, hunted cause) of one sweep alphabet."""
    if name == "classic":
        return m.srch.Alphabet.classic(), 5, "duel-churn"
    if name == "gray_wan":
        return m.srch.Alphabet.classic(gray=True, wan=True), 5, "gray-region"
    return m.srch.Alphabet.classic().member(), 3, "duel-churn"


def evolve_operator_sweep(m) -> list:
    """The pure operators of ``m``'s ``fleet/evolve`` over seeded draws:
    per alphabet and seed, ``draw_episode``, ``jitter_episode``,
    ``mutate_schedule``, ``crossover_schedules``, ``fresh_schedule``
    without and with a hunt, and one ``select`` of an 8-lane population
    (children and immigrants built as ``_evolve_fleet``/``_evolve_member``
    build them, scores with ties), each as its output dicts, in their JSON
    form."""
    import numpy as np

    cfg = EVOLVE["sweep"]
    evo, srch, fltm = m.evo, m.srch, m.fltm
    out = []
    for ai, name in enumerate(cfg["alphabets"]):
        alphabet, n, hunt = _sweep_alphabet(m, name)
        member = name == "member"
        for seed in range(cfg["seeds"]):
            rng = np.random.default_rng((seed, ai, 23))
            churn = srch.sample_churn_schedule(rng, n) if member else None
            protected = frozenset({0} | srch.churn_targets(churn)) if member else frozenset()
            a, b = alphabet.sample(rng, n), alphabet.sample(rng, n)

            def sched(x):
                return x.to_dict()

            rec = {
                "alphabet": name, "seed": seed,
                "draw": sched(fltm.FaultSchedule((evo.draw_episode(rng, alphabet, n, hunt=hunt),))),
                "jitter": sched(fltm.FaultSchedule(
                    (evo.jitter_episode(rng, a.episodes[0], alphabet.horizon),))),
                "mutate": sched(evo.mutate_schedule(rng, a, alphabet, n, hunt=hunt,
                                                    protected=protected)),
                "crossover": sched(evo.crossover_schedules(rng, a, b, alphabet, n,
                                                           protected=protected)),
                "fresh": sched(evo.fresh_schedule(rng, alphabet, n, protected=protected)),
                "fresh_hunt": sched(evo.fresh_schedule(rng, alphabet, n, hunt=hunt,
                                                       protected=protected)),
            }

            def genome(r):
                ch = srch.sample_churn_schedule(r, n) if member else None
                return evo.Genome(
                    schedule=alphabet.sample(r, n), seed=int(r.integers(0, 1 << 16)),
                    knobs=srch.sample_edge_knobs(r, n, 8) if alphabet.wan else None, churn=ch)

            def child(r, pa, pb):
                s = evo.crossover_schedules(r, pa.schedule, pb.schedule, alphabet, n,
                                            protected=protected)
                s = evo.mutate_schedule(r, s, alphabet, n, hunt=hunt, protected=protected)
                return evo.Genome(schedule=s, seed=pa.seed if int(r.integers(0, 2))
                                  else int(r.integers(0, 1 << 16)), knobs=pa.knobs,
                                  churn=pa.churn)

            def fresh(r):
                return evo.Genome(schedule=evo.fresh_schedule(r, alphabet, n, hunt=hunt,
                                                              protected=protected),
                                  seed=int(r.integers(0, 1 << 16)))

            pop = [genome(rng) for _ in range(cfg["lanes"])]
            scores = [float(x) for x in rng.integers(-2, 3, size=cfg["lanes"])]
            scores[int(rng.integers(0, cfg["lanes"]))] -= evo.WEDGE_BONUS
            nxt = evo.select(rng, pop, scores, child, make_fresh=fresh)
            rec["select"] = [evo._genome_dict(g) for g in nxt]
            rec["select_sha256"] = evo.population_sha(nxt)
            out.append(rec)
    return json.loads(json.dumps(out))  # knob rows as lists, as the goldens file holds them


def _evolve_files(d: str) -> dict:
    """``{name: sha256}`` of the files the run wrote into ``d``."""
    return {n: _file_sha256(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def evolve_axis(m, key: str, **dev) -> dict:
    """18b: one in-process ``evolve`` run of :data:`EVOLVE` ``[key]``, its
    triage files (member counterexamples, serve breach records) written
    into a temporary directory; the summary and the files' sha256."""
    import tempfile

    m.env.clear_cache()
    with tempfile.TemporaryDirectory() as tmp:
        s = m.evo.evolve(verbose=False, triage_dir=tmp if key != "lane_causes" else None,
                         **EVOLVE[key], **dev)
        return {"summary": s, "files": _evolve_files(tmp)}


def _evolve_cli(args: list, tmp: str, env: dict) -> dict:
    """The JAX ``evolve`` CLI run in ``tmp`` with ``env``: exit code,
    stdout and its summary."""
    proc = _jax_module(["tpu_paxos", "evolve", *args, "--quiet"], cwd=tmp, env_extra=env)
    if proc.returncode not in (0, 1):
        raise RuntimeError(f"JAX evolve {args} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "stdout": proc.stdout,
            "summary": json.loads(proc.stdout.strip().splitlines()[-1])}


def _evolve_cli_golden(args: list, env: dict, bench: bool = False) -> dict:
    """One JAX ``evolve`` CLI run (triage into a temporary directory):
    exit code, stdout, the summary less wall fields, and the shrunk
    artifact's sha256 with its ``repro --json`` stdout (the same ``env``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        extra = ["--triage-dir", tmp] + (["--bench-out", os.path.join(tmp, "bench.json")]
                                         if bench else [])
        run = _evolve_cli(args + extra, tmp, env)
        s = run["summary"]
        out = {"rc": run["rc"], "stdout": run["stdout"], "summary": evolve_less(s)}
        if s["artifact"]:
            text = repro_stdout(s["artifact"], env)
            out.update(artifact_sha256=_file_sha256(s["artifact"]), repro_stdout=text)
        if bench:
            with open(os.path.join(tmp, "bench.json")) as f:
                out["bench"] = f.read()
    return out


def evolve_goldens() -> dict:
    """Every phase-18 golden, from the JAX package on the CPU."""
    m = evolve_modules(port=False)
    out = {"config": EVOLVE}
    out["quick"] = _evolve_cli_golden(EVOLVE["quick"], {})
    for key in ("member", "serve", "lane_causes"):
        run = evolve_axis(m, key)
        out[key] = {"summary": evolve_less(run["summary"]), "files": run["files"]}
    out["wide"] = _evolve_cli_golden(EVOLVE["wide"], {})
    out["certified"] = _evolve_cli_golden(
        EVOLVE["certified"], {"TPU_PAXOS_SEEDED_WEDGE": EVOLVE["wedge"]}, bench=True)
    out["sweep"] = evolve_operator_sweep(m)
    return out


# ---------------------------------------------------------------- phase 19

#: Ranks of phase 19's meshes (JAX: the 8 virtual CPU devices).
SHARDED_DEVICES = 8
#: The parity matrix's meshes: D ranks on ("i",), or HxC on ("dcn", "i").
SHARDED_MESHES = ("1", "2", "4", "8", "2x4")
#: The committed sharded artifact, written beside the goldens file.
SHARDED_ARTIFACT = "repro_sharded_d8.json"
SHARDED_CLI = ["4", "4", "10", "--seed=0", "--net-drop-rate=500", "--net-dup-rate=1000",
               "--net-max-delay=2", "--mesh", "8"]
SHARDED_FAST_CLI = ["5", "8192", "1024", "--engine=fast", "--mesh", "8", "--json"]
#: The (mix, seed) of the sharded stress sweep that the CPU tests hold.
STRESS_SHARDED_ONE = ("partition-flap", 0)
SHARDED_ARRAYS = ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs")


def sharded_modules(port: bool):
    """The sharded engines' modules of one package: the port's
    (``port=True``; ``chip_smoke.py`` and the CPU tests drive these) or
    the JAX package's (run under 8 virtual CPU devices)."""
    import types

    if port:
        from tpu_paxos_torch import config as cfgm
        from tpu_paxos_torch.core import faults
        from tpu_paxos_torch.harness import shrink, stress
        from tpu_paxos_torch.parallel import mesh, sharded, sharded_sim
        from tpu_paxos_torch.replay.decision_log import decision_log
    else:
        from tpu_paxos import config as cfgm
        from tpu_paxos.core import faults
        from tpu_paxos.harness import shrink, stress
        from tpu_paxos.parallel import mesh, sharded, sharded_sim
        from tpu_paxos.replay.decision_log import decision_log
    return types.SimpleNamespace(port=port, cfgm=cfgm, flt=faults, mesh=mesh, sharded=sharded,
                                 ss=sharded_sim, stress=stress, shr=shrink,
                                 decision_log=decision_log)


def sharded_mesh(m, spec: str, **dev):
    """The mesh ``spec`` names: ``"D"`` ranks on ``("i",)``, ``"HxC"`` on
    ``("dcn", "i")``; ``dev`` (the port's ``device=``) places the port's
    ranks."""
    if "x" in spec:
        h, c = (int(x) for x in spec.split("x"))
        return m.mesh.make_instance_mesh(h * c, dcn_hosts=h, **dev)
    return m.mesh.make_instance_mesh(int(spec), **dev)


def sharded_cases(m) -> dict:
    """The parity matrix's configurations (``tests/test_sharded_sim.py``'s
    fault-free, reference-fault, crash and cross-shard gate cases at 128
    instances): name -> (cfg, workload, gates)."""
    import numpy as np

    C = m.cfgm
    ref = {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2}
    base = {"n_nodes": 5, "n_instances": 128, "proposers": (0, 1)}
    inorder = np.asarray([10, 11, 12, 13], np.int32)
    gates = [np.asarray([-1, 10, 11, 12], np.int32), np.zeros((0,), np.int32)]
    free = np.arange(100, 140, dtype=np.int32)
    return {
        "fault_free": (C.SimConfig(**base, seed=0), None, None),
        "reference": (C.SimConfig(**base, seed=1, faults=C.FaultConfig(**ref)), None, None),
        "crashes": (C.SimConfig(**base, seed=5, max_rounds=4000,
                                faults=C.FaultConfig(**ref, crash_rate=3000)), None, None),
        "gates": (C.SimConfig(**base, seed=2, faults=C.FaultConfig(**ref)), [inorder, free], gates),
    }


def array_sha256(x) -> str:
    """sha256 of an integer or bool array as little-endian int32."""
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(np.asarray(x), dtype="<i4").tobytes()).hexdigest()


def sharded_record(m, cfg, workload, res) -> dict:
    """One sharded run's result: rounds, ``done``, the chosen count, the
    decision-log sha256 (stride: the default workload's, or one past the
    largest vid) and the sha256 of every SimResult array."""
    import numpy as np

    stride = (max(cfg.n_instances, 1024) if workload is None
              else int(max(int(np.max(w)) for w in workload if len(w))) + 1)
    log = m.decision_log(res.chosen_vid, res.chosen_ballot, stride, cfg.n_instances)
    return {
        "rounds": int(res.rounds), "done": bool(res.done),
        "chosen": int((np.asarray(res.chosen_vid) != -1).sum()),
        "decision_log_sha256": hashlib.sha256(log.encode()).hexdigest(),
        "arrays": {f: array_sha256(getattr(res, f)) for f in SHARDED_ARRAYS},
    }


def sharded_parity(m, **dev) -> dict:
    """Every parity case on every mesh of :data:`SHARDED_MESHES`."""
    out = {}
    for name, (cfg, wl, gates) in sharded_cases(m).items():
        for spec in SHARDED_MESHES:
            res = m.ss.run_sharded(cfg, sharded_mesh(m, spec, **dev), wl, gates)
            out[f"{name}@{spec}"] = sharded_record(m, cfg, wl, res)
    return out


def sharded_sim_config(n_instances: int = 1 << 20, n_dev: int = SHARDED_DEVICES) -> dict:
    """``bench.py``'s sharded general-engine record configuration."""
    return {
        "n_nodes": 7, "n_instances": n_instances, "proposers": [0, 1], "seed": 0,
        "assign_window": max(256, min(1 << 14, n_instances // (8 * n_dev))),
        "max_rounds": 20_000,
        "faults": {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2},
    }


def sharded_sim_cfg(m, bc: dict):
    C = m.cfgm
    return C.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"], proposers=tuple(bc["proposers"]),
        seed=bc["seed"], assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=C.FaultConfig(**bc["faults"]),
    )


def sharded_sim_golden(m, bc: dict, spec: str, **dev) -> dict:
    """The sharded general engine at ``bc`` on mesh ``spec``: the run's
    record plus its chosen-round sha256, mesh and config."""
    cfg = sharded_sim_cfg(m, bc)
    res = m.ss.run_sharded(cfg, sharded_mesh(m, spec, **dev))
    out = sharded_record(m, cfg, None, res)
    out.update(chosen_round_sha256=chosen_round_sha256(res.chosen_round), mesh=spec, config=bc,
               stride=max(cfg.n_instances, 1024))
    return out


def sharded_fast_golden(m, n_instances: int, n_nodes: int, spec: str, **dev) -> dict:
    """``sharded_choose_all`` (proposer 0) over ``n_instances`` iota vids
    on mesh ``spec``: ``n_chosen`` and the sha256 of every global
    FastState field."""
    import numpy as np

    mesh = sharded_mesh(m, spec, **dev)
    vids = np.arange(n_instances, dtype=np.int32)
    quorum = n_nodes // 2 + 1
    state = m.sharded.init_sharded_state(mesh, n_instances, n_nodes)
    step = m.sharded.sharded_choose_all(mesh, proposer=0, quorum=quorum)
    if m.port:
        state, n = step(state, m.mesh.shard_instances(mesh, vids))
        glob = m.sharded.gather_state(state)
    else:
        import jax.numpy as jnp

        state, n = step(state, m.mesh.shard_instances(mesh, jnp.asarray(vids)))
        glob = state
    return {"n_instances": n_instances, "n_nodes": n_nodes, "mesh": spec, "n_chosen": int(n),
            "fields": {f: array_sha256(np.asarray(getattr(glob, f))) for f in glob._fields}}


def stress_sharded_case(m, label: str, seed: int, n_shards: int = SHARDED_DEVICES):
    """One (mix, seed) of the sharded stress sweep as its loop builds it:
    ``(cfg, workload, gates, chains)``."""
    import zlib

    import numpy as np

    mixes = {mx[0]: mx for mx in (m.stress.MIXES[1], m.stress.MIXES[4], *m.stress.EPISODE_MIXES)}
    _, fkw, n_nodes, n_prop = mixes[label]
    rng = np.random.default_rng(seed * 7919 + zlib.crc32(label.encode()) % 1000)
    workload, gates, chains = m.stress._workload(n_prop, rng)
    n_inst = 2 * sum(len(w) for w in workload)
    n_inst = max(n_inst + (-n_inst) % n_shards, m.ss.min_instances(workload, gates, n_shards))
    cfg = m.cfgm.SimConfig(n_nodes=n_nodes, n_instances=n_inst, proposers=tuple(range(n_prop)),
                           seed=seed, max_rounds=20_000, faults=m.cfgm.FaultConfig(**fkw))
    return cfg, workload, gates, chains


def stress_sharded_one(m, **dev) -> dict:
    """:data:`STRESS_SHARDED_ONE`'s run on the 8-rank mesh: its record and
    the crash-aware suite's verdict (None: green)."""
    label, seed = STRESS_SHARDED_ONE
    cfg, wl, gates, chains = stress_sharded_case(m, label, seed)
    res = m.ss.run_sharded(cfg, sharded_mesh(m, str(SHARDED_DEVICES), **dev), wl, gates)
    try:
        m.stress._check_run(res, cfg, wl, chains)
        verdict = None
    except Exception as e:  # noqa: BLE001 - the verdict is the record
        verdict = str(e)[:300]
    return {"mix": label, "seed": seed, "n_instances": cfg.n_instances, "verdict": verdict,
            **sharded_record(m, cfg, wl, res)}


def sharded_repro_case(m, devices: int = SHARDED_DEVICES):
    """``tests/test_sharded_repro.py``'s case at ``devices`` shards: a
    partition of node 0 delays decisions past ``decision_round_max``."""
    import numpy as np

    C, flt = m.cfgm, m.flt
    sched = flt.FaultSchedule((flt.partition(4, 24, (0,), (1, 2)),))
    wl = [np.arange(100, 108, dtype=np.int32), np.arange(200, 208, dtype=np.int32)]
    cfg = C.SimConfig(n_nodes=3, n_instances=64, proposers=(0, 1), seed=7, max_rounds=4000,
                      faults=C.FaultConfig(drop_rate=300, dup_rate=500, max_delay=2,
                                           schedule=sched))
    return m.shr.ReproCase(cfg=cfg, workload=wl, gates=None,
                           chains=[np.zeros(0, np.int32)] * 2,
                           extra_checks={"decision_round_max": 25}, engine="sharded",
                           devices=devices)


def sharded_goldens(out_dir: str) -> dict:
    """Phase 19's goldens (JAX on 8 virtual CPU devices): the parity
    matrix, the 2**20 general engine at D=8 and on (2, 4), the fast path
    at 10M on (2, 4), the two ``--mesh 8`` CLIs, the committed sharded
    artifact (written to ``out_dir``) with its ``repro --json`` stdout,
    and the sharded stress sweep's summary (less ``seconds`` and
    ``platform``) with one of its runs."""
    m = sharded_modules(port=False)
    art = os.path.join(out_dir, SHARDED_ARTIFACT)
    case = sharded_repro_case(m)
    _, viol = m.shr.run_case(case)
    m.shr.save_artifact(art, case, viol)
    rstdout = repro_stdout(art, {})
    bc = sharded_sim_config()
    sweep = m.stress.sweep_sharded(n_seeds=2, verbose=False)
    return {
        "sharded_parity": sharded_parity(m),
        "sharded_sim_2p20_d8": sharded_sim_golden(m, bc, str(SHARDED_DEVICES)),
        "sharded_sim_2p20_2x4": sharded_sim_golden(m, bc, "2x4"),
        "sharded_fast": sharded_fast_golden(m, 10_000_000, 7, "2x4"),
        "cli_4_4_10_mesh8": {"args": SHARDED_CLI, "stdout": _fast_cli_stdout(SHARDED_CLI)},
        "fast_cli_2p23_mesh8": {"args": SHARDED_FAST_CLI,
                                "stdout": _fast_cli_stdout(SHARDED_FAST_CLI)},
        "sharded_repro": {"artifact": SHARDED_ARTIFACT, "violation": viol,
                          "artifact_sha256": _file_sha256(art), "stdout": rstdout},
        "stress_sharded": {"summary": {k: v for k, v in sweep.items()
                                       if k not in ("seconds", "platform")},
                           "one": stress_sharded_one(m)},
    }


def provision_cpu_devices(n: int = SHARDED_DEVICES) -> None:
    """Give JAX ``n`` virtual CPU devices, before its backend starts (as
    ``tests/conftest.py`` does): the sharded goldens run on them, and
    nothing unsharded depends on the device count."""
    import jax

    # paxlint: allow[DET004] platform selection, value-neutral
    jax.config.update("jax_platforms", "cpu")
    try:
        # paxlint: allow[DET004] device provisioning, value-neutral
        jax.config.update("jax_num_cpu_devices", n)
    except AttributeError:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={n}"
        )


#: the library phase's equivalent-sim seeds (``run_equivalent_sim(4, 4, 10)``)
EQUIVALENT_SEEDS = (0, 1, 2)


def status_vids(res) -> list:
    """Three vids to ask ``value_status``: the real value decided first, a
    no-op the run chose (a sentinel: ``pending``) or the base no-op vid,
    and a vid never proposed (``pending``)."""
    import numpy as np

    cv = np.asarray(res.chosen_vid)
    noops = cv[cv <= -2]
    return [int(cv[np.flatnonzero(cv >= 0)[0]]), int(noops[0]) if noops.size else -2,
            int(np.asarray(res.expected_vids).max()) + 1]


#: the sentinel and unknown vids ``value_status`` is also asked on the CLI run
STATUS_EXTRA_VIDS = (-1, -2, -7, 10_000)


def library_status(res, vids=None) -> dict:
    """``rounds_to_chosen`` and ``value_status`` of ``vids`` (default:
    :func:`status_vids`)."""
    from tpu_paxos_torch.core.sim import rounds_to_chosen_digest

    return {"rounds_to_chosen": rounds_to_chosen_digest(res.rounds_to_chosen),
            "value_status": [[v, res.value_status(v)]
                             for v in (status_vids(res) if vids is None else vids)]}


def example_stdout(name: str) -> str:
    """Stdout of the JAX example ``examples/<name>.py`` on one CPU device,
    run as ``tests/test_examples.py`` runs it."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, runpy, jax; jax.config.update('jax_platforms', "
         "'cpu'); runpy.run_path(sys.argv[1], run_name='__main__')",
         os.path.join(root, "examples", f"{name}.py")],
        cwd=root, env=env, capture_output=True, text=True, timeout=900, check=True)
    return proc.stdout


def library_goldens() -> dict:
    """Phase 22 of ``chip_smoke.py`` (the library surface): ``bench_sim``'s
    ``rounds_to_chosen`` and three ``value_status`` answers; the same on
    ``cli_4_4_10`` for every vid (the CPU tests' golden); ``run_equivalent_sim(4, 4, 10, seed)`` for each seed
    of :data:`EQUIVALENT_SEEDS` (rounds, ``done`` and the sha256 of every
    SimResult array); and each JAX example's stdout."""
    from tpu_paxos import config as cfgm
    from tpu_paxos.core import sim
    from tpu_paxos.harness import reference_runner as refr
    from tpu_paxos_torch.examples import TWINS

    bc = bench_sim_config()
    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**bc["faults"]),
    )
    bench = library_status(sim.run(cfg))
    srv, clt, ids = CLI_ARGS
    workload, gates, _ = refr.equivalent_workload(srv, clt, ids)
    ccfg = cfgm.SimConfig(n_nodes=srv, n_instances=clt * ids * 2, proposers=tuple(range(srv)),
                          seed=0, faults=cfgm.FaultConfig(**CLI_FAULTS))
    cres = sim.run(ccfg, workload, gates)
    equivalent = {}
    for seed in EQUIVALENT_SEEDS:
        res, _ = refr.run_equivalent_sim(srv, clt, ids, seed=seed)
        equivalent[str(seed)] = {"rounds": int(res.rounds), "done": bool(res.done),
                                 "arrays": {f: array_sha256(getattr(res, f))
                                            for f in SHARDED_ARRAYS}}
    return {
        "bench_sim": bench,
        "cli_4_4_10": library_status(cres, sorted(int(v) for v in cres.expected_vids)
                                     + list(STATUS_EXTRA_VIDS)),
        "equivalent_sim": {"args": CLI_ARGS, "seeds": list(EQUIVALENT_SEEDS),
                           "runs": equivalent},
        "examples": {name: example_stdout(name) for name in sorted(TWINS.values())},
    }


#: the port's CPU test files whose JAX side is committed (``tests.<part>``)
TEST_GOLDENS = ("cli", "search", "shrink")


def tests_goldens(parts=TEST_GOLDENS) -> dict:
    """``tests``: JAX's side of the heaviest CPU test files, each
    ``tests/test_torch_<part>.py``'s ``jax_goldens(tmp)``, so that tier 1
    holds the port to JAX without rerunning JAX (those files' slow tier
    recomputes their entry)."""
    import importlib.util
    import tempfile

    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
    sys.path.insert(0, tests)
    out = {}
    for part in parts:
        name = f"test_torch_{part}"
        spec = importlib.util.spec_from_file_location(name, os.path.join(tests, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with tempfile.TemporaryDirectory() as tmp:
            out[part] = json.loads(json.dumps(mod.jax_goldens(tmp), sort_keys=True))
    return out


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
        out["member"] = member_goldens()
        out["serve"] = serve_goldens()
        out["control"] = control_goldens()
        out["mc"] = mc_goldens()
        out["evolve"] = evolve_goldens()
        out.update(sharded_goldens(path))
        out["library"] = library_goldens()
        out["tests"] = tests_goldens()

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
    ap.add_argument("--member-only", action="store_true",
                    help="recompute only the member entry of the --write file")
    ap.add_argument("--control-only", action="store_true",
                    help="recompute only the control entry (phase 16) of the --write file")
    ap.add_argument("--mc-only", action="store_true",
                    help="recompute only the mc entry (phase 17) of the --write file")
    ap.add_argument("--evolve-only", action="store_true",
                    help="recompute only the evolve entry (phase 18) of the --write file")
    ap.add_argument("--sharded-only", action="store_true",
                    help="recompute only the sharded entries (phase 19) of the --write file "
                    "and rewrite the committed sharded artifact beside it")
    ap.add_argument("--tests-only", nargs="*", default=None, choices=TEST_GOLDENS,
                    help="recompute only the tests entry (all of it, or the parts named) "
                    "of the --write file")
    ap.add_argument("--library-only", action="store_true",
                    help="recompute only the library entry (phase 22) of the --write file")
    ap.add_argument("--serve-only", action="store_true",
                    help="recompute only the serve entry (phase 15) and the host-loop "
                    "half of the stress_fleet entry of the --write file")
    for part in ("search", "stress-fleet", "envelope"):
        ap.add_argument(f"--{part}-only", action="store_true",
                        help=f"recompute only the {part.replace('-', '_')} entry of the "
                        "--write file")
    args = ap.parse_args(argv)
    provision_cpu_devices()
    out_dir = os.path.dirname(os.path.abspath(args.write or "goldens.json"))
    p13 = tuple(p for p in ("search", "stress_fleet", "envelope") if getattr(args, f"{p}_only"))
    if (args.fleet_only or args.triage_only is not None or args.telemetry_only or p13
            or args.member_only or args.serve_only or args.control_only or args.mc_only
            or args.evolve_only or args.sharded_only or args.library_only
            or args.tests_only is not None):
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
        if args.member_only:
            out["member"] = member_goldens()
        if args.serve_only:
            out["serve"] = serve_goldens()
            out["stress_fleet"].update(host_seeds=STRESS_HOST_SEEDS, host=stress_host_golden())
        if args.control_only:
            out["control"] = control_goldens()
        if args.mc_only:
            out["mc"] = mc_goldens()
        if args.evolve_only:
            out["evolve"] = evolve_goldens()
        if args.sharded_only:
            out.update(sharded_goldens(out_dir))
        if args.library_only:
            out["library"] = library_goldens()
        if args.tests_only is not None:
            out.setdefault("tests", {}).update(tests_goldens(tuple(args.tests_only) or TEST_GOLDENS))
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
