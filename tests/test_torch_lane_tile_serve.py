"""The port's lane tile on the serving paths and the tiled CLIs, on the
CPU: the shard certificate's ``serve.fleet_window`` driver at D = 1, 2,
4, 8 and on the (2, 4) mesh equals ``shard_certificate.json``; the
controlled fleet and sweep on a 2-rank tile equal the untiled port and
JAX's untiled runs (``tests/test_shard_audit.py``'s mesh-reshape parity,
which jax 0.9.0 cannot run on its own tile); the evolve serve axis on
a tile its weather groups fill equals JAX's golden, and raises the
tile's error on one they do not; ``fleet --mesh``
pads the lane count as JAX's CLI does and prints JAX's summary; ``serve
--fleet --mesh --dcn-hosts`` prints JAX's.  The slow tier mirrors
``tests/test_serve_fleet.py::test_mesh_tile_bitwise_parity``.
"""

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch import interop
from tpu_paxos_torch.analysis import shard_audit
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
SHAPES = [pytest.param(s, id=shard_audit.shape_name(s)) for s in shard_audit.SHAPES]


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", SHAPES)
def test_serve_window_driver_equals_the_certificate(shape):
    got = shard_audit.drivers()["serve.fleet_window"](shape[0], dcn_hosts=shape[1],
                                                      device="cpu")
    assert got == shard_audit.load_certificate()["entries"]["serve.fleet_window"]


# ---------------- the controlled fleet's mesh-reshape parity ----------------

_GEOM = dict(rounds_per_window=8, windows_per_dispatch=2, window_rounds=32)


def _mods(port: bool):
    if port:
        from tpu_paxos_torch import config as cfgm
        from tpu_paxos_torch.replay.decision_log import decision_log
        from tpu_paxos_torch.serve import control as ctlm
        from tpu_paxos_torch.serve import fleet as sfl
        from tpu_paxos_torch.serve import harness as sh
    else:
        from tpu_paxos import config as cfgm
        from tpu_paxos.replay.decision_log import decision_log
        from tpu_paxos.serve import control as ctlm
        from tpu_paxos.serve import fleet as sfl
        from tpu_paxos.serve import harness as sh
    cfg = cfgm.SimConfig(n_nodes=3, n_instances=48, proposers=(0, 1), seed=3, max_rounds=4000,
                         faults=cfgm.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2))
    return cfg, decision_log, ctlm, sfl, sh.ServeSLO(latency_rounds=128, budget_milli=150)


def _lane_shas(rep, decision_log):
    out = []
    for i in range(rep.n_lanes):
        cv, cb = rep.lane_chosen(i)
        out.append(hashlib.sha256(
            decision_log(cv, cb, stride=30, n_instances=len(cv)).encode()).hexdigest())
    return out


def _point_key(pt):
    return (pt["rate_milli"], pt["lanes"], pt["decided"], pt["backlog"], pt["done"],
            pt["rounds"], pt["dispatches"], pt["sustained"], pt["p50"], pt["p99"],
            tuple(pt["breach_lanes"]), pt["shed"], tuple(pt["lane_shed"]),
            pt["control_decisions"])


def _controlled_grid(port: bool, mesh, n_values, lane_counts, rates):
    """Every (lanes x rate) cell's controlled fleet run and the
    controlled sweep of the grid, in comparable form."""
    cfg, decision_log, ctlm, sfl, slo = _mods(port)
    dev = {"device": "cpu"} if port else {}
    width = max(10, sfl.grid_admit_width(cfg, n_values, lane_counts, rates, rounds_per_window=8))
    cells = []
    for lc in lane_counts:
        for rm in rates:
            rep = ctlm.controlled_fleet_run(
                cfg, sfl.fleet_lanes(cfg, lc, n_values, rm, 0), control=ctlm.ControlPolicy(),
                admit_width=width, mesh=mesh, slo=slo, **_GEOM, **dev)
            cells.append((_lane_shas(rep, decision_log), list(map(int, rep.decided)),
                          list(map(bool, rep.breach)), rep.shed_total, rep.lane_shed,
                          len(rep.decisions)))
    sweep = sfl.sweep_fleet_load(cfg, n_values, lane_counts, rates, admit_width=width,
                                 control=ctlm.ControlPolicy(), mesh=mesh, slo=slo, **_GEOM, **dev)
    points = {lc: [_point_key(p) for p in sweep["cells"][str(lc)]["points"]]
              for lc in lane_counts}
    return cells, points, sfl.sweep_verdict(sweep)


def _reshape_parity(n_values, lane_counts, rates):
    jax_untiled = _controlled_grid(False, None, n_values, lane_counts, rates)
    port_untiled = _controlled_grid(True, None, n_values, lane_counts, rates)
    port_tiled = _controlled_grid(True, pmesh.make_instance_mesh(2, device="cpu"),
                                  n_values, lane_counts, rates)
    assert port_tiled == port_untiled == jax_untiled


def test_controlled_sweep_mesh_reshape_parity_fast():
    """``test_serve_sweep_mesh_reshape_parity_fast``'s one cell: the port's
    2-rank tile equals the port untiled and JAX untiled (JAX's own tile
    raises ``ShardingTypeError`` under jax 0.9.0)."""
    _reshape_parity(12, (2,), (4000,))


@pytest.mark.slow
def test_controlled_sweep_mesh_reshape_parity_full_grid():
    _reshape_parity(24, (2, 4), (2000, 4000))


@pytest.mark.slow
def test_serve_fleet_tile_bitwise_parity():
    """``tests/test_serve_fleet.py::test_mesh_tile_bitwise_parity``: the
    2-rank tile equals the untiled fleet leaf for leaf, and both equal
    JAX's untiled fleet; a lane count that does not tile is refused."""
    from test_torch_serve_fleet import ADMIT_W, R_WINDOW, S_DISPATCH, _cfgs, _lane_at_rate

    from tpu_paxos.serve import fleet as jfl
    from tpu_paxos.serve import harness as jh
    from tpu_paxos_torch.serve import fleet as tfl
    from tpu_paxos_torch.serve import harness as th

    jc, tc = _cfgs()
    kw = dict(rounds_per_window=R_WINDOW, windows_per_dispatch=S_DISPATCH, admit_width=ADMIT_W)
    lanes = [_lane_at_rate(1500, 7, 3), _lane_at_rate(4000, 8, 4)]
    jrep = jfl.serve_fleet_run(jc, [jfl.ServeLane(*ln) for ln in lanes],
                               slo=jh.ServeSLO(latency_rounds=16, budget_milli=400), **kw)
    tlanes = [tfl.ServeLane(*ln) for ln in lanes]
    slo = th.ServeSLO(latency_rounds=16, budget_milli=400)
    mesh = pmesh.make_instance_mesh(2, device="cpu")
    reps = [tfl.serve_fleet_run(tc, tlanes, slo=slo, mesh=m, device="cpu", **kw)
            for m in (None, mesh)]
    jfinal = interop.lanes_to_numpy(jrep.final)
    for rep in reps:
        assert interop.first_lane_difference(interop.lanes_to_numpy(rep.final), jfinal) is None
        assert list(rep.breach) == list(jrep.breach)
        assert list(rep.decided) == list(jrep.decided)
    with pytest.raises(ValueError, match="tile"):
        tfl.serve_fleet_run(tc, tlanes[:1], slo=slo, mesh=mesh, device="cpu", **kw)


# ---------------- the selection loop's serve axis ----------------


def test_evolve_serve_axis_on_the_tile_equals_jax():
    """The serve axis with a mesh: as JAX's ``evolve``, the port runs the
    serve axis untiled whatever the mesh, so on a 2-rank mesh and on a
    4-rank mesh (whose ranks a preset's 2 lanes do not tile) the summary
    and triage files equal JAX's golden (18b)."""
    script = _script()
    gold = _goldens()["evolve"]["serve"]
    m = script.evolve_modules(port=True)
    for n in (2, 4):
        got = script.evolve_axis(m, "serve", device="cpu",
                                 mesh=pmesh.make_instance_mesh(n, device="cpu"))
        assert script.evolve_less(got["summary"]) == gold["summary"], n
        assert got["files"] == gold["files"], n
    tenv.clear_cache()


def test_evolve_member_axis_on_an_untiling_mesh_equals_jax():
    """The member axis's 4 lanes on a 3-rank mesh, which they do not
    tile: the axis runs untiled, as JAX's, and its summary and triage
    files equal JAX's golden (18b)."""
    script = _script()
    gold = _goldens()["evolve"]["member"]
    m = script.evolve_modules(port=True)
    got = script.evolve_axis(m, "member", device="cpu",
                             mesh=pmesh.make_instance_mesh(3, device="cpu"))
    assert script.evolve_less(got["summary"]) == gold["summary"]
    assert got["files"] == gold["files"]
    tenv.clear_cache()


# ---------------- the tiled CLIs ----------------


def test_fleet_cli_pads_lanes_to_the_tile_and_prints_jax_summary(tmp_path, capsys,
                                                                  monkeypatch):
    """``fleet --lanes 5 --mesh 4`` runs 8 lanes, as JAX's CLI pads them:
    fleet-quick's summary less the wall fields (JAX's tiled and untiled
    CLIs print the same under jax 0.9.0) and its artifact's bytes."""
    gold = _goldens()["search"]["fleet_quick"]
    args = list(gold["args"])
    args[args.index("--lanes") + 1] = "5"
    tenv.clear_cache()
    monkeypatch.chdir(str(tmp_path))
    rc = tcli.main(["fleet", *args, "--mesh", "4", "--triage-dir", str(tmp_path), "--quiet",
                    "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and got["lanes"] == 8
    for k in ("seconds", "lanes_per_sec"):
        got.pop(k)
    for w in got["wedges"]:
        w.pop("shrink_seconds", None)
        path = w.pop("artifact")
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == gold["artifact_sha256"]
    want = json.loads(json.dumps(gold["summary"]))
    for w in want["wedges"]:
        w.pop("artifact", None)
    assert got == want
    tenv.clear_cache()


def test_serve_fleet_cli_on_a_2x2_mesh_prints_jax_summary(capsys):
    """``serve --fleet --lanes 8 --mesh 4 --dcn-hosts 2``: the (2, 2) tile
    prints JAX's ``serve --fleet --lanes 8`` summary less the wall
    fields; ``--lanes 6 --mesh 4`` is refused by JAX's name."""
    script = _script()
    gold = _goldens()["serve"]["cli"]["serve --fleet --lanes 8"]
    assert tcli.main(["serve", "--fleet", "--lanes", "8", "--mesh", "4", "--dcn-hosts", "2",
                      "--device", "cpu"]) == gold["rc"]
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert script.less_wall(got) == gold["summary"]
    with pytest.raises(ValueError, match="^6 lanes do not tile over 4 devices$"):
        tcli.main(["serve", "--fleet", "--lanes", "6", "--mesh", "4", "--device", "cpu"])
    assert np.isfinite(got["wall_seconds"])
