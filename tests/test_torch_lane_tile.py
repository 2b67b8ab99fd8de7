"""The port's lane tile (a fleet's lane axis split over a mesh's ranks)
against the JAX package, on the CPU: the shard certificate's
``fleet.run_lanes``, ``fleet.run_lanes_envelope`` and
``member.fleet_lanes`` drivers at D = 1, 2, 4, 8 and on the (2, 4) mesh
equal ``tpu_paxos/analysis/shard_certificate.json`` byte for byte; the
port's tiled ``FleetRunner`` at D = 2 equals JAX's tiled ``FleetRunner``
(tests/test_fleet.py's 8 lanes) leaf for leaf; the tiled member fleet
equals JAX's untiled one; the envelope cache keys on the mesh; a lane
count that does not tile is refused by name and a failing rank raises
through ``RankError``.  The serve side is tests/test_torch_lane_tile_serve.py.
"""

import json
import os

import numpy as np
import pytest

from tpu_paxos_torch import interop
from tpu_paxos_torch.analysis import shard_audit
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.fleet import member_runner as tmr
from tpu_paxos_torch.fleet import runner as trun
from tpu_paxos_torch.parallel import mesh as pmesh
from tpu_paxos_torch.replay.decision_log import decision_log, sha256

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CERT = os.path.join(ROOT, "tpu_paxos", "analysis", "shard_certificate.json")
SHAPES = [pytest.param(s, id=shard_audit.shape_name(s)) for s in shard_audit.SHAPES]


def _cert():
    with open(JAX_CERT) as f:
        return json.load(f)["entries"]


def test_certificate_is_a_byte_copy_of_jax():
    with open(JAX_CERT, "rb") as f, open(shard_audit.DEFAULT_CERT, "rb") as g:
        assert f.read() == g.read()
    assert sorted(shard_audit.drivers()) == sorted(_cert())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("entry", ["fleet.run_lanes", "fleet.run_lanes_envelope",
                                   "member.fleet_lanes"])
def test_lane_drivers_equal_the_certificate(entry, shape):
    """Each driver on each mesh shape equals JAX's pinned one-device
    record: verdict nibbles and every lane's decision-log sha256."""
    got = shard_audit.drivers()[entry](shape[0], dcn_hosts=shape[1], device="cpu")
    assert got == _cert()[entry]


def test_check_certificate_names_the_first_diverging_lane(tmp_path):
    """A certificate that differs at lane 3 fails naming (entry, mesh,
    lane), as JAX's audit reports it; the committed one passes."""
    entries = ["member.fleet_lanes"]
    shapes = ((2, 1),)
    results = {}
    assert shard_audit.check_certificate(shapes, device="cpu", entries=entries,
                                         results=results) == []
    assert results == {"member.fleet_lanes": {"2": _cert()["member.fleet_lanes"]}}
    cert = json.loads(open(shard_audit.DEFAULT_CERT).read())
    logs = cert["entries"]["member.fleet_lanes"]["lane_logs"]
    logs[3] = "0" * 64
    path = tmp_path / "cert.json"
    path.write_text(json.dumps(cert))
    fails = shard_audit.check_certificate(shapes, device="cpu", entries=entries, path=str(path))
    assert [(f["entry"], f["mesh"], f["lane"]) for f in fails] == [("member.fleet_lanes", "2", 3)]
    assert "decision-log sha256" in fails[0]["detail"]


# ---------------- the tiled fleet runner against JAX's ----------------


@pytest.fixture(scope="module")
def jax_tiled():
    """tests/test_fleet.py's 8-lane dispatch on JAX's 2-device tile (the
    conftest's virtual CPU devices), its leaves converted whole."""
    from test_torch_fleet import LANES, SCHEDS, WL, _cfg

    from tpu_paxos import config as jcfg
    from tpu_paxos.core import faults as jflt
    from tpu_paxos.fleet import runner as jrun
    from tpu_paxos.parallel import mesh as jpmesh

    mesh = jpmesh.make_instance_mesh(2)
    assert mesh.size == 2
    rep = jrun.FleetRunner(_cfg(jcfg), WL, mesh=mesh).run(
        [s for _, s in LANES], [SCHEDS[k](jflt) for k, _ in LANES])
    return rep.verdict, interop.lanes_to_numpy(rep.final)


def test_tiled_fleet_runner_equals_jax_tiled(jax_tiled):
    """The port's 2-rank tile equals JAX's 2-device tile leaf for leaf and
    verdict for verdict (tests/test_fleet.py's
    ``test_mesh_tile_bitwise_parity``); lanes that do not tile are refused
    by JAX's name."""
    from test_torch_fleet import LANES, SCHEDS, WL, _cfg

    from tpu_paxos_torch import config as tcfg
    from tpu_paxos_torch.core import faults as tflt

    jv, jfinal = jax_tiled
    runner = trun.FleetRunner(_cfg(tcfg), WL, mesh=pmesh.make_instance_mesh(2, device="cpu"),
                              device="cpu")
    rep = runner.run([s for _, s in LANES], [SCHEDS[k](tflt) for k, _ in LANES])
    assert len(rep.rank_iterations) == 2
    for f in jv._fields:
        assert np.asarray(getattr(rep.verdict, f)).tolist() == np.asarray(getattr(jv, f)).tolist(), f
    assert interop.first_lane_difference(interop.lanes_to_numpy(rep.final), jfinal) is None
    with pytest.raises(ValueError, match="^1 lanes do not tile over 2 devices$"):
        runner.run([0], [None])


def test_tiled_runner_equals_untiled_with_telemetry():
    """An armed (recorder) runner on a 4-rank tile equals the untiled
    one: states, verdicts, summaries and windows, lane for lane."""
    cfg = trun._audit_cfg()
    wl = trun.simm.default_workload(cfg)
    scheds = trun._audit_scheds(8)
    reps = [trun.FleetRunner(cfg, wl, max_episodes=2, telemetry=True, mesh=m,
                             device="cpu").run(list(range(8)), scheds)
            for m in (None, pmesh.make_instance_mesh(4, device="cpu"))]
    a, b = (interop.lanes_to_numpy((r.final, r.verdict, r.telemetry, r.windows)) for r in reps)
    assert interop.first_lane_difference(a, b) is None
    assert reps[1].iterations == max(reps[1].rank_iterations)


def test_member_fleet_tile_equals_jax_untiled():
    """tests/test_torch_member_fleet.py's 8-lane mixed grid on a 4-rank
    tile equals JAX's untiled member fleet: states, verdicts and decision
    logs."""
    from test_torch_member_fleet import ENV, I, N, _lanes

    from tpu_paxos.core import faults as jflt
    from tpu_paxos.fleet import member_runner as jmr
    from tpu_paxos.membership import churn_table as jct
    from tpu_paxos_torch.core import faults as tflt
    from tpu_paxos_torch.membership import churn_table as tct

    jrep = jmr.MemberFleetRunner(N, I, **ENV).run(*_lanes(jct, jflt))
    mesh = pmesh.make_instance_mesh(4, device="cpu")
    trep = tmr.MemberFleetRunner(N, I, **ENV, mesh=mesh, device="cpu").run(*_lanes(tct, tflt))
    assert interop.first_lane_difference(interop.lanes_to_numpy(trep.final),
                                         interop.lanes_to_numpy(jrep.final)) is None
    for f in jrep.verdict._fields:
        assert np.asarray(getattr(trep.verdict, f)).tolist() == \
            np.asarray(getattr(jrep.verdict, f)).tolist(), f
    assert [trep.lane_log(i) for i in range(8)] == [jrep.lane_log(i) for i in range(8)]
    # the member round launches no kernel in either package
    assert all(sum(n.values()) == 0 for n in mesh.launches)


# ---------------- the envelope cache and failures ----------------


def test_envelope_cache_keys_on_the_mesh():
    """A tiled runner has a cache entry of its own (the mesh in its key,
    as JAX's), meshes of one layout share it and it dispatches on its
    latest caller's mesh (the per-rank counts land there), a (2, 4) mesh
    keys apart from an 8-rank one, and a warm tiled dispatch builds
    nothing."""
    cfg = trun._audit_cfg()
    wl = trun.simm.default_workload(cfg)
    tenv.clear_cache()
    before = tenv.cache_misses()
    m8 = pmesh.make_instance_mesh(8, device="cpu")
    plain = tenv.runner_for(cfg, wl, device="cpu")
    tiled = tenv.runner_for(cfg, wl, mesh=m8, device="cpu")
    assert tiled is not plain and tiled.mesh is m8 and plain.mesh is None
    m8b = pmesh.make_instance_mesh(8, device="cpu")
    assert tenv.runner_for(cfg, wl, mesh=m8b, device="cpu") is tiled and tiled.mesh is m8b
    m24 = pmesh.make_instance_mesh(8, dcn_hosts=2, device="cpu")
    assert tenv.runner_for(cfg, wl, mesh=m24, device="cpu") is not tiled
    assert tenv.cache_misses() - before == 3
    key = tenv.envelope_key(cfg, wl, None, trun.MAX_EPISODES, tenv.MAX_DELAY_BOUND,
                            "cpu", mesh=m8)
    assert key[-2] == ((8,), ("i",), ("cpu",) * 8) and key[-1] == "cpu"
    mt = tenv.member_runner_for(3, 8, mesh=m8, device="cpu")
    assert mt is not tenv.member_runner_for(3, 8, device="cpu") and mt.mesh is m8
    warm = tenv.cache_misses()
    scheds = trun._audit_scheds(8)
    rep = tiled.run(list(range(8)), scheds, workloads=[(wl, None)] * 8, knobs=[cfg.faults] * 8)
    assert tenv.cache_misses() == warm and rep.n_lanes == 8
    assert len(m8b.launches) == 8 and m8.launches == []
    tenv.clear_cache()


def test_a_failing_rank_raises_through_rank_error():
    """No tiled path falls back: a rank whose round raises fails the
    dispatch as ``RankError`` naming the rank."""
    cfg = trun._audit_cfg()
    runner = trun.FleetRunner(cfg, trun.simm.default_workload(cfg), max_episodes=2,
                              mesh=pmesh.make_instance_mesh(4, device="cpu"), device="cpu")
    lanes = runner._rounds["cpu"].lanes

    def flaky(*a, **k):
        if pmesh.current_rank() == 2:
            raise RuntimeError("kernel launch failed")
        return lanes(*a, **k)

    runner._rounds["cpu"].lanes = flaky
    try:
        with pytest.raises(pmesh.RankError, match="rank 2 of 4 raised RuntimeError"):
            runner.run(list(range(8)), trun._audit_scheds(8))
    finally:
        runner._rounds["cpu"].lanes = lanes


def test_lane_blocks_split_in_rank_order():
    mesh = pmesh.make_instance_mesh(4, device="cpu")
    assert pmesh.lane_blocks(mesh, 8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="^6 lanes do not tile over 4 devices$"):
        pmesh.lane_blocks(mesh, 6)
    pmesh.check_lanes(None, 7)
    tree = (np.arange(8), None, (np.arange(16).reshape(8, 2),))
    parts = [pmesh.split_lanes(mesh, "fleet", tree, r) for r in range(4)]
    assert parts[1][0].tolist() == [2, 3] and parts[1][1] is None
    back = pmesh.gather_lanes(mesh, "fleet", parts)
    assert back[0].tolist() == list(range(8)) and (back[2][0] == tree[2][0]).all()


def test_tiled_lane_logs_equal_the_decision_log_helper():
    """``parity_record``'s lane logs are the decision log of each lane's
    own result (``lane_result``) on the tile."""
    cfg = trun._audit_cfg()
    runner = trun.FleetRunner(cfg, trun.simm.default_workload(cfg), max_episodes=2,
                              mesh=pmesh.make_instance_mesh(2, device="cpu"), device="cpu")
    rep = runner.run(list(range(2)), trun._audit_scheds(2))
    rec = trun.parity_record(rep, trun._sim_nibble, runner.vid_bound, cfg.n_instances)
    for i in range(2):
        r = rep.lane_result(i)
        assert rec["lane_logs"][i] == sha256(decision_log(
            r.chosen_vid, r.chosen_ballot, runner.vid_bound, cfg.n_instances))
