"""The port's runtime schedule tables (tpu_paxos_torch/fleet/schedule_table.py):
the table-encoded masks equal the port's compile_schedule rows for every
episode kind and edge case, the rejections are the same, and the masks
equal JAX's ``masks_at``/``crashes_at`` on the same schedules, one lane
or a lane-stacked batch."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_paxos.core import faults as jflt
from tpu_paxos.fleet import schedule_table as jstm
from tpu_paxos.harness import stress as jstress
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.fleet import schedule_table as tstm
from tpu_paxos_torch.harness import stress as tstress


def _port(sched):
    """The JAX schedule as the port's (through the artifact dict)."""
    return None if sched is None else tflt.FaultSchedule.from_dict(sched.to_dict())


def _assert_masks_match(sched, n_nodes, pad=None, extra_rounds=4):
    comp = tflt.compile_schedule(sched, n_nodes)
    tab = tstm.encode_schedule(sched, n_nodes, max_episodes=pad)
    horizon = comp.horizon if comp is not None else 0
    assert int(tab.horizon) == horizon
    for t in range(horizon + extra_rounds):
        reach, paused, extra, gray = tstm.masks_at(tab, t)
        crash = tstm.crashes_at(tab, t)
        if comp is None:
            assert reach.all() and not paused.any() and int(extra) == 0
            assert not gray.any() and not crash.any()
            continue
        tt = min(t, horizon)
        assert (reach == comp.reach[tt]).all(), f"reach @ t={t}"
        assert (paused == comp.paused[tt]).all(), f"paused @ t={t}"
        assert int(extra) == int(comp.extra_drop[tt]), f"extra @ t={t}"
        assert (gray == comp.gray[tt]).all(), f"gray @ t={t}"
        assert (crash == comp.crashed[tt]).all(), f"crash @ t={t}"


@pytest.mark.parametrize(
    "name", ["SCHED_PARTITION_FLAP", "SCHED_ONE_WAY", "SCHED_PAUSE_HEAVY", "SCHED_PAUSE_CRASH"],
)
def test_stress_mix_schedules_match_compiled_tables(name):
    sched = getattr(tstress, name)
    assert sched == _port(getattr(jstress, name))
    _assert_masks_match(sched, 5)


def test_every_kind_with_padding():
    sched = tflt.FaultSchedule((
        tflt.partition(2, 9, (0, 1), (2,)),
        tflt.one_way(3, 12, (0, 4), (1,)),
        tflt.pause(1, 7, 3),
        tflt.burst(4, 10, 2500),
        tflt.gray(3, 11, 2, delay=2),
        tflt.crash(5, 1),
    ))
    _assert_masks_match(sched, 5)
    # a larger capacity pads with never-active slots: masks unchanged
    _assert_masks_match(sched, 5, pad=8)


def test_overlapping_gray_inflations_add():
    sched = tflt.FaultSchedule((
        tflt.gray(0, 10, 1, delay=2),
        tflt.gray(5, 15, 1, 2, delay=3),
    ))
    _assert_masks_match(sched, 3)
    _, _, _, gray = tstm.masks_at(tstm.encode_schedule(sched, 3), 7)
    assert gray.tolist() == [0, 5, 3]


def test_empty_schedule_is_all_clear():
    _assert_masks_match(None, 5)
    _assert_masks_match(tflt.FaultSchedule(()), 3)
    tab = tstm.encode_schedule(None, 3)
    assert int(tab.horizon) == 0
    assert tab.t0.shape == (1,)  # capacity at least 1 so batches stack


def test_touching_intervals():
    """[0,5) then [5,10): round 5 reads the first healed and the second
    active."""
    sched = tflt.FaultSchedule((
        tflt.partition(0, 5, (0,), (1, 2)),
        tflt.partition(5, 10, (0, 1), (2,)),
    ))
    _assert_masks_match(sched, 3)
    reach, _, _, _ = tstm.masks_at(tstm.encode_schedule(sched, 3), 5)
    assert reach[0, 1] and reach[1, 0]
    assert not reach[0, 2] and not reach[1, 2]


def test_full_mesh_partition():
    sched = tflt.FaultSchedule((
        tflt.partition(0, 6, (0,), (1,), (2,), (3,), (4,)),
    ))
    _assert_masks_match(sched, 5)
    reach, _, _, _ = tstm.masks_at(tstm.encode_schedule(sched, 5), 3)
    assert (reach == np.eye(5, dtype=bool)).all()


def test_overlapping_bursts_add_and_clamp():
    sched = tflt.FaultSchedule((tflt.burst(0, 10, 6000), tflt.burst(5, 15, 6000)))
    _assert_masks_match(sched, 3)
    _, _, extra, _ = tstm.masks_at(tstm.encode_schedule(sched, 3), 7)
    assert int(extra) == 10_000


def test_one_way_self_edge_never_cut():
    sched = tflt.FaultSchedule((tflt.one_way(0, 5, (0, 1), (0, 2)),))
    _assert_masks_match(sched, 3)
    reach, _, _, _ = tstm.masks_at(tstm.encode_schedule(sched, 3), 2)
    assert reach.diagonal().all()


def test_encode_batch_stacks_independent_lanes():
    scheds = [
        tflt.FaultSchedule((tflt.pause(2, 8, 1),)),
        None,
        tflt.FaultSchedule((tflt.partition(1, 4, (0,), (1, 2)), tflt.burst(2, 6, 1000))),
    ]
    tabs = tstm.encode_batch(scheds, 3)
    assert tabs.t0.shape == (3, 2)  # capacity = most episodes over lanes
    assert tabs.horizon.tolist() == [8, 0, 6]
    for t in range(10):
        lanes = tstm.masks_at(tabs, t)
        for i, s in enumerate(scheds):
            one = tstm.masks_at(tstm.encode_schedule(s, 3, max_episodes=2), t)
            for got, want in zip(lanes, one):
                assert (got[i] == want).all()


def test_capacity_overflow_rejected():
    sched = tflt.FaultSchedule((tflt.pause(0, 4, 1), tflt.pause(2, 6, 0)))
    with pytest.raises(ValueError, match="capacity"):
        tstm.encode_schedule(sched, 3, max_episodes=1)
    with pytest.raises(ValueError, match="at least one lane"):
        tstm.encode_batch([], 3)


def test_node_range_and_degenerate_partition_rejected_like_jax():
    for make in (lambda f: f.pause(0, 4, 7), lambda f: f.partition(0, 4, (0, 1, 2))):
        with pytest.raises(ValueError) as je:
            jstm.encode_schedule(jflt.FaultSchedule((make(jflt),)), 3)
        with pytest.raises(ValueError) as te:
            tstm.encode_schedule(tflt.FaultSchedule((make(tflt),)), 3)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_equal_jax_masks_at_on_sampled_schedules(seed):
    """Sampled schedules of every kind, gray included, one lane and the
    lane-stacked batch: the port's rows equal JAX's ``masks_at`` and
    ``crashes_at`` at every round to past the horizon."""
    from tpu_paxos.fleet import search as jsearch

    rng = np.random.default_rng(seed)
    scheds = [jsearch.sample_schedule(rng, 5, 4, 48, kinds=jsearch.KINDS_GRAY) for _ in range(6)]
    scheds.append(None)
    jtab = jstm.encode_batch(scheds, 5, 8)
    ttab = tstm.encode_batch([_port(s) for s in scheds], 5, 8)
    for f in jstm.ScheduleTable._fields:
        np.testing.assert_array_equal(getattr(ttab, f), getattr(jtab, f), err_msg=f)
    for t in range(0, 56, 3):
        got = (*tstm.masks_at(ttab, t), tstm.crashes_at(ttab, t))
        for i in range(len(scheds)):
            one = jstm.ScheduleTable(*(jnp.asarray(getattr(jtab, f)[i]) for f in jstm.ScheduleTable._fields))
            want = (*jstm.masks_at(one, t), jstm.crashes_at(one, t))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[i], np.asarray(w))


@pytest.mark.parametrize("gray", [False, True])
def test_samplers_and_workload_equal_jax(gray):
    """The port's search grammar draws the JAX package's schedules and
    edge matrices from the same generator state, and the stress workload
    is the same."""
    from tpu_paxos.fleet import search as jsearch
    from tpu_paxos_torch.fleet import search as tsearch

    ja = jsearch.Alphabet.classic(gray=gray, wan=True)
    ta = tsearch.Alphabet.classic(gray=gray, wan=True)
    assert ta.kinds == ja.kinds and ta.protocol().__dict__ == ja.protocol().__dict__
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(24):
        assert ta.sample(tr, 5) == _port(ja.sample(jr, 5))
        je, te = jsearch.sample_edge_knobs(jr, 5, 8), tsearch.sample_edge_knobs(tr, 5, 8)
        assert te.edges.to_dict() == je.edges.to_dict() and te.max_delay == je.max_delay
    for a, b in zip(jstress._workload(2, np.random.default_rng(0)),
                    tstress._workload(2, np.random.default_rng(0))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
