"""The port's breach attribution (tpu_paxos_torch/telemetry/diagnose.py)
against the JAX package's: every crafted per-cause fixture of
tests/test_diagnose.py (true and false positives, the ambiguous
gray+saturation window, the reducers and report plumbing) goes through
both modules and gives the same report, byte for byte as sorted JSON,
with equal ``fingerprint``s; and a seeded gray-region run on the port's
armed engine gives JAX's diagnosis of JAX's run."""

import json

import numpy as np
import pytest

from tpu_paxos.telemetry import diagnose as jdiag
from tpu_paxos.telemetry import recorder as jrec
from tpu_paxos_torch.telemetry import diagnose as tdiag
from tpu_paxos_torch.telemetry import recorder as trec

W = trec.NUM_WINDOWS
B = trec.NUM_LAT_BUCKETS
A = 3
NAMES = ("us", "eu", "ap")


def _mk_dict(**over):
    """A quiet, healthy windowed dict (4 active windows of modest
    traffic) the fixtures perturb per cause."""
    d = {
        "window_rounds": 16,
        "n_windows": W,
        "decided": [8] * 4 + [0] * (W - 4),
        "offered": [100] * 4 + [0] * (W - 4),
        "dropped": [1] * 4 + [0] * (W - 4),
        "drop_rate_observed": [100.0] * 4 + [0.0] * (W - 4),
        "stall_max": [0] * W,
        "takeovers": [0] * W,
        "restarts": [0] * W,
        "cut": [0] * W,
        "backlog_max": [1] * 4 + [0] * (W - 4),
        "node_offered": [[30] * A] * 4 + [[0] * A] * (W - 4),
        "node_delay": [[15] * A] * 4 + [[0] * A] * (W - 4),
        "latency_p50": [2] * 4 + [-1] * (W - 4),
        "lat_hist": np.zeros((W, B), np.int64).tolist(),
    }
    ph = np.zeros((W, trec.NUM_PHASES, B), np.int64)
    ph[:4, trec.PHASE_CONSENSUS, 1] = 8
    d["phase_hist"] = ph.tolist()
    d.update(over)
    return d


def _set_phase(d, w, phase, bucket, n):
    ph = np.asarray(d["phase_hist"])
    ph[w, phase, bucket] = n
    d["phase_hist"] = ph.tolist()
    return d


def _saturated():
    d = _mk_dict()
    d["backlog_max"][2] = 20
    return _set_phase(d, 2, trec.PHASE_QUEUE, 6, 8)


def _gray(delay2=90, delay0=None):
    d = _mk_dict()
    nd = np.asarray(d["node_delay"])
    nd[2, 2] = delay2
    if delay0 is not None:
        nd[2, 0] = delay0
    d["node_delay"] = nd.tolist()
    return d


def _pairs():
    return {
        "n_regions": 3, "offered": [[10] * 3] * 3, "dropped": [[0] * 3] * 3,
        "drop_rate_observed": [[0.0] * 3] * 3,
        "cut": [[0, 0, 9], [0, 0, 3], [0, 0, 0]], "names": list(NAMES),
    }


def _cut():
    d = _mk_dict()
    d["cut"][1] = 12
    d["stall_max"][1] = 3
    return d


def _duel(restarts=3):
    d = _mk_dict()
    d["takeovers"][3] = 2
    d["restarts"][3] = restarts
    return _set_phase(d, 3, trec.PHASE_CONSENSUS, 7, 30)


def _both():
    d = _saturated()
    nd = np.asarray(d["node_delay"])
    nd[2, 2] = 90
    d["node_delay"] = nd.tolist()
    return d


def _gray_cut():
    d = _gray()
    d["cut"][2] = 5
    return d


def _gray_drop():
    d = _gray()
    d["drop_rate_observed"][2] = 2000.0
    return d


CASES = {
    "saturation_tp": lambda m: m.diagnose_window(_saturated(), 2),
    "saturation_tn_flat_backlog": lambda m: m.diagnose_window(
        _set_phase(_mk_dict(), 2, trec.PHASE_QUEUE, 6, 8), 2),
    "saturation_tn_consensus": lambda m: m.diagnose_window(
        _set_phase(dict(_mk_dict(), backlog_max=[1, 1, 20, 1] + [0] * (W - 4)), 2,
                   trec.PHASE_CONSENSUS, 7, 20), 2),
    "gray_tp_regions": lambda m: m.diagnose_window(_gray(), 2, region_map=[0, 1, 2],
                                                   region_names=NAMES),
    "gray_tp_nodes": lambda m: m.diagnose_window(_gray(), 2),
    "gray_tn_cut": lambda m: m.diagnose_window(_gray_cut(), 2),
    "gray_tn_drop": lambda m: m.diagnose_window(_gray_drop(), 2),
    "gray_coinflated_neighbor": lambda m: m.diagnose_window(_gray(90, 36), 2),
    "partition_tp": lambda m: m.diagnose_window(_cut(), 1, region_pairs=_pairs(),
                                                region_names=NAMES),
    "partition_tn": lambda m: m.diagnose_window(_mk_dict(), 1),
    "duel_tp": lambda m: m.diagnose_window(_duel(), 3),
    "duel_tn": lambda m: m.diagnose_window(
        dict(_mk_dict(), restarts=[0, 0, 0, 1] + [0] * (W - 4)), 3),
    "ambiguous_ranked": lambda m: m.diagnose_window(_both(), 2),
    "breaches": lambda m: m.diagnose_breaches(_saturated(), [2, 3]),
    "attach": lambda m: m.attach_diagnosis(
        {"breach_windows": [2], "regions": {"ap": {"breach_windows": [3]}}}, _saturated()),
    "attach_empty": lambda m: m.attach_diagnosis({"breach_windows": []}, _saturated()),
    "label_windows": lambda m: m.label_windows(_cut()),
    "series": lambda m: m.diagnose_series(_cut()),
    "series_regions": lambda m: m.diagnose_series(
        _both(), region_map=[0, 1, 2], region_names=NAMES, region_pairs=_pairs()),
    "cause_codes": lambda m: [m.cause_code(c) for c in list(m.CAUSES) + ["unknown"]],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnosis_equals_jax(case):
    want, got = CASES[case](jdiag), CASES[case](tdiag)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if isinstance(want, dict):
        assert tdiag.fingerprint(got) == jdiag.fingerprint(want)


def test_fingerprint_is_deterministic_bytes():
    a = tdiag.diagnose_breaches(_saturated(), [2])
    b = tdiag.diagnose_breaches(json.loads(json.dumps(_saturated())), [2])
    assert tdiag.fingerprint(a) == tdiag.fingerprint(b) == jdiag.fingerprint(
        jdiag.diagnose_breaches(_saturated(), [2]))


def test_seeded_gray_region_recall_equals_jax():
    """tests/test_diagnose.py's wan-3region run graying the lone 'ap'
    node: the port's armed run classifies ``gray-region`` naming ap, and
    its diagnosis equals JAX's, fingerprint for fingerprint."""
    from tpu_paxos.config import SimConfig as JSC
    from tpu_paxos.core import faults as jflt
    from tpu_paxos.core import sim as jsim
    from tpu_paxos.core import wan as jwan
    from tpu_paxos_torch.config import SimConfig as TSC
    from tpu_paxos_torch.core import faults as tflt
    from tpu_paxos_torch.core import sim as tsim
    from tpu_paxos_torch.core import wan as twan

    def diagnose(C, flt, wanm, sim, rec, diag, **kw):
        preset = wanm.WAN3
        sched = flt.FaultSchedule((flt.gray(32, 96, 2, delay=4),))
        cfg = C(n_nodes=3, n_instances=24, proposers=(0, 1), seed=0, max_rounds=256,
                faults=wanm.wan_fault_config(preset, 3, schedule=sched))
        rmap = wanm.node_regions(preset, 3)
        _, summ, wsum = sim.run_with_telemetry(cfg, region_map=rmap, **kw)
        sd = rec.summary_to_dict(summ, wsum, rec.WINDOW_ROUNDS, region_names=preset.regions)
        return diag.diagnose_series(sd["windows"], region_map=rmap, region_names=preset.regions,
                                    region_pairs=sd["region_pairs"])

    want = diagnose(JSC, jflt, jwan, jsim, jrec, jdiag)
    got = diagnose(TSC, tflt, twan, tsim, trec, tdiag, device="cpu")
    assert "gray-region" in got["causes"]
    gray = [v for v in got["windows"] if v["cause"] == "gray-region"]
    assert gray[0]["candidates"][0]["evidence"]["regions"] == ["ap"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert tdiag.fingerprint(got) == jdiag.fingerprint(want)
